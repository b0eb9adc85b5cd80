// Forward flash attention for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py: GQA attention with an online
// softmax, causal and/or sliding-window masks on absolute positions that
// both count from 0, padded KV columns masked by `kpos < Sk`, and the final
// division clamping the row sum at 1e-30.
//
// Design. One thread block of four warps owns one (batch, q head, 64-row
// q tile); each warp owns 16 of those rows. The Q fragments, the running
// max m, the running sum l and the output accumulator stay in registers
// for the whole KV loop, so a block reads its Q tile once, each reachable
// K/V tile once (K and V, 8 MB at the prefill shape, fit the 50 MB L2 that
// serves the other q tiles' re-reads) and writes its O tile once. The KV
// loop is bounded by causality and the window instead of testing every
// tile. Both products are `mma.sync.m16n8k16` bf16 -> fp32 tensor-core
// instructions; P is rounded to bf16 for the second one, as
// FlashAttention-2 does. Q, K and V reach the kernel in the model layout
// [B, S, H, D] through strides, so the caller transposes nothing; the kv
// head is q_head / (Hq / Hkv).
//
// What bounds it. At the prefill shape (B = 8, S = 1024, Hq = 16, Hkv = 2,
// D = 128, causal) the work is 4 * D FLOPs per unmasked (q, k) pair,
// 34.4 GFLOP against 75.5 MB of compulsory traffic: ~455 FLOPs per byte,
// above the H100's ~295 bf16 FLOPs per byte, so the card's bound is the
// tensor cores (~35 us at 989 TFLOP/s). This first version cannot reach
// it: `mma.sync` runs at a fraction of the `wgmma` rate, and the tile
// loads are synchronous, so every warp waits on device memory once per
// tile. A block holds 17 KB of K and 18 KB of V in shared memory and
// 128 threads of ~180 registers, so two blocks share an SM and hide part
// of that wait. TMA loads into a ring of tiles, `wgmma` and a producer
// warp are the later redesign.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of m16n8k16 (lane = 4 * g + t):
//   A (16x16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//              a3 = (g+8, 2t+8..)
//   B (16x8):  b0 = (k = 2t..2t+1, n = g), b1 = (k = 2t+8.., n = g)
//   C (16x8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Sq,
                 int Sk, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 float scale_log2, int causal, int window) {
  // Padded rows keep the fragment reads free of bank conflicts.
  constexpr int kStrideK = D + 8;        // K tile, [key][d]
  constexpr int kStrideV = kBlockK + 8;  // V tile transposed, [d][key]
  __shared__ __align__(16) __nv_bfloat16 k_tile[kBlockK * kStrideK];
  __shared__ __align__(16) __nv_bfloat16 vt_tile[D * kStrideV];

  // Causal tiles near the end of the sequence do the most work: start them
  // first so the short ones fill the tail of the grid.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_lo = q_tile * kBlockQ;
  const int row0 = q_lo + warp * 16 + g;  // this thread's rows: row0, row0+8

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + (i & 1) * 8;
      const int c = kk * 16 + (i >> 1) * 8 + 2 * t;
      qf[kk][i] = r < Sq ? load_u32(qb + r * q_ss + c) : 0u;
    }
  }

  int kt_end = (Sk + kBlockK - 1) / kBlockK;
  if (causal) kt_end = min(kt_end, (q_lo + kBlockQ - 1) / kBlockK + 1);
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0)
    kt_begin = (q_lo - window + 1) / kBlockK;

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share; summed over the quad last
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    // Neighbouring lanes take neighbouring keys, so both the K stores and
    // the transposed V stores hit distinct shared-memory banks.
    for (int i = threadIdx.x; i < kBlockK * (D / 8); i += kThreads) {
      const int r = i % kBlockK;
      const int c = (i / kBlockK) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (k_lo + r < Sk) {  // rows past Sk are zeros, never garbage
        kv = *reinterpret_cast<const uint4*>(kb + (k_lo + r) * k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k_lo + r) * v_ss + c);
      }
      *reinterpret_cast<uint4*>(&k_tile[r * kStrideK + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_tile[(c + j) * kStrideV + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = &k_tile[(n * 8 + g) * kStrideK + kk * 16 + 2 * t];
        const uint32_t bf[2] = {load_u32(kp), load_u32(kp + 8)};
        mma_16816(s[n], qf[kk], bf);
      }
    }

    // Mask, then scale into the log2 domain (exp2 is one instruction).
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + (e >> 1) * 8;
        const int c = k_lo + n * 8 + 2 * t + (e & 1);
        bool ok = c < Sk;
        if (causal) ok = ok && r >= c;
        if (window > 0) ok = ok && c > r - window;
        s[n][e] = ok ? s[n][e] * scale_log2 : kNegInf;
      }
    }

    // Online softmax; each row lives in the four threads of a quad.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * rr], s[n][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2f(m[rr] - mx);
      m[rr] = mx;
      l[rr] *= corr;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][2 * rr] *= corr;
        acc[dn][2 * rr + 1] *= corr;
      }
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2f(s[n][2 * rr + j] - mx);
          s[n][2 * rr + j] = p;
          l[rr] += p;
        }
      }
    }

    // O += P V: the C fragments of S are the A fragments of P.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* vp = &vt_tile[(dn * 8 + g) * kStrideV + kk * 16 + 2 * t];
        const uint32_t bf[2] = {load_u32(vp), load_u32(vp + 8)};
        mma_16816(acc[dn], pa, bf);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + rr * 8;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    __nv_bfloat16* op = o + b * o_sb + r * o_ss + h * o_sh;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(op + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][2 * rr] * inv, acc[dn][2 * rr + 1] * inv);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int Hq, int Hkv, int Sq, int Sk, const long long* qs,
            const long long* ks, const long long* vs, const long long* os,
            int causal, int window, cudaStream_t stream) {
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * Hq);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Hq, Hkv, Sq, Sk, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], os[0], os[1], os[2], scale_log2, causal, window);
}

}  // namespace

// q: [B, Sq, Hq, D], k/v: [B, Sk, Hkv, D], o: [B, Sq, Hq, D], all bf16 with
// a unit stride on D. Each *_strides array holds the (batch, seq, head)
// strides in elements. Returns a cudaError_t.
extern "C" int repro_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, q_strides, k_strides,
               v_strides, o_strides, causal, window, s);
  } else if (D == 128) {
    launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, q_strides, k_strides,
                v_strides, o_strides, causal, window, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
