// Backward flash attention for Hopper (sm_90a): bf16 operands and
// gradients, fp32 accumulate, `mma.sync` tensor cores, `cp.async`
// double-buffered tiles.
//
// Replaces `jax.grad` of the pure-jnp `chunked_attention`
// (src/repro/models/attention.py:51), which is what the JAX training path
// differentiates; no Pallas backward exists. Given q, k, v, the forward's
// row log-sum-exp (csrc/flash_attention.cu with a non-null `lse`) and dO,
// it returns dQ, dK and dV under the forward's conventions: GQA with the
// kv head of q head h at h / (Hq / Hkv), so dK and dV sum over the group's
// q heads; causal and sliding-window masks on absolute positions that both
// count from 0; ragged S; D in {64, 128}; the model layout [B, S, H, D]
// with the caller's (batch, seq, head) strides.
//
// Two kernels, in FlashAttention-2's order, with no atomics, so results
// are deterministic:
//   1. dQ and delta: one block per (b, q head, 64-row q tile), 4 warps of
//      16 rows, looping twice over the key tiles the rows can see. The
//      first pass recomputes S = Q K^T, P and dP = dO V^T and sums
//      delta_i = sum_j P_ij dP_ij in fp32, written as [B, Hq, Sq] for the
//      second kernel; the second pass recomputes them again for dS = P o
//      (dP - delta) and dQ += scale * dS K. FlashAttention-2 takes delta
//      as rowsum(dO o O) instead, from the forward's output, which costs no
//      pass but carries the forward's rounding of P to bf16 before P V:
//      on the rows whose dQ cancels to a small vector (row 1 of a causal
//      head, with two keys) that rounding moved dQ by 4.8% of its norm
//      with the fp32 output and by 19% with the bf16 one, as SDPA's
//      backward errs (chip_smoke.py, H100). The first pass costs 4 * D
//      FLOPs per pair more.
//   2. dK/dV: one block per (b, kv head, 64-key tile), 8 warps. It loops
//      over the group's Hq / Hkv q heads and, for each, over the 64-row q
//      tiles that can see its keys (for a causal mask, those at or after
//      the key tile; a window also bounds them from above). Per tile it
//      recomputes S^T = K Q^T, P^T = exp2(S^T * scale_log2 - LSE * log2 e),
//      then dV += P^T dO, dP^T = V dO^T, dS^T = P^T o (dP^T - delta) and
//      dK += scale * dS^T Q. Warp w owns keys 16 (w % 4) .. + 15 and q
//      columns 32 (w / 4) .. + 31 of the tile, so each key's dK/dV is
//      summed in two warps and the halves are added through shared memory
//      at the end.
// P and dS are rounded to bf16 as A operands of the next product (P and dS
// stay fp32 for dS = P (dP - delta)); dK, dV, dQ are rounded to bf16 once.
// Masks: only tiles that touch the diagonal, a window edge, Sq or Sk
// compute one (`tile_needs_mask`), and there rows past Sq and keys past Sk
// get P = 0 by a select, never by arithmetic on the LSE or scores of the
// zero-filled rows (0 * inf would give NaN).
//
// What bounds it. The work is 10 * D FLOPs per unmasked (q, k) pair (S
// recomputed, dV, dP, dK, dQ), 2.5x the forward's 4 * D; at the training
// shape (B = 2, S = 2048, Hq = 16, Hkv = 2, D = 128, causal) that is 86
// GFLOP against ~59 MB of compulsory traffic (q, k, v, dO, dq, dk, dv in
// bf16, the LSE), ~1450 FLOPs per byte: the tensor cores bound it (~87 us
// at 989 TFLOP/s). This version does 18 * D per pair (S and dP are computed
// in both passes of the dQ kernel and in the dK/dV kernel) on `mma.sync`,
// which reaches only a part of the `wgmma` rate; the Hopper redesign
// (TMA, `wgmma`, one pass with dQ reduced across blocks) is ROADMAP A.3.
//
// Tiles and resources (ptxas's report is printed by chip_smoke.py's
// [build] lines): 64 x 64 tiles of q rows and keys; shared-memory rows
// padded by 16 bytes so `ldmatrix` is free of bank conflicts. dK/dV: 256
// threads, K and V tiles plus a double buffer of Q and dO tiles and their
// LSE and delta, 105,472 bytes at D = 128 (56,320 at D = 64), one block
// per SM; each thread holds 64 + 64 fp32 dK/dV accumulators at D = 128.
// dQ: 128 threads, the Q and dO tiles plus a double buffer of K and V
// tiles, 104,448 bytes at D = 128 (55,296 at D = 64), two blocks per SM.
//
// The C entry point launches the two kernels on the caller's stream,
// allocates nothing (delta is scratch the caller provides) and returns a
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // q rows and keys per tile
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// one 16-byte row. Without .trans lane l receives row l / 4, columns
// 2 (l % 4) + {0, 1} of each matrix; with .trans the same of its transpose.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, fp32 accumulators.
// Lane 4 g + t holds A rows g and g + 8 at columns 2 t.. and 2 t + 8..
// (a[0..3] = (g, lo), (g + 8, lo), (g, hi), (g + 8, hi)), B column g at rows
// 2 t.. (b0) and 2 t + 8.. (b1), and D rows g (d[0..1]) and g + 8 (d[2..3])
// at columns 2 t, 2 t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulators of two adjacent 8-column tiles as the A fragment of
// the 16 columns they cover.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Shared-memory tiles are [kTile][D + 8] bf16: the 16-byte pad puts the
// eight rows of an ldmatrix on eight different bank groups.
template <int D>
__device__ __forceinline__ uint32_t tile_addr(uint32_t tile, int row, int col) {
  return tile + (row * (D + 8) + col) * 2;
}

// A fragment (rows row0.., columns col0..) of a [row][col] tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile, int row0, int col0,
                                       int lane) {
  ldsm_x4(a, tile_addr<D>(tile, row0 + (lane & 15), col0 + (lane >> 4) * 8));
}
// B fragments of two 8-column tiles n0.., n0 + 8.. over k0.. + 15 from a
// tile stored [n][k] (B = stored^T): b[0..1] for n0, b[2..3] for n0 + 8.
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], uint32_t tile, int n0, int k0,
                                          int lane) {
  ldsm_x4(b, tile_addr<D>(tile, n0 + (lane & 7) + (lane >> 4) * 8, k0 + ((lane >> 3) & 1) * 8));
}
// The same from a tile stored [k][n] (B = stored).
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], uint32_t tile, int k0, int n0,
                                          int lane) {
  ldsm_x4_t(b, tile_addr<D>(tile, k0 + (lane & 7) + ((lane >> 3) & 1) * 8, n0 + (lane >> 4) * 8));
}

// Rows [row0, row0 + kTile) of one head of a [B, S, H, D] tensor (`base`
// at its (b, 0, h)) into a shared tile; rows at or past `rows` are zeros.
template <int D, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* base,
                                          long long row_stride, int row0, int rows,
                                          int tid) {
  constexpr int kChunks = kTile * D / 8;  // 16-byte chunks
#pragma unroll
  for (int c = tid; c < kChunks; c += kThreads) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const bool valid = row0 + r < rows;
    const __nv_bfloat16* src = base + (valid ? row0 + r : 0) * row_stride + col;
    cp_async16(tile_addr<D>(tile, r, col), src, valid);
  }
}

// Whether a (q tile, key tile) pair has a pair to mask: a key after a row
// (causal), a key at or before a row minus the window, a row past Sq or a
// key past Sk.
__device__ __forceinline__ bool tile_needs_mask(int q_lo, int k_lo, int Sq, int Sk,
                                                int causal, int window) {
  bool masked = q_lo + kTile > Sq || k_lo + kTile > Sk;
  masked |= causal && k_lo + kTile - 1 > q_lo;
  masked |= window > 0 && k_lo <= q_lo + kTile - 1 - window;
  return masked;
}

__device__ __forceinline__ bool visible(int r, int c, int Sq, int Sk, int causal,
                                        int window) {
  bool ok = r < Sq && c < Sk;
  if (causal) ok = ok && r >= c;
  if (window > 0) ok = ok && c > r - window;
  return ok;
}

// ---- 1. dQ and delta ------------------------------------------------------
template <int D>
constexpr int dq_smem_bytes() {
  return 6 * kTile * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, Strides qs, Strides ks, Strides vs,
                    Strides dos, Strides dqs, int Hq, int Hkv, int Sq, int Sk, float scale,
                    int causal, int window) {
  constexpr int kThreads = 128;
  constexpr int kTileBytes = kTile * (D + 8) * 2;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sDO = sQ + kTileBytes;
  const uint32_t sK = sDO + kTileBytes;      // + buf * kTileBytes
  const uint32_t sV = sK + 2 * kTileBytes;   // + buf * kTileBytes

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;  // q rows 16 warp .. + 15 of the tile
  const int g = lane >> 2;
  const int t = lane & 3;
  // causal tiles near the end of the sequence do the most work: start them first
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const float scale_log2 = scale * kLog2e;

  int kt_end = (Sk + kTile - 1) / kTile;
  if (causal) kt_end = min(kt_end, (q_lo + kTile - 1) / kTile + 1);
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / kTile;
  const int n_it = max(kt_end - kt_begin, 0);

  // this thread's rows: r0 = q_lo + 16 warp + g and r0 + 8; delta is
  // this thread's share of sum_j P dP until the first pass ends
  const long long row_at = (static_cast<long long>(b) * Hq + h) * Sq + q_lo + 16 * warp + g;
  float lrow[2], drow[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    lrow[hf] = q_lo + 16 * warp + g + 8 * hf < Sq ? lse[row_at + 8 * hf] * kLog2e : 0.f;

  auto issue = [&](int i, int buf) {
    const int k0 = (kt_begin + i) * kTile;
    load_tile<D, kThreads>(sK + buf * kTileBytes, k + b * ks.b + hk * ks.h, ks.s, k0, Sk, tid);
    load_tile<D, kThreads>(sV + buf * kTileBytes, v + b * vs.b + hk * vs.h, vs.s, k0, Sk, tid);
  };
  load_tile<D, kThreads>(sQ, q + b * qs.b + h * qs.h, qs.s, q_lo, Sq, tid);
  load_tile<D, kThreads>(sDO, dout + b * dos.b + h * dos.h, dos.s, q_lo, Sq, tid);
  if (n_it > 0) issue(0, 0);
  cp_async_commit();

  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  // iterations [0, n_it): the first pass (delta), [n_it, 2 n_it): the second (dQ)
  for (int it = 0; it < 2 * n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < 2 * n_it) issue((it + 1) % n_it, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k_lo = (kt_begin + it % n_it) * kTile;
    const uint32_t k_s = sK + buf * kTileBytes;
    const uint32_t v_s = sV + buf * kTileBytes;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ad[4];
      load_a<D>(aq, sQ, 16 * warp, 16 * kk, lane);
      load_a<D>(ad, sDO, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nk<D>(bk, k_s, 16 * np, 16 * kk, lane);
        mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        load_b_nk<D>(bv, v_s, 16 * np, 16 * kk, lane);
        mma_bf16(dp[2 * np], ad, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ad, bv[2], bv[3]);
      }
    }
    // P = exp2(S * scale_log2 - LSE * log2 e), 0 where masked; then delta
    // += P dP (first pass) or dS = P o (dP - delta) (second)
    const bool masked = tile_needs_mask(q_lo, k_lo, Sq, Sk, causal, window);
    const bool first = it < n_it;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q_lo + 16 * warp + g + 8 * (e >> 1);
        const int c = k_lo + 8 * j + 2 * t + (e & 1);
        float p = exp2f(s[j][e] * scale_log2 - lrow[e >> 1]);
        p = (!masked || visible(r, c, Sq, Sk, causal, window)) ? p : 0.f;
        if (first)
          drow[e >> 1] += p * dp[j][e];
        else
          s[j][e] = p * (dp[j][e] - drow[e >> 1]);
      }
    if (first) {
      if (it == n_it - 1) {
        // the quad's four shares of each row; the dK/dV kernel reads it
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          drow[hf] += __shfl_xor_sync(0xffffffffu, drow[hf], 1);
          drow[hf] += __shfl_xor_sync(0xffffffffu, drow[hf], 2);
          if (t == 0 && q_lo + 16 * warp + g + 8 * hf < Sq) delta[row_at + 8 * hf] = drow[hf];
        }
      }
      __syncthreads();
      continue;
    }
    // dQ += dS K (scaled at the end)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bk[4];
        load_b_kn<D>(bk, k_s, 16 * kk, 16 * dn, lane);
        mma_bf16(dq_acc[2 * dn], sa, bk[0], bk[1]);
        mma_bf16(dq_acc[2 * dn + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q_lo + 16 * warp + g + 8 * hf;
    if (r >= Sq) continue;
    __nv_bfloat16* dqp = dq + b * dqs.b + r * dqs.s + h * dqs.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dqp + 8 * j + 2 * t) =
          pack_bf16(dq_acc[j][2 * hf] * scale, dq_acc[j][2 * hf + 1] * scale);
  }
}

// ---- 2. dK, dV (after the dQ kernel has written delta) --------------------
template <int D>
constexpr int dkdv_smem_bytes() {
  return 6 * kTile * (D + 8) * 2 + 4 * kTile * 4;
}

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                      Strides dos, Strides dks, Strides dvs, int Hq, int Hkv, int Sq, int Sk,
                      float scale, int causal, int window) {
  constexpr int kThreads = 256;
  constexpr int kTileBytes = kTile * (D + 8) * 2;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + kTileBytes;
  const uint32_t sQ = sV + kTileBytes;        // + buf * kTileBytes
  const uint32_t sDO = sQ + 2 * kTileBytes;   // + buf * kTileBytes
  float* sL = reinterpret_cast<float*>(smem + 6 * kTileBytes);  // [2][kTile]: LSE * log2 e
  float* sD = sL + 2 * kTile;                                   // [2][kTile]: delta

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kr = warp % 4;  // keys 16 kr .. + 15 of the tile
  const int qc = warp / 4;  // q columns 32 qc .. + 31 of each q tile
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k_lo = blockIdx.x * kTile;
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int group = Hq / Hkv;  // q heads that share this kv head
  const float scale_log2 = scale * kLog2e;

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int qt_begin = causal ? k_lo / kTile : 0;
  int qt_end = n_qt;
  if (window > 0) qt_end = min(qt_end, (k_lo + kTile - 2 + window) / kTile + 1);
  const int n_q = max(qt_end - qt_begin, 0);
  const int n_it = group * n_q;

  // iteration i: q head hk * group + i / n_q, q tile qt_begin + i % n_q
  auto issue = [&](int i, int buf) {
    const int h = hk * group + i / n_q;
    const int q_lo = (qt_begin + i % n_q) * kTile;
    load_tile<D, kThreads>(sQ + buf * kTileBytes, q + b * qs.b + h * qs.h, qs.s, q_lo, Sq, tid);
    load_tile<D, kThreads>(sDO + buf * kTileBytes, dout + b * dos.b + h * dos.h, dos.s, q_lo, Sq,
                           tid);
  };
  // this thread's share of a q tile's LSE and delta, read ahead into registers
  auto read_rows = [&](int i, float& l, float& d) {
    l = 0.f;
    d = 0.f;
    if (tid < kTile && i < n_it) {
      const int h = hk * group + i / n_q;
      const int r = (qt_begin + i % n_q) * kTile + tid;
      if (r < Sq) {
        const long long at = (static_cast<long long>(b) * Hq + h) * Sq + r;
        l = lse[at] * kLog2e;
        d = delta[at];
      }
    }
  };

  load_tile<D, kThreads>(sK, k + b * ks.b + hk * ks.h, ks.s, k_lo, Sk, tid);
  load_tile<D, kThreads>(sV, v + b * vs.b + hk * vs.h, vs.s, k_lo, Sk, tid);
  if (n_it > 0) issue(0, 0);
  cp_async_commit();
  float nl, nd;
  read_rows(0, nl, nd);
  if (tid < kTile) {
    sL[tid] = nl;
    sD[tid] = nd;
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) issue(it + 1, buf ^ 1);
    cp_async_commit();
    read_rows(it + 1, nl, nd);
    cp_async_wait<1>();
    __syncthreads();

    const int q_lo = (qt_begin + it % n_q) * kTile;
    const uint32_t qt_s = sQ + buf * kTileBytes;
    const uint32_t do_s = sDO + buf * kTileBytes;
    const float* lrow = sL + buf * kTile;
    const float* drow = sD + buf * kTile;

    // S^T = K Q^T: 16 keys x 32 q columns
    float st[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a<D>(a, sK, 16 * kr, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4];
        load_b_nk<D>(bq, qt_s, 32 * qc + 16 * np, 16 * kk, lane);
        mma_bf16(st[2 * np], a, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], a, bq[2], bq[3]);
      }
    }
    // P^T = exp2(S^T * scale_log2 - LSE * log2 e), 0 where masked
    const bool masked = tile_needs_mask(q_lo, k_lo, Sq, Sk, causal, window);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 32 * qc + 8 * j + 2 * t + (e & 1);
        const float p = exp2f(st[j][e] * scale_log2 - lrow[qi]);
        const int c = k_lo + 16 * kr + g + 8 * (e >> 1);
        st[j][e] = (!masked || visible(q_lo + qi, c, Sq, Sk, causal, window)) ? p : 0.f;
      }
    // dV += P^T dO
#pragma unroll
    for (int kq = 0; kq < 2; ++kq) {
      uint32_t pa[4];
      acc_to_a(pa, st[2 * kq], st[2 * kq + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bd[4];
        load_b_kn<D>(bd, do_s, 32 * qc + 16 * kq, 16 * dn, lane);
        mma_bf16(dv_acc[2 * dn], pa, bd[0], bd[1]);
        mma_bf16(dv_acc[2 * dn + 1], pa, bd[2], bd[3]);
      }
    }
    // dP^T = V dO^T
    float dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a<D>(a, sV, 16 * kr, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bd[4];
        load_b_nk<D>(bd, do_s, 32 * qc + 16 * np, 16 * kk, lane);
        mma_bf16(dpt[2 * np], a, bd[0], bd[1]);
        mma_bf16(dpt[2 * np + 1], a, bd[2], bd[3]);
      }
    }
    // dS^T = P^T o (dP^T - delta), in st
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 32 * qc + 8 * j + 2 * t + (e & 1);
        st[j][e] = st[j][e] * (dpt[j][e] - drow[qi]);
      }
    // dK += dS^T Q (scaled at the end)
#pragma unroll
    for (int kq = 0; kq < 2; ++kq) {
      uint32_t sa[4];
      acc_to_a(sa, st[2 * kq], st[2 * kq + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bq[4];
        load_b_kn<D>(bq, qt_s, 32 * qc + 16 * kq, 16 * dn, lane);
        mma_bf16(dk_acc[2 * dn], sa, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * dn + 1], sa, bq[2], bq[3]);
      }
    }
    // the next tile's LSE and delta, into the buffer no warp reads now
    if (tid < kTile) {
      sL[(buf ^ 1) * kTile + tid] = nl;
      sD[(buf ^ 1) * kTile + tid] = nd;
    }
    __syncthreads();
  }

  // The two q-column halves of each key's sums: warps 4-7 hand theirs to
  // warps 0-3 through the (now idle) Q and dO buffers, fp32 [key][D + 4].
  cp_async_wait<0>();
  __syncthreads();
  constexpr int kRed = D + 4;
  float* red_k = reinterpret_cast<float*>(smem + 2 * kTileBytes);
  float* red_v = red_k + kTile * kRed;
  if (qc == 1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int at = (16 * kr + g + 8 * hf) * kRed + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(red_k + at) =
            make_float2(dk_acc[j][2 * hf], dk_acc[j][2 * hf + 1]);
        *reinterpret_cast<float2*>(red_v + at) =
            make_float2(dv_acc[j][2 * hf], dv_acc[j][2 * hf + 1]);
      }
  }
  __syncthreads();
  if (qc == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = k_lo + 16 * kr + g + 8 * hf;
      if (c >= Sk) continue;
      __nv_bfloat16* dkp = dk + b * dks.b + c * dks.s + hk * dks.h;
      __nv_bfloat16* dvp = dv + b * dvs.b + c * dvs.s + hk * dvs.h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int at = (16 * kr + g + 8 * hf) * kRed + 8 * j + 2 * t;
        const float2 rk = *reinterpret_cast<const float2*>(red_k + at);
        const float2 rv = *reinterpret_cast<const float2*>(red_v + at);
        *reinterpret_cast<uint32_t*>(dkp + 8 * j + 2 * t) =
            pack_bf16((dk_acc[j][2 * hf] + rk.x) * scale, (dk_acc[j][2 * hf + 1] + rk.y) * scale);
        *reinterpret_cast<uint32_t*>(dvp + 8 * j + 2 * t) =
            pack_bf16(dv_acc[j][2 * hf] + rv.x, dv_acc[j][2 * hf + 1] + rv.y);
      }
    }
  }
}

Strides strides_of(const long long* s) { return Strides{s[0], s[1], s[2]}; }

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           float* delta, void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
           const long long* qs, const long long* ks, const long long* vs,
           const long long* dos, const long long* dqs, const long long* dks,
           const long long* dvs, int causal, int window, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  constexpr int q_bytes = dq_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 q_grid((Sq + kTile - 1) / kTile, B * Hq);
  flash_bwd_dq_kernel<D><<<q_grid, 128, q_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), strides_of(qs),
      strides_of(ks), strides_of(vs), strides_of(dos), strides_of(dqs), Hq, Hkv, Sq, Sk,
      scale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr int kv_bytes = dkdv_smem_bytes<D>();
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 kv_grid((Sk + kTile - 1) / kTile, B * Hkv);
  flash_bwd_dkdv_kernel<D><<<kv_grid, 256, kv_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), strides_of(qs), strides_of(ks), strides_of(vs),
      strides_of(dos), strides_of(dks), strides_of(dvs), Hq, Hkv, Sq, Sk, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv, D]; all bf16
// with a unit stride on D, other strides multiples of 8 elements and
// 16-byte aligned bases; each *_strides array holds the (batch, seq, head)
// strides in elements. lse: contiguous fp32 [B, Hq, Sq], the forward's;
// delta: contiguous fp32 [B, Hq, Sq] scratch. Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    void* delta, void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
    int D, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* do_strides, const long long* dq_strides,
    const long long* dk_strides, const long long* dv_strides, int causal, int window,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (D == 64)
    return launch<64>(q, k, v, dout, l, d, dq, dk, dv, B, Hq, Hkv, Sq, Sk, q_strides,
                      k_strides, v_strides, do_strides, dq_strides, dk_strides, dv_strides,
                      causal, window, s);
  if (D == 128)
    return launch<128>(q, k, v, dout, l, d, dq, dk, dv, B, Hq, Hkv, Sq, Sk, q_strides,
                       k_strides, v_strides, do_strides, dq_strides, dk_strides, dv_strides,
                       causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
