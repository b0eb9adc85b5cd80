// Forward flash attention for Hopper (sm_90a): bf16 in, fp32 accumulate,
// TMA loads and warpgroup MMA (wgmma), warp-specialised.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py: GQA attention with an online
// softmax, causal and/or sliding-window masks on absolute positions that
// both count from 0, padded KV columns masked by `kpos < Sk`, and the final
// division clamping the row sum at 1e-30. P is rounded to bf16 before
// P @ V. The kv head of q head h is h / (Hq / Hkv).
//
// What bounds it. At the prefill shape (B = 8, S = 1024, Hq = 16, Hkv = 2,
// D = 128, causal) the work is 4 * D FLOPs per unmasked (q, k) pair,
// 34.4 GFLOP against 75.5 MB of compulsory traffic: ~455 FLOPs per byte,
// above the H100's ~295 bf16 FLOPs per byte, so the bound is the tensor
// cores (~35 us at 989 TFLOP/s), which only `wgmma` reaches.
//
// Design. A block of two consumer warpgroups and one producer warpgroup
// owns one (batch, q head, 128-row q tile); the grid is (ceil(Sq / 128),
// B * Hq), the longest causal tiles first.
//   - The producer warpgroup (warps 8-11) gives its registers away
//     (`setmaxnreg` 40, the consumers take 232) and one thread of it issues
//     every load: the Q tile once, then (K tile, V tile) pairs of
//     kBlockK = 64 keys into a ring of kStages = 4 stages, each signalled
//     by its own `mbarrier` (full per K and per V, empty per stage). The
//     loads are TMA copies through one 4-D tensor map per operand over
//     (D, H, S, B) with the caller's strides and the 128-byte swizzle, so
//     a tile of D columns is D / 64 boxes of 64 columns (128 bytes). Rows
//     past S arrive as zeros.
//   - Warpgroups 0 and 1 are the consumers, 64 q rows each. Per tile: S =
//     Q K^T as D / 16 `wgmma.m64n64k16` with both operands read from
//     shared memory (K [key][d] is K-major); the online softmax in
//     registers in the log2 domain, rows reduced across the quad of the
//     accumulator layout; P rounded to bf16 straight from the S
//     accumulators into A fragments; O += P V as 4 `wgmma.m64nDk16` with A
//     from registers and V [key][d], which is MN-major, read with the
//     transpose bit. Only tiles that touch the diagonal, the window edge or
//     Sk compute a mask: TMA's zero rows past Sk would score 0, not -inf.
//   - The consumer loop is pipelined across two wgmma groups: S of tile i
//     is issued before P V of tile i - 1, and the softmax of tile i runs
//     while that P V is on the tensor cores; the output is rescaled and the
//     stage released once it completes.
//   - Registers set the tile. The kernel is compiled for 168 registers a
//     thread (`__maxnreg__`: 384 threads, 3 warps on each of the SM's four
//     register-file partitions). 128-key tiles need ~190 (S 64 + O 64 +
//     P 32 + the rest) and spill at every `setmaxnreg` split tried (24/240
//     to 72/216: ptxas does not budget the consumers' code above the
//     kernel's count); 64-key tiles need S 32 + O 64 + P 16 and fit. The
//     `setmaxnreg` pair still pays at 64-key tiles, ~6-8% in one call
//     against the same block without it (chip_smoke.py via
//     scripts/chip_variants.sh).
//   - Shared memory, 1024-byte aligned: Q (128 x D bf16) + kStages x (K +
//     V) (2 x 64 x D bf16): 160 KB at D = 128 (164,968 bytes requested
//     with the alignment slack and barriers), 80 KB at D = 64; one block
//     of 384 threads per SM.
// The producer keeps loads up to four tiles ahead, and each consumer's
// softmax also overlaps the other's wgmma. Left for later: ping-pong
// ordering of the two consumers and a persistent grid.
//
// Training. Given a non-null `lse`, the epilogue also writes each row's
// natural-log sum of exponentials of the scaled scores, logsumexp_j(s_ij *
// scale) = ln 2 * (m * scale_log2 + log2 l) from the log2-domain running
// max m (raw scores) and sum l, as fp32 [B, Hq, Sq]: what the backward
// kernels (csrc/flash_attention_bwd.cu) recompute P from. Serving passes
// null and writes nothing more.
//
// The C entry point builds the tensor maps on the host
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
// nothing links libcuda), launches on the caller's stream, allocates
// nothing and returns a cudaError_t.

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 128;  // q rows per block: two consumers of 64
constexpr int kBlockK = 64;   // keys per tile
constexpr int kStages = 4;
constexpr int kThreads = 3 * 128;  // two consumer warpgroups, a producer warpgroup
constexpr int kQBoxBytes = kBlockQ * 128;   // a box of 128 q rows
constexpr int kKVBoxBytes = kBlockK * 128;  // a box of one key tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// S (+)= Q K^T over one key tile, N = kBlockK.
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (kBlockK == 128) {
    wgmma_ss_m64n128(d, a, b, accumulate);
  } else {
    wgmma_ss_m64n64(d, a, b, accumulate);
  }
}

// O (+)= P V, N = D.
template <int D>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  if constexpr (D == 128) {
    wgmma_rs_m64n128_tb(d, a, b, accumulate);
  } else {
    wgmma_rs_m64n64_tb(d, a, b, accumulate);
  }
}


// S = Q K^T for this warpgroup's 64 rows and one key tile, committed as
// one wgmma group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sacc)[kBlockK / 2], uint32_t q_rows,
                                         uint32_t k_tile) {
  fence_regs(sacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_qk(sacc, desc_kmajor(q_rows, kQBoxBytes, kk),
             desc_kmajor(k_tile, kKVBoxBytes, kk), kk > 0);
  wgmma_commit();
}

// O += P V for one tile, P in registers, committed as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2],
                                         uint32_t (&pa)[kBlockK / 16][4],
                                         uint32_t sV, int stage) {
  constexpr int kTileBytes = kBlockK * D * 2;
  const uint32_t v_tile = sV + stage * kTileBytes;
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) fence_regs(pa[kk]);
  fence_regs(oacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
    wgmma_pv<D>(oacc, pa[kk], desc_mnmajor(v_tile, kKVBoxBytes, kk), 1);
  wgmma_commit();
}

// The online softmax of one tile of scores in sacc, in place: masks (when
// `masked`), the running max m and sum l of this thread's two rows, p =
// exp2(s * scale - max * scale), and corr = exp2((m_old - m_new) * scale)
// for the output accumulator. The products are rounded apart from the
// subtraction, so a row whose every key is masked gets exp2(0), as the
// plain version's uniform softmax of equal scores does.
__device__ __forceinline__ void online_softmax(float (&sacc)[kBlockK / 2], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               bool masked, int row0, int k_lo,
                                               int t, int Sk, int causal,
                                               int window, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + (e >> 1) * 8;
        const int c = k_lo + j * 8 + 2 * t + (e & 1);
        bool ok = c < Sk;
        if (causal) ok = ok && r >= c;
        if (window > 0) ok = ok && c > r - window;
        if (!ok) sacc[4 * j + e] = kNegInf;
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
  }
  float ms[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    ms[rr] = __fmul_rn(mx[rr], scale_log2);
    corr[rr] = exp2f(__fmul_rn(m[rr], scale_log2) - ms[rr]);
    m[rr] = mx[rr];
    l[rr] *= corr[rr];
  }
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(__fmul_rn(sacc[4 * j + e], scale_log2) - ms[e >> 1]);
      sacc[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
}

// P in bf16, straight from the S accumulators into A fragments.
__device__ __forceinline__ void pack_p(const float (&sacc)[kBlockK / 2],
                                       uint32_t (&pa)[kBlockK / 16][4]) {
  pack_a<kBlockK>(sacc, pa);
}

template <int D>
__global__ void __maxnreg__(168)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Hq,
                 int Hkv, int Sq, int Sk,
                 long long o_sb, long long o_ss, long long o_sh,
                 float scale_log2, int causal, int window) {
  constexpr int kQBytes = kBlockQ * D * 2;
  constexpr int kTileBytes = kBlockK * D * 2;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + kQBytes;               // + stage * kTileBytes
  const uint32_t sV = sK + kStages * kTileBytes;  // + stage * kTileBytes
  const uint32_t bars = sV + kStages * kTileBytes;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                 // + 8 * stage
  const uint32_t v_full = bars + 8 * (1 + kStages);  // + 8 * stage
  const uint32_t empty = bars + 8 * (1 + 2 * kStages);

  // Causal tiles near the end of the sequence do the most work: start them
  // first so the short ones fill the tail of the grid.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_lo = q_tile * kBlockQ;
  int kt_end = (Sk + kBlockK - 1) / kBlockK;
  if (causal) kt_end = min(kt_end, (q_lo + kBlockQ - 1) / kBlockK + 1);
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0)
    kt_begin = (q_lo - window + 1) / kBlockK;
  const int n_tiles = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread issues, the rest leave -----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < D / kBoxCols; ++c)
        tma_load_4d(sQ + c * kQBoxBytes, &tm_q, q_full, c * kBoxCols, h, q_lo, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % kStages;
        const uint32_t lap = i / kStages;
        mbar_wait(empty + 8 * stage, (lap & 1) ^ 1);
        const int k_lo = (kt_begin + i) * kBlockK;
        // a ragged last tile still counts whole boxes: TMA writes the zeros
        mbar_expect_tx(k_full + 8 * stage, kTileBytes);
        for (int c = 0; c < D / kBoxCols; ++c)
          tma_load_4d(sK + stage * kTileBytes + c * kKVBoxBytes, &tm_k,
                      k_full + 8 * stage, c * kBoxCols, hk, k_lo, b);
        mbar_expect_tx(v_full + 8 * stage, kTileBytes);
        for (int c = 0; c < D / kBoxCols; ++c)
          tma_load_4d(sV + stage * kTileBytes + c * kKVBoxBytes, &tm_v,
                      v_full + 8 * stage, c * kBoxCols, hk, k_lo, b);
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int cw = threadIdx.x / 128;  // rows [64 cw, 64 cw + 64) of the q tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int g = (tid % 32) >> 2;
    const int t = tid & 3;
    const int r_lo = q_lo + 64 * cw;
    const int row0 = r_lo + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const uint32_t q_rows = sQ + 64 * cw * 128;  // inside each box

    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share; summed over the quad last
    float corr[2];
    float sacc[kBlockK / 2];
    float oacc[D / 2];
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) sacc[i] = 0.f;

    // Only tiles that touch the diagonal, a window edge or Sk need a mask.
    auto needs_mask = [&](int k_lo) {
      bool masked = k_lo + kBlockK > Sk;
      masked |= causal && k_lo + kBlockK - 1 > r_lo;
      masked |= window > 0 && k_lo <= r_lo + 63 - window;
      return masked;
    };

    // Pipelined over tiles: S of tile i is computed while P V of tile
    // i - 1 is still running, and the softmax of tile i overlaps that P V.
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      const int k_lo = kt_begin * kBlockK;
      mbar_wait(k_full, 0);
      issue_qk<D>(sacc, q_rows, sK);
      wgmma_wait<0>();
      fence_regs(sacc);
      online_softmax(sacc, m, l, corr, needs_mask(k_lo), row0, k_lo, t, Sk,
                     causal, window, scale_log2);
      pack_p(sacc, pa);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int stage = i % kStages;
      const int prev = (i - 1) % kStages;
      const int k_lo = (kt_begin + i) * kBlockK;
      mbar_wait(k_full + 8 * stage, (i / kStages) & 1);
      issue_qk<D>(sacc, q_rows, sK + stage * kTileBytes);
      mbar_wait(v_full + 8 * prev, ((i - 1) / kStages) & 1);
      issue_pv<D>(oacc, pa, sV, prev);
      wgmma_wait<1>();  // S of tile i is in; P V of tile i - 1 still runs
      fence_regs(sacc);
      online_softmax(sacc, m, l, corr, needs_mask(k_lo), row0, k_lo, t, Sk,
                     causal, window, scale_log2);
      wgmma_wait<0>();
      fence_regs(oacc);
      mbar_arrive(empty + 8 * prev);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j + 0] *= corr[0];
        oacc[4 * j + 1] *= corr[0];
        oacc[4 * j + 2] *= corr[1];
        oacc[4 * j + 3] *= corr[1];
      }
      pack_p(sacc, pa);
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % kStages;
      mbar_wait(v_full + 8 * last, ((n_tiles - 1) / kStages) & 1);
      issue_pv<D>(oacc, pa, sV, last);
      wgmma_wait<0>();
      fence_regs(oacc);
      mbar_arrive(empty + 8 * last);
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
      if (lse != nullptr && t == 0)
        lse[(static_cast<long long>(b) * Hq + h) * Sq + r] =
            kLn2 * (m[rr] * scale_log2 + log2f(fmaxf(l[rr], 1e-30f)));
      __nv_bfloat16* op = o + b * o_sb + r * o_ss + h * o_sh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + j * 8 + 2 * t) =
            pack_bf16(oacc[4 * j + 2 * rr] * inv, oacc[4 * j + 2 * rr + 1] * inv);
    }
  }
}

// The descriptors rehearsed on one product: S = A K^T for A [64, D] and K
// [kBlockK, D], then O = bf16(S) V for V [kBlockK, D], both fp32 out,
// row-major. One consumer warpgroup; the loads are the attention kernel's
// TMA boxes.
template <int D>
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, float* s_out,
                   float* o_out) {
  constexpr int kQBytes = kBlockQ * D * 2;
  constexpr int kTileBytes = kBlockK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sA = (raw + 1023) & ~1023u;
  const uint32_t sK = sA + kQBytes;
  const uint32_t sV = sK + kTileBytes;
  const uint32_t bar = sV + kTileBytes;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, kQBytes + 2 * kTileBytes);
    for (int c = 0; c < D / kBoxCols; ++c) {
      tma_load_4d(sA + c * kQBoxBytes, &tm_a, bar, c * kBoxCols, 0, 0, 0);
      tma_load_4d(sK + c * kKVBoxBytes, &tm_k, bar, c * kBoxCols, 0, 0, 0);
      tma_load_4d(sV + c * kKVBoxBytes, &tm_v, bar, c * kBoxCols, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  float sacc[kBlockK / 2];
  float oacc[D / 2];
  uint32_t pa[kBlockK / 16][4];
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  issue_qk<D>(sacc, sA, sK);
  wgmma_wait<0>();
  fence_regs(sacc);
  pack_p(sacc, pa);
  issue_pv<D>(oacc, pa, sV, 0);
  wgmma_wait<0>();
  fence_regs(oacc);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 16 * warp + g + (e >> 1) * 8;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
      s_out[r * kBlockK + 8 * j + 2 * t + (e & 1)] = sacc[4 * j + e];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      o_out[r * D + 8 * j + 2 * t + (e & 1)] = oacc[4 * j + e];
  }
}

// ---- host ----------------------------------------------------------------
template <int D>
constexpr int flash_smem_bytes() {
  return 1024 + (kBlockQ + 2 * kStages * kBlockK) * D * 2 + 8 * (1 + 3 * kStages);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
           int Hkv, int Sq, int Sk, const long long* qs, const long long* ks,
           const long long* vs, const long long* os, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, Hq, Sq, B, qs, kBlockQ);
  if (err == 0) err = make_map(&tk, k, D, Hkv, Sk, B, ks, kBlockK);
  if (err == 0) err = make_map(&tv, v, D, Hkv, Sk, B, vs, kBlockK);
  if (err != 0) return err;
  constexpr int bytes = flash_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * Hq);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv, Sq, Sk, os[0], os[1],
      os[2], scale_log2, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_probe(const void* a, const void* k, const void* v, float* s_out,
                 float* o_out, cudaStream_t stream) {
  const long long a_strides[3] = {64LL * D, D, D};
  const long long kv_strides[3] = {1LL * kBlockK * D, D, D};
  CUtensorMap ta, tk, tv;
  int err = make_map(&ta, a, D, 1, 64, 1, a_strides, kBlockQ);
  if (err == 0) err = make_map(&tk, k, D, 1, kBlockK, 1, kv_strides, kBlockK);
  if (err == 0) err = make_map(&tv, v, D, 1, kBlockK, 1, kv_strides, kBlockK);
  if (err != 0) return err;
  constexpr int bytes = 1024 + (kBlockQ + 2 * kBlockK) * D * 2 + 8;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_probe_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_probe_kernel<D><<<1, 128, bytes, stream>>>(ta, tk, tv, s_out, o_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, Sq, Hq, D], k/v: [B, Sk, Hkv, D], o: [B, Sq, Hq, D], all bf16 with
// a unit stride on D, other strides multiples of 8 elements and 16-byte
// aligned bases. Each *_strides array holds the (batch, seq, head) strides
// in elements. lse: null, or contiguous fp32 [B, Hq, Sq] for the rows'
// log-sum-exp. Returns a cudaError_t.
extern "C" int repro_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D == 64)
    return launch<64>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, q_strides, k_strides,
                      v_strides, o_strides, causal, window, s);
  if (D == 128)
    return launch<128>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, q_strides, k_strides,
                       v_strides, o_strides, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The descriptor rehearsal: a [64, D], k/v [kBlockK, D] contiguous bf16;
// s_out [64, kBlockK] and o_out [64, D] contiguous fp32. Returns a
// cudaError_t.
extern "C" int repro_flash_wgmma_probe_bf16(const void* a, const void* k,
                                            const void* v, void* s_out,
                                            void* o_out, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* so = static_cast<float*>(s_out);
  float* oo = static_cast<float*>(o_out);
  if (D == 64) return launch_probe<64>(a, k, v, so, oo, s);
  if (D == 128) return launch_probe<128>(a, k, v, so, oo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
