// Forward flash attention for Hopper (sm_90a): bf16 in, fp32 accumulate,
// TMA loads and warpgroup MMA (wgmma), warp-specialised.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py: GQA attention with an online
// softmax, causal and/or sliding-window masks on absolute positions (key
// j at position j, q row r at r + q_off: a sequence shard's rows against
// the whole sequence's keys), padded KV columns masked by `kpos < Sk`, and the final
// division clamping the row sum at 1e-30. P is rounded to bf16 before
// P @ V. The kv head of q head h is h / (Hq / Hkv).
//
// What bounds it. At the prefill shape (B = 8, S = 1024, Hq = 16, Hkv = 2,
// D = 128, causal) the work is 4 * D FLOPs per unmasked (q, k) pair,
// 34.4 GFLOP against 75.5 MB of compulsory traffic: ~455 FLOPs per byte,
// above the H100's ~295 bf16 FLOPs per byte, so the bound is the tensor
// cores (~35 us at 989 TFLOP/s), which only `wgmma` reaches.
//
// Design. A block of BQ / 64 consumer warpgroups and one producer warpgroup
// owns one (batch, q head, BQ-row q tile); the grid is (ceil(Sq / BQ),
// B * Hq), the longest causal tiles first.
//   - The producer warpgroup gives its registers away (`setmaxnreg` 40, the
//     consumers take the rest) and one thread of it issues every load: the
//     Q tile once, then (K tile, V tile) pairs of BK keys into a ring of
//     kStages stages, each signalled by its own `mbarrier` (full per K and
//     per V, empty per stage). The loads are TMA copies through one 4-D
//     tensor map per operand over (D, H, S, B) with the caller's strides and
//     the 128-byte swizzle, so a tile of D columns is D / 64 boxes of 64
//     columns (128 bytes). Rows past S arrive as zeros.
//   - Each consumer warpgroup owns 64 q rows. Per tile: S = Q K^T as D / 16
//     `wgmma.m64nBKk16` with both operands read from shared memory (K
//     [key][d] is K-major); the online softmax in registers in the log2
//     domain, rows reduced across the quad of the accumulator layout; P
//     rounded to bf16 straight from the S accumulators into A fragments;
//     O += P V as BK / 16 `wgmma.m64nDk16` with A from registers and V
//     [key][d], which is MN-major, read with the transpose bit. Only tiles
//     that touch the diagonal, the window edge or Sk compute a mask: TMA's
//     zero rows past Sk would score 0, not -inf.
//   - The consumer loop is pipelined across two wgmma groups: S of tile i
//     is issued before P V of tile i - 1, and the softmax of tile i runs
//     while that P V is on the tensor cores; the output is rescaled and the
//     stage released once it completes.
//   - Launch configs (BQ, BK), each a template instance that the C entry
//     point selects by its arguments; kernels/flash_attention.py's CONFIGS
//     lists them, and the autotuner (repro_torch/tune/autotune.py) picks one
//     per shape bucket:
//       (128, 64) at D = 64 and 128, the default: two consumers, 384
//         threads, compiled for 168 registers a thread (`__maxnreg__`: 3
//         warps on each of the SM's four register-file partitions); 160 KB
//         of shared memory at D = 128, one block per SM.
//       (64, 64) at D = 64: one consumer, 256 threads, 128 registers a
//         thread, so that two blocks share an SM (73 KB of shared memory
//         each). At D = 64 it takes ~13% less time than the default on
//         the H100 (PERF.md's launch-config table), thought to be two
//         blocks an SM hiding each other's waits.
//     Registers decide which configs exist. Not compiled, because ptxas
//     spills them (chip_smoke.py's [build] and [tune kernels] report):
//       (64, 64) at D = 128: O 64 + S 32 + P 16 + the rest pass the cap of
//         128 (144 bytes spilled).
//       (128, 128) at D = 64: S 64 + O 32 + P 32 + the rest pass 168 (24
//         bytes spilled); unspilled it was slower than (64, 64) anyway.
//       (128, 128) at D = 128: ~190 registers, spilling at every
//         `setmaxnreg` split tried (24/240 to 72/216: ptxas does not budget
//         the consumers' code above the kernel's count).
//     The `setmaxnreg` pair still pays at 64-key tiles, ~6-8% in one call
//     against the same block without it (chip_smoke.py via
//     scripts/chip_variants.sh).
//   - Shared memory, 1024-byte aligned: Q (BQ x D bf16) + kStages x (K + V)
//     (2 x BK x D bf16) and the barriers.
// The producer keeps loads up to kStages tiles ahead, and with two
// consumers each one's softmax also overlaps the other's wgmma. Left for
// later: ping-pong ordering of the two consumers and a persistent grid.
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

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// One launch config's constants: BQ q rows a block (BQ / 64 consumer
// warpgroups of 64 rows), BK keys a tile, at head dim D.
template <int D, int BQ, int BK>
struct Tiles {
  static_assert(BQ == 64 || BQ == 128, "one or two consumer warpgroups");
  static_assert(BK == 64 || BK == 128, "wgmma N of 64 or 128");
  static constexpr int kConsumers = BQ / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer
  static constexpr int kStages = 4;
  // registers a consumer thread takes from the producer's (`setmaxnreg`):
  // the block's total, kernel cap x threads, is unchanged
  static constexpr int kConsumerRegs = kConsumers == 2 ? 232 : 216;
  static constexpr int kQBoxBytes = BQ * 128;   // a box of BQ q rows
  static constexpr int kKVBoxBytes = BK * 128;  // a box of one key tile
  static constexpr int kQBytes = BQ * D * 2;
  static constexpr int kTileBytes = BK * D * 2;  // one K or V tile
  static constexpr int kSmemBytes =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 3 * kStages);
  // one consumer: two blocks share an SM, half its 228 KB each less 1 KB
  // reserved a block
  static_assert(kSmemBytes <= (kConsumers == 1 ? 115712 : 232448),
                "shared memory past the block's share of the SM");
};

// S (+)= Q K^T over one key tile, N = BK.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (BK == 128) {
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
template <int D, int BQ, int BK>
__device__ __forceinline__ void issue_qk(float (&sacc)[BK / 2], uint32_t q_rows,
                                         uint32_t k_tile) {
  using T = Tiles<D, BQ, BK>;
  fence_regs(sacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_qk<BK>(sacc, desc_kmajor(q_rows, T::kQBoxBytes, kk),
                 desc_kmajor(k_tile, T::kKVBoxBytes, kk), kk > 0);
  wgmma_commit();
}

// O += P V for one tile, P in registers, committed as one wgmma group.
template <int D, int BQ, int BK>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2],
                                         uint32_t (&pa)[BK / 16][4],
                                         uint32_t sV, int stage) {
  using T = Tiles<D, BQ, BK>;
  const uint32_t v_tile = sV + stage * T::kTileBytes;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
  fence_regs(oacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv<D>(oacc, pa[kk], desc_mnmajor(v_tile, T::kKVBoxBytes, kk), 1);
  wgmma_commit();
}

// The online softmax of one tile of scores in sacc, in place: masks (when
// `masked`), the running max m and sum l of this thread's two rows, p =
// exp2(s * scale - max * scale), and corr = exp2((m_old - m_new) * scale)
// for the output accumulator. The products are rounded apart from the
// subtraction, so a row whose every key is masked gets exp2(0), as the
// plain version's uniform softmax of equal scores does.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sacc)[BK / 2], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               bool masked, int pos0, int k_lo,
                                               int t, int Sk, int causal,
                                               int window, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = pos0 + (e >> 1) * 8;
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
  for (int j = 0; j < BK / 8; ++j) {
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
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(__fmul_rn(sacc[4 * j + e], scale_log2) - ms[e >> 1]);
      sacc[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
}

// The kernel's body for one launch config; the __global__ entries below
// differ only in their register cap.
template <int D, int BQ, int BK>
__device__ __forceinline__ void flash_fwd_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv,
    int Sq, int Sk, long long o_sb, long long o_ss, long long o_sh,
    float scale_log2, int causal, int window, int q_off) {
  using T = Tiles<D, BQ, BK>;
  constexpr int kStages = T::kStages;
  constexpr int kTileBytes = T::kTileBytes;
  constexpr int kProducer = 128 * T::kConsumers;  // the producer's first thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + T::kQBytes;            // + stage * kTileBytes
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
  const int q_lo = q_tile * BQ;   // the tile's first row
  const int p_lo = q_lo + q_off;  // and its position
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (p_lo + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && p_lo - window + 1 > 0)
    kt_begin = (p_lo - window + 1) / BK;
  const int n_tiles = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kProducer);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {
    // ---- producer warpgroup: one thread issues, the rest leave -----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == kProducer) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < D / kBoxCols; ++c)
        tma_load_4d(sQ + c * T::kQBoxBytes, tm_q, q_full, c * kBoxCols, h, q_lo, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % kStages;
        const uint32_t lap = i / kStages;
        mbar_wait(empty + 8 * stage, (lap & 1) ^ 1);
        const int k_lo = (kt_begin + i) * BK;
        // a ragged last tile still counts whole boxes: TMA writes the zeros
        mbar_expect_tx(k_full + 8 * stage, kTileBytes);
        for (int c = 0; c < D / kBoxCols; ++c)
          tma_load_4d(sK + stage * kTileBytes + c * T::kKVBoxBytes, tm_k,
                      k_full + 8 * stage, c * kBoxCols, hk, k_lo, b);
        mbar_expect_tx(v_full + 8 * stage, kTileBytes);
        for (int c = 0; c < D / kBoxCols; ++c)
          tma_load_4d(sV + stage * kTileBytes + c * T::kKVBoxBytes, tm_v,
                      v_full + 8 * stage, c * kBoxCols, hk, k_lo, b);
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(T::kConsumerRegs)
                 : "memory");
    const int cw = threadIdx.x / 128;  // rows [64 cw, 64 cw + 64) of the q tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int g = (tid % 32) >> 2;
    const int t = tid & 3;
    const int r_lo = q_lo + 64 * cw;
    const int row0 = r_lo + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const int pos0 = row0 + q_off;          // and their positions
    const uint32_t q_rows = sQ + 64 * cw * 128;  // inside each box

    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share; summed over the quad last
    float corr[2];
    float sacc[BK / 2];
    float oacc[D / 2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;

    // Only tiles that touch the diagonal, a window edge or Sk need a mask.
    auto needs_mask = [&](int k_lo) {
      bool masked = k_lo + BK > Sk;
      masked |= causal && k_lo + BK - 1 > r_lo + q_off;
      masked |= window > 0 && k_lo <= r_lo + q_off + 63 - window;
      return masked;
    };

    // Pipelined over tiles: S of tile i is computed while P V of tile
    // i - 1 is still running, and the softmax of tile i overlaps that P V.
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      const int k_lo = kt_begin * BK;
      mbar_wait(k_full, 0);
      issue_qk<D, BQ, BK>(sacc, q_rows, sK);
      wgmma_wait<0>();
      fence_regs(sacc);
      online_softmax<BK>(sacc, m, l, corr, needs_mask(k_lo), pos0, k_lo, t, Sk,
                         causal, window, scale_log2);
      pack_a<BK>(sacc, pa);  // P in bf16, straight from the S accumulators
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int stage = i % kStages;
      const int prev = (i - 1) % kStages;
      const int k_lo = (kt_begin + i) * BK;
      mbar_wait(k_full + 8 * stage, (i / kStages) & 1);
      issue_qk<D, BQ, BK>(sacc, q_rows, sK + stage * kTileBytes);
      mbar_wait(v_full + 8 * prev, ((i - 1) / kStages) & 1);
      issue_pv<D, BQ, BK>(oacc, pa, sV, prev);
      wgmma_wait<1>();  // S of tile i is in; P V of tile i - 1 still runs
      fence_regs(sacc);
      online_softmax<BK>(sacc, m, l, corr, needs_mask(k_lo), pos0, k_lo, t, Sk,
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
      pack_a<BK>(sacc, pa);
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % kStages;
      mbar_wait(v_full + 8 * last, ((n_tiles - 1) / kStages) & 1);
      issue_pv<D, BQ, BK>(oacc, pa, sV, last);
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

#define FLASH_FWD_PARAMS                                                        \
  const __grid_constant__ CUtensorMap tm_q,                                     \
      const __grid_constant__ CUtensorMap tm_k,                                 \
      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,  \
      float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk, long long o_sb, \
      long long o_ss, long long o_sh, float scale_log2, int causal, int window, int q_off
#define FLASH_FWD_ARGS \
  &tm_q, &tm_k, &tm_v, o, lse, Hq, Hkv, Sq, Sk, o_sb, o_ss, o_sh, scale_log2, causal, window, q_off

// Two consumers (BQ = 128): 384 threads, 3 warps on each register-file
// partition, 168 registers a thread.
template <int D, int BK>
__global__ void __maxnreg__(168) flash_fwd_kernel(FLASH_FWD_PARAMS) {
  flash_fwd_body<D, 128, BK>(FLASH_FWD_ARGS);
}

// One consumer (BQ = 64): 256 threads at 128 registers a thread, so that
// two blocks share an SM's 65,536 registers.
template <int D, int BK>
__global__ void __maxnreg__(128) flash_fwd_q64_kernel(FLASH_FWD_PARAMS) {
  flash_fwd_body<D, 64, BK>(FLASH_FWD_ARGS);
}

// The descriptors rehearsed on one product: S = A K^T for A [64, D] and K
// [64, D], then O = bf16(S) V for V [64, D], both fp32 out, row-major. One
// consumer warpgroup; the loads are the default config's TMA boxes.
constexpr int kProbeQ = 128, kProbeK = 64;

template <int D>
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, float* s_out,
                   float* o_out) {
  using T = Tiles<D, kProbeQ, kProbeK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sA = (raw + 1023) & ~1023u;
  const uint32_t sK = sA + T::kQBytes;
  const uint32_t sV = sK + T::kTileBytes;
  const uint32_t bar = sV + T::kTileBytes;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, T::kQBytes + 2 * T::kTileBytes);
    for (int c = 0; c < D / kBoxCols; ++c) {
      tma_load_4d(sA + c * T::kQBoxBytes, &tm_a, bar, c * kBoxCols, 0, 0, 0);
      tma_load_4d(sK + c * T::kKVBoxBytes, &tm_k, bar, c * kBoxCols, 0, 0, 0);
      tma_load_4d(sV + c * T::kKVBoxBytes, &tm_v, bar, c * kBoxCols, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  float sacc[kProbeK / 2];
  float oacc[D / 2];
  uint32_t pa[kProbeK / 16][4];
#pragma unroll
  for (int i = 0; i < kProbeK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  issue_qk<D, kProbeQ, kProbeK>(sacc, sA, sK);
  wgmma_wait<0>();
  fence_regs(sacc);
  pack_a<kProbeK>(sacc, pa);
  issue_pv<D, kProbeQ, kProbeK>(oacc, pa, sV, 0);
  wgmma_wait<0>();
  fence_regs(oacc);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 16 * warp + g + (e >> 1) * 8;
#pragma unroll
    for (int j = 0; j < kProbeK / 8; ++j)
      s_out[r * kProbeK + 8 * j + 2 * t + (e & 1)] = sacc[4 * j + e];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      o_out[r * D + 8 * j + 2 * t + (e & 1)] = oacc[4 * j + e];
  }
}

// ---- host ----------------------------------------------------------------
template <int D, int BQ, int BK>
auto fwd_kernel() {
  if constexpr (BQ == 128) {
    return flash_fwd_kernel<D, BK>;
  } else {
    return flash_fwd_q64_kernel<D, BK>;
  }
}

template <int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
           int Hkv, int Sq, int Sk, const long long* qs, const long long* ks,
           const long long* vs, const long long* os, int causal, int window,
           int q_off, cudaStream_t stream) {
  using T = Tiles<D, BQ, BK>;
  // A runtime call first: it makes the device's primary context current on
  // this thread, which cuTensorMapEncodeTiled needs. PyTorch does not bind
  // one on a thread that has run no CUDA work yet (such as the autotuner's
  // measurement thread).
  const auto kernel = fwd_kernel<D, BQ, BK>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, Hq, Sq, B, qs, BQ);
  if (err == 0) err = make_map(&tk, k, D, Hkv, Sk, B, ks, BK);
  if (err == 0) err = make_map(&tv, v, D, Hkv, Sk, B, vs, BK);
  if (err != 0) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv, Sq, Sk, os[0], os[1],
      os[2], scale_log2, causal, window, q_off);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_probe(const void* a, const void* k, const void* v, float* s_out,
                 float* o_out, cudaStream_t stream) {
  using T = Tiles<D, kProbeQ, kProbeK>;
  const long long a_strides[3] = {64LL * D, D, D};
  const long long kv_strides[3] = {1LL * kProbeK * D, D, D};
  CUtensorMap ta, tk, tv;
  int err = make_map(&ta, a, D, 1, 64, 1, a_strides, kProbeQ);
  if (err == 0) err = make_map(&tk, k, D, 1, kProbeK, 1, kv_strides, kProbeK);
  if (err == 0) err = make_map(&tv, v, D, 1, kProbeK, 1, kv_strides, kProbeK);
  if (err != 0) return err;
  constexpr int bytes = 1024 + T::kQBytes + 2 * T::kTileBytes + 8;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_probe_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_probe_kernel<D><<<1, 128, bytes, stream>>>(ta, tk, tv, s_out, o_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The compiled launch configs, (D, BQ, BK): kernels/flash_attention.py's
// CONFIGS lists the same.
#define FLASH_INSTANCES(X) \
  X(64, 128, 64)           \
  X(64, 64, 64)            \
  X(128, 128, 64)

// q: [B, Sq, Hq, D], k/v: [B, Sk, Hkv, D], o: [B, Sq, Hq, D], all bf16 with
// a unit stride on D, other strides multiples of 8 elements and 16-byte
// aligned bases. Each *_strides array holds the (batch, seq, head) strides
// in elements. lse: null, or contiguous fp32 [B, Hq, Sq] for the rows'
// log-sum-exp. q_off >= 0: row r of q stands at position r + q_off, key j
// at j (0 for a whole sequence). (block_q, block_k) names the launch config, one of
// FLASH_INSTANCES at D; any other is cudaErrorInvalidValue. Returns a
// cudaError_t.
extern "C" int repro_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, int causal, int window, int q_off, int block_q,
    int block_k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FLASH_LAUNCH(d, bq, bk)                                                  \
  if (D == d && block_q == bq && block_k == bk)                                  \
    return launch<d, bq, bk>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, q_strides, k_strides, \
                             v_strides, o_strides, causal, window, q_off, s);
  FLASH_INSTANCES(FLASH_LAUNCH)
#undef FLASH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory of a launch config's block in bytes, or -1 for a
// config with no compiled instance.
extern "C" int repro_flash_attention_fwd_smem_bytes(int D, int block_q, int block_k) {
#define FLASH_SMEM(d, bq, bk) \
  if (D == d && block_q == bq && block_k == bk) return Tiles<d, bq, bk>::kSmemBytes;
  FLASH_INSTANCES(FLASH_SMEM)
#undef FLASH_SMEM
  return -1;
}

// The descriptor rehearsal: a [64, D], k/v [64, D] contiguous bf16; s_out
// [64, 64] and o_out [64, D] contiguous fp32. Returns a cudaError_t.
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
