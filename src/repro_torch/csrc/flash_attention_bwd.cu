// Backward flash attention for Hopper (sm_90a): bf16 operands and
// gradients, fp32 accumulate, TMA loads into `mbarrier` rings and
// warpgroup MMA (`wgmma`), warp-specialised.
//
// Replaces `jax.grad` of the pure-jnp `chunked_attention`
// (src/repro/models/attention.py:51), which is what the JAX training path
// differentiates; no Pallas backward exists. Given q, k, v, the forward's
// row log-sum-exp (csrc/flash_attention.cu with a non-null `lse`) and dO,
// it returns dQ, dK and dV under the forward's conventions: GQA with the
// kv head of q head h at h / (Hq / Hkv), so dK and dV sum over the group's
// q heads; causal and sliding-window masks on absolute positions (key j at
// j, q row r at r + q_off: a sequence shard's rows against the whole
// sequence's keys); ragged Sq and Sk; D in {64, 128}; the model layout
// [B, S, H, D] with the caller's (batch, seq, head) strides.
//
// What bounds it. The work is 10 * D FLOPs per unmasked (q, k) pair (S
// recomputed, dV, dP, dK, dQ); at the training shape (B = 2, S = 2048, Hq =
// 16, Hkv = 2, D = 128, causal) that is 86 GFLOP against ~59 MB of
// compulsory traffic, ~1450 FLOPs per byte: the tensor cores bound it,
// 0.0869 ms at 989 TFLOP/s, which only `wgmma` reaches.
//
// Work done: 14 * D per pair, in three kernels.
//   1. delta (4 * D): one block per (b, q head, 64-row q tile), the longest
//      causal tiles first; one consumer warpgroup and one producer warp,
//      two blocks per SM. The producer's TMA brings the Q and dO tiles once
//      and streams 64-key K and V tiles through a ring; the consumers
//      compute S = Q K^T and dP = dO V^T on `wgmma` (both operands from
//      shared memory) and sum delta_i = sum_j P_ij dP_ij in fp32. Delta
//      stays exact: taking it as rowsum(dO o O) instead carries the
//      forward's rounding of P to bf16 before P V, which moved dQ by 19%
//      (bf16 O) or 4.8% (fp32 O) on rows whose dQ cancels
//      (tests/test_torch_flash_bwd_numerics.py shows it).
//      It writes delta and LSE * log2 e per row, padded to whole q tiles,
//      and zeroes the block's rows of the fp32 dQ accumulator.
//   2. main (10 * D): one block per (64-key tile, b, q head), two
//      warpgroups. K and V stay resident; the Q and dO tiles the keys can
//      see, with their LSE and delta rows (bulk copies), stream by TMA
//      through a ring of kStages stages, each completing on its own
//      `mbarrier`. One thread issues every load, a stage's refill right
//      after the block's per-tile barrier, two tiles ahead of its use. Per
//      64-row q tile, all products on `wgmma`:
//        warpgroup 0: S^T = K Q^T (both operands from shared memory,
//          K-major); P^T = exp2(S^T * scale log2 e - LSE log2 e), a select
//          to 0 where masked, handed to warpgroup 1 in fp32 through shared
//          memory (a named barrier); dV += P^T dO with P^T from registers
//          (bf16) and dO read MN-major (the transpose bit), as the
//          forward's P V;
//        warpgroup 1: dP^T = V dO^T; dS^T = P^T o (dP^T - delta), written
//          to shared memory in bf16 with the 128-byte swizzle, as TMA would;
//          dK += dS^T Q as dV;
//        both, after a barrier: dQ's partial dS K, 64 of the D columns each
//          (D = 64: warpgroup 0 alone), dS read as a transposed A and K as a
//          transposed B; the fp32 partial is staged in shared memory and
//          added to dQ's sum by a TMA bulk reduce-add
//          (`cp.reduce.async.bulk ... add.f32`).
//      At the end each warpgroup stages its dV or dK (64 keys x D) in the
//      idle Q or dO ring and adds it to fp32 sums the same way, summing the
//      group's q heads (as `red.global.add.v2.f32` from registers, the
//      epilogue took ~0.05 ms of the main kernel's ~0.38 at the training
//      shape, scripts/time_flash_bwd.py on a copy without it). All three
//      sums are chunks of [64 rows][64 columns] fp32, swizzled so that the
//      staging stores are free of bank conflicts.
//   3. convert: dQ and dK scaled by 1 / sqrt(D), dQ, dK, dV to bf16.
// P and dS are rounded to bf16 as A operands of their products (P and dS
// stay fp32 for dS = P (dP - delta)); dK, dV, dQ are rounded to bf16 once.
// Masks: only tiles that touch the diagonal, a window edge, Sq or Sk
// compute one (`tile_needs_mask`); TMA zero-fills rows past S, and there P
// is set to 0 by a select, never by arithmetic on the zero rows' LSE.
//
// The grid has no tail. At the training shape B * Hkv = 4, so a grid of
// (b, kv head, key tile) would be 128 blocks for 132 SMs, one wave whose
// first blocks walk 8 heads x 32 q tiles against a mean of 132. Split per
// q head it is 1024 blocks of at most 32 q tiles, about eight waves at one
// block per SM, ordered key tile first: the causal walks (32 q tiles for
// key tile 0, 1 for the last) start longest first and the short ones fill
// the tail. dK and dV are then sums over blocks.
//
// Determinism. The fast path sums dQ's partials (one per key tile) and dK /
// dV's (one per q head) by reduce-adds in the order the blocks reach them,
// so the low bits of the outputs can differ from call to call (chip_smoke.py
// prints by how much); every term is the same. The deterministic path
// (kDet, taken when PyTorch's deterministic-algorithms switch is on) fixes
// both orders, bit-identical from call to call:
//   dK / dV: each main block stores its q head's fp32 partial in a slot of
//     its own ([2][B * Hq][Sk_pad][D], written by a bulk store, zeros where
//     no row sees the keys), and the convert kernel sums a group's Hq / Hkv
//     slots in head order.
//   dQ: the partials of one (b, q head, q tile) are added in key-tile order.
//     A counter per (b, q head, q tile, 64-column half), zeroed by the
//     caller, counts the partials added; the block of key tile kb waits
//     until it equals kb minus the first key tile that reaches that q tile,
//     adds its partial, waits until the add has landed and increments the
//     counter with release semantics (FlashAttention-3's deterministic
//     backward does the same). It cannot deadlock: a block waits only on
//     blocks of lower key tiles, whose block indices are lower (key tile
//     first), and blocks are handed to SMs in index order, so each block it
//     waits on is resident or done; the block of the first key tile waits
//     on none. Only thread 0 of a warpgroup spins.
//
// Registers set the block. ptxas caps a thread at 16,384 registers / (32 x
// the warps on one of the SM's four partitions), rounded down to 8: 255 for
// 8 warps, 168 for 9 to 12. A first main kernel gave each warpgroup 64 keys
// of a 128-key block and every product of them: dK and dV (D / 2 + D / 2
// fp32), S^T, dP^T and dQ's partial (32 each) and the bf16 fragments, ~230
// at D = 128. With a producer warp (288 threads) it was capped at 168 and
// spilled 928 bytes; as 256 threads this CUDA 12.9 ptxas crashed
// (segmentation fault) at every cap above 168 tried (184 to 255). Split by
// role, a warpgroup holds one of dK, dV (64), one of S^T, dP^T (32), its
// fragments (16) and dQ's partial (32): 162 under `__maxnreg__(168)`, no
// spill (130 at D = 64). The delta kernel takes 125, two blocks per SM.
//
// The C entry point builds the tensor maps on the host, launches the three
// kernels on the caller's stream, allocates nothing (scratch comes from
// the caller) and returns a cudaError_t.

#include "hopper.cuh"

namespace {

constexpr int kQTile = 64;    // q rows per tile
constexpr int kKTile = 64;    // keys per tile: the delta kernel's, a main block's
constexpr int kDeltaStages = 2;
constexpr int kStages = 3;
constexpr int kQBoxBytes = kQTile * 128;   // a box of 64 rows
constexpr int kKBoxBytes = kKTile * 128;   // a box of 64 keys
constexpr int kDSBytes = kKTile * kQTile * 2;   // dS^T [64 keys][64 q rows] bf16
constexpr int kPBytes = kKTile * kQTile * 4;    // P^T fp32, in accumulator fragments
constexpr int kRowBytes = 2 * kQTile * 4;       // a q tile's LSE * log2 e and delta
constexpr int kChunkBytes = 64 * 64 * 4;        // an fp32 [64][64] chunk: a dQ partial
constexpr float kLog2e = 1.4426950408889634f;

// The masks take positions, not rows: row r of q stands at r + q_off, so a
// q tile's first row at p_lo = q_lo + q_off and the rows end at p_end = Sq +
// q_off. The caller adds q_off once per tile (and per thread), not per pair.
//
// Whether a (64-row q tile, 64-key tile) pair has a pair to mask: a key
// after a row's position (causal), a key at or before a row's position
// minus the window, a row past the last or a key past Sk.
__device__ __forceinline__ bool tile_needs_mask(int p_lo, int k_lo, int p_end, int Sk,
                                                int causal, int window) {
  bool masked = p_lo + kQTile > p_end || k_lo + kKTile > Sk;
  masked |= causal && k_lo + kKTile - 1 > p_lo;
  masked |= window > 0 && k_lo <= p_lo + kQTile - 1 - window;
  return masked;
}

__device__ __forceinline__ bool visible(int p, int c, int p_end, int Sk, int causal,
                                        int window) {
  bool ok = p < p_end && c < Sk;
  if (causal) ok = ok && p >= c;
  if (window > 0) ok = ok && c > p - window;
  return ok;
}

// acc[64 x D] (+)= A[64 x 16] B[16 x D], A from registers, B MN-major.
template <int D>
__device__ __forceinline__ void wgmma_rs_nd(float* d, const uint32_t* a, uint64_t b) {
  if constexpr (D == 128) {
    wgmma_rs_m64n128_tb(d, a, b, 1);
  } else {
    wgmma_rs_m64n64_tb(d, a, b, 1);
  }
}

// ---- 1. delta -------------------------------------------------------------
template <int D>
constexpr int delta_smem_bytes() {
  return 1024 + (2 + 2 * kDeltaStages) * kQTile * D * 2 + 8 * (1 + 2 * kDeltaStages);
}

// S = Q K^T and dP = dO V^T for one warpgroup's 64 q rows and one 64-key
// tile, all four operands K-major in shared memory, committed as one wgmma
// group (the first k-step overwrites s, dp).
template <int D>
__device__ __forceinline__ void delta_mma(float (&s)[kKTile / 2], float (&dp)[kKTile / 2],
                                          uint32_t q_s, uint32_t do_s, uint32_t k_s,
                                          uint32_t v_s) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n64(s, desc_kmajor(q_s, kQBoxBytes, kk), desc_kmajor(k_s, kQBoxBytes, kk),
                    kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n64(dp, desc_kmajor(do_s, kQBoxBytes, kk), desc_kmajor(v_s, kQBoxBytes, kk),
                    kk > 0);
  wgmma_commit();
}

// delta += P o dP over one tile: P = exp2(S * scale_log2 - LSE * log2 e),
// 0 where masked. Element 4 j + e is the row at position pos0 + 8 (e / 2),
// key k_lo + 8 j + 2 t + e % 2.
__device__ __forceinline__ void delta_accumulate(const float (&s)[kKTile / 2],
                                                 const float (&dpacc)[kKTile / 2],
                                                 float (&drow)[2], const float (&lrow)[2],
                                                 bool masked, int pos0, int k_lo, int t,
                                                 int p_end, int Sk, int causal, int window,
                                                 float scale_log2) {
#pragma unroll
  for (int j = 0; j < kKTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = pos0 + 8 * (e >> 1);
      const int c = k_lo + 8 * j + 2 * t + (e & 1);
      float p = exp2f(s[4 * j + e] * scale_log2 - lrow[e >> 1]);
      p = (!masked || visible(r, c, p_end, Sk, causal, window)) ? p : 0.f;
      drow[e >> 1] += p * dpacc[4 * j + e];
    }
}

template <int D>
__global__ void __launch_bounds__(160, 2)
flash_bwd_delta_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const float* __restrict__ lse, float* __restrict__ rows,
                       float* __restrict__ dq_acc, int Hq, int Hkv, int Sq, int Sk,
                       int Sq_pad, float scale_log2, int causal, int window, int q_off) {
  constexpr int kTileBytes = kQTile * D * 2;  // Q, dO, or one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sDO = sQ + kTileBytes;
  const uint32_t sK = sDO + kTileBytes;                  // + stage * kTileBytes
  const uint32_t sV = sK + kDeltaStages * kTileBytes;    // + stage * kTileBytes
  const uint32_t bars = sV + kDeltaStages * kTileBytes;
  const uint32_t q_full = bars;
  const uint32_t kv_full = bars + 8;                     // + 8 * stage
  const uint32_t empty = bars + 8 * (1 + kDeltaStages);  // + 8 * stage

  // causal tiles near the end of the sequence do the most work: start them first
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kQTile;
  const int bh = blockIdx.y;  // b * Hq + h
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int p_lo = q_lo + q_off;  // the tile's first position
  int kt_end = (Sk + kKTile - 1) / kKTile;
  if (causal) kt_end = min(kt_end, (p_lo + kQTile - 1) / kKTile + 1);
  int kt_begin = 0;
  if (window > 0 && p_lo - window + 1 > 0) kt_begin = (p_lo - window + 1) / kKTile;
  const int n_tiles = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDeltaStages; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: one thread issues every load ----------------------
    if (threadIdx.x == 128 && n_tiles > 0) {
      mbar_expect_tx(q_full, 2 * kTileBytes);
      for (int c = 0; c < D / kBoxCols; ++c) {
        tma_load_4d(sQ + c * kQBoxBytes, &tm_q, q_full, c * kBoxCols, h, q_lo, b);
        tma_load_4d(sDO + c * kQBoxBytes, &tm_do, q_full, c * kBoxCols, h, q_lo, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % kDeltaStages;
        mbar_wait(empty + 8 * stage, ((i / kDeltaStages) & 1) ^ 1);
        const int k_lo = (kt_begin + i) * kKTile;
        // a ragged last tile still counts whole boxes: TMA writes the zeros
        mbar_expect_tx(kv_full + 8 * stage, 2 * kTileBytes);
        for (int c = 0; c < D / kBoxCols; ++c) {
          tma_load_4d(sK + stage * kTileBytes + c * kQBoxBytes, &tm_k, kv_full + 8 * stage,
                      c * kBoxCols, hk, k_lo, b);
          tma_load_4d(sV + stage * kTileBytes + c * kQBoxBytes, &tm_v, kv_full + 8 * stage,
                      c * kBoxCols, hk, k_lo, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 q rows ----------------------------------------
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int t = tid & 3;
  const int row0 = q_lo + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const int pos0 = row0 + q_off;           // and their positions
  const int p_end = Sq + q_off;

  // the main kernel adds every key tile's dQ partial into these rows
  float4* zero = reinterpret_cast<float4*>(dq_acc + (static_cast<long long>(bh) * Sq_pad + q_lo) * D);
  for (int i = tid; i < kQTile * D / 4; i += 128) zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  float lrow[2], drow[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + 8 * hf;
    lrow[hf] = r < Sq ? lse[static_cast<long long>(bh) * Sq + r] * kLog2e : 0.f;
  }
  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % kDeltaStages;
    const int k_lo = (kt_begin + i) * kKTile;
    float sacc[kKTile / 2], dpacc[kKTile / 2];
    mbar_wait(kv_full + 8 * stage, (i / kDeltaStages) & 1);
    delta_mma<D>(sacc, dpacc, sQ, sDO, sK + stage * kTileBytes, sV + stage * kTileBytes);
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(dpacc);
    mbar_arrive(empty + 8 * stage);
    delta_accumulate(sacc, dpacc, drow, lrow,
                     tile_needs_mask(p_lo, k_lo, p_end, Sk, causal, window), pos0, k_lo, t,
                     p_end, Sk, causal, window, scale_log2);
  }
  // the quad's four shares of each row; rows past Sq get zeros
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    drow[hf] += __shfl_xor_sync(0xffffffffu, drow[hf], 1);
    drow[hf] += __shfl_xor_sync(0xffffffffu, drow[hf], 2);
    const int r = row0 + 8 * hf;
    if (t == 0) {
      const long long at = static_cast<long long>(bh) * Sq_pad + r;
      rows[at] = r < Sq ? lrow[hf] : 0.f;
      rows[static_cast<long long>(gridDim.y) * Sq_pad + at] = r < Sq ? drow[hf] : 0.f;
    }
  }
}

// ---- 2. main: dV, dK and dQ's partials ------------------------------------
template <int D>
constexpr int main_smem_bytes() {
  return 1024 + 2 * kKTile * D * 2 + 2 * kStages * kQTile * D * 2 + kPBytes + kDSBytes +
         2 * kChunkBytes + kStages * kRowBytes + 8 * (1 + kStages);
}

// Tile i of a main block (q head h, rows [q_lo, q_lo + 64) of batch b):
// its Q and dO boxes by TMA and its rows of LSE * log2 e and delta by bulk
// copies, into stage i % kStages, completing on that stage's barrier.
template <int D>
__device__ __forceinline__ void load_q_tile(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                            const float* rows, uint32_t sQ, uint32_t sDO,
                                            uint32_t sRows, uint32_t full, int i, int h,
                                            int q_lo, int b, int Hq, int Sq_pad,
                                            long long plane) {
  constexpr int kQTileBytes = kQTile * D * 2;
  const int stage = i % kStages;
  const uint32_t bar = full + 8 * stage;
  mbar_expect_tx(bar, 2 * kQTileBytes + kRowBytes);
  for (int c = 0; c < D / kBoxCols; ++c) {
    tma_load_4d(sQ + stage * kQTileBytes + c * kQBoxBytes, tm_q, bar, c * kBoxCols, h, q_lo, b);
    tma_load_4d(sDO + stage * kQTileBytes + c * kQBoxBytes, tm_do, bar, c * kBoxCols, h, q_lo,
                b);
  }
  const float* r = rows + (static_cast<long long>(b) * Hq + h) * Sq_pad + q_lo;
  bulk_load(sRows + stage * kRowBytes, r, kRowBytes / 2, bar);
  bulk_load(sRows + stage * kRowBytes + kRowBytes / 2, r + plane, kRowBytes / 2, bar);
}

// A warpgroup's fp32 accumulator [64 rows x N] into shared memory as N / 64
// chunks of [64 rows][64 columns], column c of row r at c ^ 8 (r mod 8) so
// that the rows' float2 stores fall on distinct banks: the layout of the
// fp32 sums in global memory (the convert kernel reads it back).
template <int N>
__device__ __forceinline__ void stage_acc(const float (&acc)[N / 2], uint32_t smem, int tid) {
  const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = 16 * warp + g + 8 * hf;
      const uint32_t at = smem + (j / 8) * kChunkBytes +
                          (row * 64 + ((8 * (j % 8) + 2 * t) ^ ((row & 7) << 3))) * 4;
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(at), "f"(acc[4 * j + 2 * hf]),
                   "f"(acc[4 * j + 2 * hf + 1])
                   : "memory");
    }
}

// Staged values added to fp32 sums at `dst` by a TMA bulk reduce-add that
// thread 0 of the warpgroup issues, once the warpgroup's stores are in, or
// with kStore written there by a bulk store. Before the staging buffer is
// written again, that thread waits until the copy has read it
// (`bulk_wait_read`).
template <bool kStore = false>
__device__ __forceinline__ void reduce_staged(uint32_t smem, float* dst, int bytes, int tid,
                                              int bar_id) {
  fence_proxy_async();
  named_barrier(bar_id, 128);
  if (tid == 0) {
    if constexpr (kStore) {
      bulk_store(dst, smem, bytes);
    } else {
      bulk_reduce_add(dst, smem, bytes);
    }
  }
}

// The first key tile whose main block walks q tile `qt`: the main kernel's
// q-tile range [qt_begin, qt_end) holds qt for key tiles kb >= this one
// (qt_end grows with kb), up to the last key tile its rows see when causal.
__device__ __forceinline__ int first_key_tile(int qt, int window, int q_off) {
  const int need = kQTile * qt + q_off - (kKTile - 2) - window;  // kb * kKTile >= need
  return window <= 0 || need <= 0 ? 0 : (need + kKTile - 1) / kKTile;
}

// One warpgroup's dQ partial for a q tile: columns [n0, n0 + 64) of dS K
// over the block's 64 keys (dS^T [key][q row] in shared memory, read as a
// transposed A; K [key][d] from `k_box`, a transposed B), staged in `dq_s`
// and added to dQ's fp32 sum at `dst`. With kDet the add waits its turn on
// the counter `sem`, which then counts `rank` partials, and publishes it.
template <bool kDet>
__device__ __forceinline__ void dq_partial(uint32_t ds_s, uint32_t k_box, uint32_t dq_s,
                                           float* dst, int* sem, int rank, int tid,
                                           int bar_id) {
  float dq[32];  // the first k-step overwrites it
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKTile / 16; ++kk)
    wgmma_ss_m64n64_tt(dq, desc_mnmajor(ds_s, kDSBytes, kk),
                       desc_mnmajor(k_box, kKBoxBytes, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  stage_acc<64>(dq, dq_s, tid);
  if constexpr (kDet) {
    fence_proxy_async();
    named_barrier(bar_id, 128);
    if (tid == 0) {
      sem_wait_eq(sem, rank);
      bulk_reduce_add(dst, dq_s, kChunkBytes);
      bulk_wait_done();
      sem_release_inc(sem);
    }
  } else {
    reduce_staged(dq_s, dst, kChunkBytes, tid, bar_id);
  }
}

template <int D, bool kDet>
__global__ void __maxnreg__(168)
flash_bwd_main_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const float* __restrict__ rows, float* __restrict__ dq_acc,
                      float* __restrict__ dkv_acc, int* __restrict__ dq_sem, int B, int Hq,
                      int Hkv, int Sq, int Sk, int Sq_pad, int Sk_pad, float scale_log2,
                      int causal, int window, int q_off) {
  constexpr int kQTileBytes = kQTile * D * 2;  // a Q or dO tile
  constexpr int kKVBytes = kKTile * D * 2;     // the K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + kKVBytes;
  const uint32_t sQ = sV + kKVBytes;                  // + stage * kQTileBytes
  const uint32_t sDO = sQ + kStages * kQTileBytes;    // + stage * kQTileBytes
  const uint32_t sDS = sDO + kStages * kQTileBytes;
  const uint32_t sDQ = sDS + kDSBytes;                // + wg * kChunkBytes
  const uint32_t sP = sDQ + 2 * kChunkBytes;
  const uint32_t sRows = sP + kPBytes;                // + stage * kRowBytes
  const uint32_t bars = sRows + kStages * kRowBytes;
  const uint32_t kv_full = bars;
  const uint32_t full = bars + 8;                     // + 8 * stage
  float4* p_s = reinterpret_cast<float4*>(smem_raw + (sP - raw));
  const float* rows_s = reinterpret_cast<const float*>(smem_raw + (sRows - raw));

  // key tile first, so the blocks of key tile 0, whose causal walks are the
  // longest, start first; then (b, q head)
  const int kb = blockIdx.x / (B * Hq);
  const int b = blockIdx.x % (B * Hq) / Hq;
  const int h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int k_lo = kb * kKTile;
  // the q tiles whose rows' positions (row + q_off) see one of these keys
  const int qt_begin = causal ? max(k_lo - q_off, 0) / kQTile : 0;
  int qt_end = Sq_pad / kQTile;
  if (window > 0) {
    const int last_row = k_lo + kKTile - 2 + window - q_off;  // the last one that sees a key
    qt_end = last_row < 0 ? 0 : min(qt_end, last_row / kQTile + 1);
  }
  const int n_q = max(qt_end - qt_begin, 0);  // iteration i: q tile qt_begin + i
  const int p_end = Sq + q_off;               // the masks' bound on row positions
  // this block's share of dK's fp32 sum (dV's one plane further), summing
  // the group's q heads across blocks; with kDet its own slot of them
  const int slot = kDet ? b * Hq + h : b * Hkv + hk;
  const long long kv_plane = static_cast<long long>(B) * (kDet ? Hq : Hkv) * Sk_pad * D;
  float* dkp = dkv_acc + (static_cast<long long>(slot) * Sk_pad + k_lo) * D;
  if (n_q == 0) {  // no row sees these keys: their dK, dV stay 0
    if constexpr (kDet) {
      for (int i = threadIdx.x; i < kKTile * D / 4; i += blockDim.x) {
        reinterpret_cast<float4*>(dkp)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        reinterpret_cast<float4*>(dkp + kv_plane)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  // Thread 0 issues every load: K and V once, then tile i's Q, dO and rows
  // into stage i % kStages, completing on full[stage]. A stage is refilled
  // once both warpgroups have passed the barrier after its last read.
  const long long plane = static_cast<long long>(B) * Hq * Sq_pad;  // rows' delta half
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(kv_full, 2 * kKVBytes);
    for (int c = 0; c < D / kBoxCols; ++c) {
      tma_load_4d(sK + c * kKBoxBytes, &tm_k, kv_full, c * kBoxCols, hk, k_lo, b);
      tma_load_4d(sV + c * kKBoxBytes, &tm_v, kv_full, c * kBoxCols, hk, k_lo, b);
    }
    for (int i = 0; i < min(kStages, n_q); ++i)
      load_q_tile<D>(&tm_q, &tm_do, rows, sQ, sDO, sRows, full, i, h, (qt_begin + i) * kQTile,
                     b, Hq, Sq_pad, plane);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int t = tid & 3;
  // element 4 j + e of a [64 keys x 64 q rows] accumulator: key k_lo + 16 warp
  // + g + 8 (e / 2), q row q_lo + 8 j + 2 t + e % 2
  const bool does_dq = D == 128 || wg == 0;  // dQ's columns [64 wg, + 64)
  // kDet: the counters of this (b, q head)'s q tiles, this warpgroup's half
  int* const sems = kDet ? dq_sem + static_cast<long long>(b * Hq + h) * (Sq_pad / kQTile) * 2 + wg
                         : nullptr;
  mbar_wait(kv_full, 0);

  if (wg == 0) {
    // ---- warpgroup 0: S^T, P^T, dV ---------------------------------------------
    float dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv[i] = 0.f;
    for (int i = 0; i < n_q; ++i) {
      const int stage = i % kStages;
      const int q_lo = (qt_begin + i) * kQTile;
      const int p_lo = q_lo + q_off;  // its first row's position
      const uint32_t q_s = sQ + stage * kQTileBytes;
      const uint32_t do_s = sDO + stage * kQTileBytes;
      const float* lse2 = rows_s + stage * (kRowBytes / 4);  // LSE * log2 e
      mbar_wait(full + 8 * stage, (i / kStages) & 1);
      // S^T = K Q^T (the first k-step overwrites sacc)
      float sacc[kQTile / 2];
      uint32_t pa[kQTile / 16][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64(sacc, desc_kmajor(sK, kKBoxBytes, kk), desc_kmajor(q_s, kQBoxBytes, kk),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      // P^T = exp2(S^T * scale_log2 - LSE * log2 e), 0 where masked, in fp32
      // for warpgroup 1's dS^T (the same thread of it holds the same elements)
      const bool masked = tile_needs_mask(p_lo, k_lo, p_end, Sk, causal, window);
#pragma unroll
      for (int j = 0; j < kQTile / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = p_lo + 8 * j + 2 * t + (e & 1);
          const int c = k_lo + 16 * warp + g + 8 * (e >> 1);
          const float p = exp2f(sacc[4 * j + e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
          sacc[4 * j + e] = (!masked || visible(r, c, p_end, Sk, causal, window)) ? p : 0.f;
        }
        p_s[j * 128 + tid] = make_float4(sacc[4 * j], sacc[4 * j + 1], sacc[4 * j + 2],
                                         sacc[4 * j + 3]);
      }
      named_barrier_arrive(1, 256);  // P^T is in
      // dV += P^T dO
      pack_a<kQTile>(sacc, pa);
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk) fence_regs(pa[kk]);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk)
        wgmma_rs_nd<D>(dv, pa[kk], desc_mnmajor(do_s, kQBoxBytes, kk));
      wgmma_commit();
      if (tid == 0) bulk_wait_read();  // tile i - 1's dQ staging has been read
      named_barrier(2, 256);           // dS^T is in; P^T has been read
      wgmma_wait<0>();
      fence_regs(dv);
      // every read of stage (i - 1) % kStages is done: refill it
      if (threadIdx.x == 0 && i >= 1 && i - 1 + kStages < n_q) {
        const int n = i - 1 + kStages;
        load_q_tile<D>(&tm_q, &tm_do, rows, sQ, sDO, sRows, full, n, h, (qt_begin + n) * kQTile,
                       b, Hq, Sq_pad, plane);
      }
      const int qt = qt_begin + i;
      dq_partial<kDet>(sDS, sK, sDQ,
                       dq_acc + (static_cast<long long>(b * Hq + h) * Sq_pad + q_lo) * D,
                       sems + 2 * qt, kb - first_key_tile(qt, window, q_off), tid, 3);
    }
    // dV, staged in the Q ring once warpgroup 1's last dK has read it
    named_barrier(5, 256);
    stage_acc<D>(dv, sQ, tid);
    reduce_staged<kDet>(sQ, dkp + kv_plane, kKTile * D * 4, tid, 3);
  } else {
    // ---- warpgroup 1: dP^T, dS^T, dK -------------------------------------------
    float dk[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
    for (int i = 0; i < n_q; ++i) {
      const int stage = i % kStages;
      const int q_lo = (qt_begin + i) * kQTile;
      const uint32_t q_s = sQ + stage * kQTileBytes;
      const uint32_t do_s = sDO + stage * kQTileBytes;
      const float* delta = rows_s + stage * (kRowBytes / 4) + kQTile;
      mbar_wait(full + 8 * stage, (i / kStages) & 1);
      // dP^T = V dO^T (the first k-step overwrites dpacc)
      float dpacc[kQTile / 2];
      uint32_t dsa[kQTile / 16][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64(dpacc, desc_kmajor(sV, kKBoxBytes, kk),
                        desc_kmajor(do_s, kQBoxBytes, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dpacc);
      named_barrier(1, 256);  // P^T is in
      // dS^T = P^T o (dP^T - delta)
#pragma unroll
      for (int j = 0; j < kQTile / 8; ++j) {
        const float4 p = p_s[j * 128 + tid];
        const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
        dpacc[4 * j + 0] = p.x * (dpacc[4 * j + 0] - dl.x);
        dpacc[4 * j + 1] = p.y * (dpacc[4 * j + 1] - dl.y);
        dpacc[4 * j + 2] = p.z * (dpacc[4 * j + 2] - dl.x);
        dpacc[4 * j + 3] = p.w * (dpacc[4 * j + 3] - dl.y);
      }
      pack_a<kQTile>(dpacc, dsa);
      // dS^T [key][q row] into shared memory with the 128-byte swizzle (the
      // 16-byte chunk of a 128-byte row XORed with the row's index mod 8):
      // dsa[kk][e] holds key 16 warp + g + 8 (e % 2), q rows 16 kk + 8 (e / 2)
      // + 2 t and the next
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * warp + g + 8 * (e & 1);
          const int col = 16 * kk + 8 * (e >> 1) + 2 * t;
          const uint32_t at = sDS + key * 128 + (((col >> 3) ^ (key & 7)) << 4) + (col & 7) * 2;
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(at), "r"(dsa[kk][e]) : "memory");
        }
      fence_proxy_async();
      // dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk) fence_regs(dsa[kk]);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk)
        wgmma_rs_nd<D>(dk, dsa[kk], desc_mnmajor(q_s, kQBoxBytes, kk));
      wgmma_commit();
      if (tid == 0) bulk_wait_read();  // tile i - 1's dQ staging has been read
      named_barrier(2, 256);           // dS^T is in; P^T has been read
      wgmma_wait<0>();
      fence_regs(dk);
      if (does_dq) {
        const int qt = qt_begin + i;
        dq_partial<kDet>(sDS, sK + kKBoxBytes, sDQ + kChunkBytes,
                         dq_acc + (static_cast<long long>(b * Hq + h) * Sq_pad + q_lo) * D +
                             kQTile * 64,
                         sems + 2 * qt, kb - first_key_tile(qt, window, q_off), tid, 4);
      }
    }
    // dK, staged in the dO ring
    named_barrier(5, 256);
    stage_acc<D>(dk, sDO, tid);
    reduce_staged<kDet>(sDO, dkp, kKTile * D * 4, tid, 4);
  }
  if (tid == 0) bulk_wait_read();  // shared memory stays until the reduces have read it
}

// ---- 3. convert -----------------------------------------------------------
// One output: its fp32 sums [B, H, S_pad / 64, D / 64] chunks of [64 rows]
// [64 columns], column c of row r at c ^ 8 (r mod 8), as the main kernel
// stages them, times `scale`, into bf16 out [B, S, H, D] (strides in
// elements). With kDet the sums of head h are `group` consecutive slots
// [B, H * group, ...], added in slot order.
struct ConvertJob {
  const float* acc;
  __nv_bfloat16* out;
  long long sb, ss, sh;
  int H, S, S_pad, group;
  float scale;
};

template <bool kDet>
__global__ void __launch_bounds__(256)
flash_bwd_convert_kernel(ConvertJob dq, ConvertJob dk, ConvertJob dv, int B, int D) {
  const ConvertJob job = blockIdx.y == 0 ? dq : (blockIdx.y == 1 ? dk : dv);
  const int per_row = D / 8;  // 8 columns a thread
  const long long n = static_cast<long long>(B) * job.S * job.H * per_row;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; c < n;
       c += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int d8 = static_cast<int>(c % per_row);
    long long rest = c / per_row;
    const int h = static_cast<int>(rest % job.H);
    rest /= job.H;
    const int s = static_cast<int>(rest % job.S);
    const int b = static_cast<int>(rest / job.S);
    const int r = s % 64;
    const int group = kDet ? job.group : 1;
    const long long chunk_row0 =
        (static_cast<long long>(b) * job.H + h) * group * job.S_pad + s - r;
    const float4* src = reinterpret_cast<const float4*>(
        job.acc + chunk_row0 * D + (8 * d8 / 64) * 64 * 64 + r * 64 +
        ((8 * d8) % 64 ^ ((r & 7) << 3)));
    float4 x = src[0], y = src[1];
    if constexpr (kDet) {
      const long long slot = static_cast<long long>(job.S_pad) * D / 4;  // in float4
      for (int g = 1; g < group; ++g) {
        const float4 x1 = src[g * slot], y1 = src[g * slot + 1];
        x = make_float4(x.x + x1.x, x.y + x1.y, x.z + x1.z, x.w + x1.w);
        y = make_float4(y.x + y1.x, y.y + y1.y, y.z + y1.z, y.w + y1.w);
      }
    }
    const float sc = job.scale;
    uint4 o;
    o.x = pack_bf16(x.x * sc, x.y * sc);
    o.y = pack_bf16(x.z * sc, x.w * sc);
    o.z = pack_bf16(y.x * sc, y.y * sc);
    o.w = pack_bf16(y.z * sc, y.w * sc);
    *reinterpret_cast<uint4*>(job.out + b * job.sb + s * job.ss + h * job.sh + 8 * d8) = o;
  }
}

// ---- host ----------------------------------------------------------------
template <int D, bool kDet>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           float* rows, float* dq_acc, float* dkv_acc, int* dq_sem, void* dq, void* dk,
           void* dv, int B,
           int Hq, int Hkv, int Sq, int Sk, const long long* qs, const long long* ks,
           const long long* vs, const long long* dos, const long long* dqs,
           const long long* dks, const long long* dvs, int causal, int window,
           int q_off, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int Sq_pad = (Sq + kQTile - 1) / kQTile * kQTile;
  const int Sk_pad = (Sk + kKTile - 1) / kKTile * kKTile;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float scale_log2 = scale * kLog2e;
  CUtensorMap tq, tdo, tk, tv;
  int err = make_map(&tq, q, D, Hq, Sq, B, qs, kQTile);
  if (err == 0) err = make_map(&tdo, dout, D, Hq, Sq, B, dos, kQTile);
  if (err == 0) err = make_map(&tk, k, D, Hkv, Sk, B, ks, kKTile);
  if (err == 0) err = make_map(&tv, v, D, Hkv, Sk, B, vs, kKTile);
    if (err != 0) return err;

  constexpr int delta_bytes = delta_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_delta_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, delta_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_delta_kernel<D><<<dim3(Sq_pad / kQTile, B * Hq), 160, delta_bytes, stream>>>(
      tq, tdo, tk, tv, lse, rows, dq_acc, Hq, Hkv, Sq, Sk, Sq_pad, scale_log2, causal,
      window, q_off);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr int main_bytes = main_smem_bytes<D>();
  e = cudaFuncSetAttribute(flash_bwd_main_kernel<D, kDet>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, main_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int main_blocks = Sk_pad / kKTile * B * Hq;  // 1024 at the training shape
  flash_bwd_main_kernel<D, kDet><<<main_blocks, 256, main_bytes, stream>>>(
      tq, tdo, tk, tv, rows, dq_acc, dkv_acc, dq_sem, B, Hq, Hkv, Sq, Sk, Sq_pad, Sk_pad,
      scale_log2, causal, window, q_off);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int group = kDet ? Hq / Hkv : 1;  // slots per kv head's sums
  const long long kv_plane = static_cast<long long>(B) * Hkv * group * Sk_pad * D;
  const ConvertJob jq{dq_acc, static_cast<bf16*>(dq), dqs[0], dqs[1], dqs[2], Hq, Sq, Sq_pad, 1,
                      scale};
  const ConvertJob jk{dkv_acc, static_cast<bf16*>(dk), dks[0], dks[1], dks[2], Hkv, Sk, Sk_pad,
                      group, scale};
  const ConvertJob jv{dkv_acc + kv_plane, static_cast<bf16*>(dv), dvs[0], dvs[1], dvs[2], Hkv, Sk,
                      Sk_pad, group, 1.f};
  flash_bwd_convert_kernel<kDet><<<dim3(4 * 132, 3), 256, 0, stream>>>(jq, jk, jv, B, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv, D]; all bf16
// with a unit stride on D, other strides multiples of 8 elements and
// 16-byte aligned bases; each *_strides array holds the (batch, seq, head)
// strides in elements. lse: contiguous fp32 [B, Hq, Sq], the forward's.
// Scratch, fp32 and contiguous, with Sq_pad = Sq and Sk_pad = Sk rounded up
// to 64: rows [2, B * Hq, Sq_pad] and dq_acc [B * Hq, Sq_pad, D], both
// written before they are read; dkv_acc [2, B * Hkv, Sk_pad, D], zeros.
// dq_sem null takes the fast path. Non-null, it is int32 [B * Hq, Sq_pad /
// 64, 2], zeros, and the path is deterministic; dkv_acc is then
// [2, B * Hq, Sk_pad, D], written before it is read. q_off >= 0: row r of
// q stands at position r + q_off, key j at j. Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    void* rows, void* dq_acc, void* dkv_acc, void* dq_sem, void* dq, void* dk, void* dv,
    int B, int Hq,
    int Hkv, int Sq, int Sk, int D, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* do_strides, const long long* dq_strides,
    const long long* dk_strides, const long long* dv_strides, int causal, int window,
    int q_off, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* r = static_cast<float*>(rows);
  float* aq = static_cast<float*>(dq_acc);
  float* akv = static_cast<float*>(dkv_acc);
  int* sem = static_cast<int*>(dq_sem);
#define REPRO_BWD_LAUNCH(D_, DET_)                                                          \
  launch<D_, DET_>(q, k, v, dout, l, r, aq, akv, sem, dq, dk, dv, B, Hq, Hkv, Sq, Sk,       \
                   q_strides, k_strides, v_strides, do_strides, dq_strides, dk_strides,     \
                   dv_strides, causal, window, q_off, s)
  if (D == 64) return sem ? REPRO_BWD_LAUNCH(64, true) : REPRO_BWD_LAUNCH(64, false);
  if (D == 128) return sem ? REPRO_BWD_LAUNCH(128, true) : REPRO_BWD_LAUNCH(128, false);
#undef REPRO_BWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
