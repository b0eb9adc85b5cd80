// Mamba2 SSD chunked scan, backward, for Hopper (sm_90a): bf16 x/B/C/dy,
// fp32 dt/A/D; bf16 tensor-core products accumulated in fp32, fp32 carries
// and sums; bf16 dx/dB/dC, fp32 ddt/dA/dD.
//
// No TPU kernel had a backward: this replaces `jax.grad` of the pure-jnp
// `ssd_chunked` (src/repro/models/ssm.py:37), the gradient of what the
// forward kernel csrc/ssd.cu computes. With the forward's tiles of kTile =
// 32 positions and, per (batch, head) and tile, cs the within-tile
// inclusive cumulative sum of a_j = dt_j A, cs_L its last entry, S_in the
// state entering the tile and dS_out the gradient of the state leaving it:
//   G_ij = C_i . B_j,  q_ij = dy_i . x_j,  w_ij = exp(cs_i - cs_j)  (j <= i)
//   M_ij = G_ij w_ij dt_j,  Q_ij = w_ij dt_j q_ij,  F_ij = G_ij w_ij q_ij
//   dx_j  = sum_{i>=j} M_ij dy_i + exp(cs_L - cs_j) dt_j dS_out B_j + D dy_j
//   dB_j  = sum_{i>=j} Q_ij C_i + exp(cs_L - cs_j) dt_j dS_out^T x_j
//   dC_i  = sum_{j<=i} Q_ij B_j + exp(cs_i) S_in^T dy_i
//   dcs_k = sum_j F_kj dt_j - dt_k sum_i F_ik + exp(cs_k) C_k . (S_in^T dy_k)
//           - exp(cs_L - cs_k) dt_k v_k,  v_k = x_k . (dS_out B_k); at
//           k = kTile - 1 also exp(cs_L) <dS_out, S_in>
//           + sum_j exp(cs_L - cs_j) dt_j v_j
//   da_j  = sum_{k>=j} dcs_k;  ddt_j = A da_j + sum_i F_ij
//           + exp(cs_L - cs_j) v_j;  dA = sum dt_j da_j;  dD = sum dy . x
//   S_in of the next tile  = exp(cs_L) S_in + sum_j exp(cs_L - cs_j) dt_j x_j B_j^T
//   dS_out of the tile before = exp(cs_L) dS_out + sum_i exp(cs_i) dy_i C_i^T
// dB and dC are summed over the heads of B's group, dA and dD over (batch,
// position). The final state's gradient is not an input (the train path
// drops the state), so the last tile's dS_out is zero. Positions at or
// past S read zeros (dt = 0 among them), so every term they touch is zero
// and nothing is written for them. exp(cs_i - cs_j) is formed only for
// j <= i, where it is at most 1: above the diagonal it can overflow.
//
// Design: three launches, deterministic (no atomics; every sum has a fixed
// order, so two calls give the same bits):
//   1. ssd_bwd_walk_kernel, one block per (direction, head, batch), P / 16
//      warps, each warp 16 rows of the [P, N] state in fp32 `mma`
//      accumulators for the whole sequence, as csrc/ssd.cu's state warps
//      carry it. The forward walk stores S_in of every tile, then S <- S
//      exp(cs_L) + (x w)^T B; the reverse walk, from the last tile, stores
//      dS_out, then dS <- dS exp(cs_L) + (dy exp(cs))^T C. Each store is
//      the carry split into bf16 hi and lo planes [P, N] (the same bytes
//      as fp32), so the next pass `ldmatrix`es them straight into
//      fragments; each warp's 16 rows of a plane (4 KB, contiguous) go
//      through shared memory and out as 16-byte vectors. Tiles of x or
//      dy, B or C and dt arrive by cp.async, double-buffered.
//   2. ssd_bwd_grad_kernel, one block per (tile, group, batch) of 8
//      product warps and a sums warp, walking the group's heads in order
//      with the next head's x, dy, planes and dt loading (cp.async) while
//      this one computes. G = C B^T once per block. Per head the product
//      warps compute q = dy x^T and from it M, Q (into shared memory as
//      hi / lo) and F's row and column sums, a 16 x 8 tile each; then U =
//      S_in^T dy, dS_out^T x and dS_out B, each a [32, W] output in 2 row
//      halves x 4 column groups, with v = x . (dS_out B) and C . U from the
//      accumulator fragments (quad shuffles), and <dS_out, S_in> from the
//      fragments of the planes those products load. After the block's
//      second barrier the sums warp turns the partial sums into dcs, da,
//      ddt and the head's dA / dD partials while the product warps finish
//      dx = M^T dy + ... and add Q^T C and Q B into the head's dB / dC,
//      which go into the block's cross-head sums in fp32 registers, head
//      by head. dx and ddt go out per head, dB and dC once per block as
//      bf16.
//   3. ssd_bwd_head_sum_kernel: dA, dD summed over (batch, tile) in a fixed
//      order, a warp per head.
// Every product runs on tensor cores, `mma.sync.m16n8k16` bf16 -> fp32
// with `ldmatrix` fragments. The walks' states are per-warp accumulators
// carried across 64 tiles and the gradient pass's tiles have 32 rows, so
// no product has the 64-row, shared-memory-resident operands `wgmma`
// wants without a trip of the carry through shared memory each tile.
//
// What bounds it. At the training shape (B = 8, S = 2048, H = 32, P = 64,
// N = 128, G = 1; T = 64 tiles) the compulsory traffic is reading x, dy
// (67.1 MB each), B, C (4.2 MB each) and dt (2.1 MB) and writing dx
// (67.1 MB), dB, dC and ddt: 222 MB, 66 us at 3.35 TB/s. The workspace is
// the two states' planes per (batch, head, tile), 2 x 537 MB, and dA / dD
// per (batch, head, tile): 1.074 GB (the first version's: 1.611 GB, with
// dB / dC per head), written once by the walks and read once by the
// gradient pass: with the inputs, ~2.4 GB, ~0.72 ms (the first version
// moved 5.37 GB through its workspace: 1.60 ms). The work on tensor cores,
// the hi / lo splits counted, is ~34 GFLOP in the walks and ~75 GFLOP in
// the gradient pass (chip_smoke.py's ssd_bwd_flops, without the splits:
// 49.7 GFLOP), ~0.15 ms at mma.sync's rate. Measured (PERF.md, H100 SXM
// at 700 W), ~1.08 ms in all: the walks ~0.47 ms, 0.22 of it without the
// plane stores (each warp's stores fired straight from its fragments, 4
// bytes a lane, took 1.88 ms); the gradient pass ~0.60 ms, set by each
// head's chain of dependent steps (two barriers, the products, the sums)
// more than by its 1.07 GB of reads: without the plane loads it still
// takes ~88%; the sums of dA / dD ~0.004 ms.
//   - The walks: 64 serial tiles per block, 512 blocks of 4 warps, two a
//     SM (235 registers a thread; capped at 128 to fit four they spill
//     and run slower), 44,288 bytes of shared memory each.
//   - The gradient pass: 512 blocks of 288 threads, one an SM (its
//     187,456 bytes of shared memory: B and C 17,408, two stages of x,
//     dy, four planes and dt 2 x 78,976, M and Q hi / lo 10,240, partial
//     sums 1,856). One sub-partition runs three of its nine warps, so
//     ptxas caps a thread at 168 registers; it takes 168, no spill. G (4),
//     the head's dB, dC (2 x N / 8) and the cross-head sums (2 x N / 8)
//     stay in registers.
//
// Error budget. B, C, x and dy are bf16, so G, q and every product with
// them alone is exact products summed in fp32. Each fp32 operand of a
// product -- x w and dy exp(cs) in the walks (kXwParts), the two states
// (the planes, kStateParts), M (kMParts) and Q (kQParts) -- is split into
// hi = bf16(v) and lo = bf16(v - hi), two MMAs into one fp32 accumulator:
// ~2^-16 relative per term where fp32 errs 2^-24. The carries and the
// cross-head sums are fp32. dx, dB, dC are rounded once to bf16 (2^-9).
// Emulated on the CPU (kernels/ref.py::ssd_backward_tiles with split=True,
// tests/test_torch_ssd_bwd_numerics.py): every output within 2e-5 of
// jax.grad's largest entry; at P = 64, N = 128 (and N = 64), bf16 in and
// out, the worst row against the plain version 2.3e-3 (dx, dB, dC) and
// 3.4e-5 (ddt, dA), as the fp32 emulation. One bf16 rounding instead
// (the lo part dropped) errs, under the JAX tests' dt: M 7.7e-2 in dx, Q
// 2.7e-2 in dC, past chip_smoke.py's 2e-2 gate; the states and x w, dy
// exp(cs) 0.4-1.0e-2 in ddt, dB, dC. dcs is a difference of sums and da its
// suffix sum within one tile (32 terms).
//
// The bf16-intra instance (kIntraParts = 1 in the gradient pass) is the
// gradient of csrc/ssd.cu's: M and Q, the intra-tile products' fp32
// operands, take one bf16 part; the walks, the planes and the sums are
// the default's, as the reference keeps its states fp32 under
// ssd_compute_dtype = "bfloat16". Its error is that one rounding's, of the
// size of the reference's own bf16 gradients' (emulated under the JAX
// tests' dt: dx 1.07e-1 against 8.2e-2, dB 5.6e-2 against 1.95e-1;
// tests/test_torch_ssd_knobs.py), held to 1.5x theirs on the card.
//
// Every C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // positions per tile: csrc/ssd.cu's kTile
// the gradient pass: 8 warps of products in 4 column groups of two row
// halves, and a warp for the per-position sums
constexpr int kProductWarps = 8;
constexpr int kGroups = kProductWarps / 2;
constexpr int kThreads = 32 * (kProductWarps + 1);
// hi + lo parts of each fp32 operand of a tensor-core product; M's and
// Q's are the gradient pass's template parameter (2, or 1 for bf16-intra)
constexpr int kXwParts = 2;     // x w and dy exp(cs), in the walks
constexpr int kStateParts = 2;  // the S_in and dS_out planes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies with a zero fill: src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Fragment layout of m16n8k16 (lane = 4 g + t):
//   A (16x16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//              a3 = (g+8, 2t+8..)
//   B (16x8):  b0 = (k = 2t..2t+1, n = g), b1 = (k = 2t+8.., n = g)
//   C (16x8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// Fragments from bf16 tiles in shared memory (`base` a shared address, `ld`
// the row stride in elements). The A fragment of rows [m0, m0 + 16) and
// columns [k0, k0 + 16) of a tile stored [m][k], or stored [k][m]:
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], uint32_t base, int ld, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, base + ((m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + k0 + 8 * (lane >> 4)) * 2);
}
__device__ __forceinline__ void frag_a_t(uint32_t (&r)[4], uint32_t base, int ld, int m0,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, base + ((k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0 + 8 * ((lane >> 3) & 1)) * 2);
}
// The B fragments of the two n-tiles [n0, n0 + 8), [n0 + 8, n0 + 16) over
// k [k0, k0 + 16) (r[0], r[1] the first's, r[2], r[3] the second's), of a
// tile stored [n][k], or stored [k][n]:
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], uint32_t base, int ld, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, base + ((n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 8 * ((lane >> 3) & 1)) * 2);
}
// The B fragment of the one n-tile [n0, n0 + 8), of a tile stored [n][k]:
__device__ __forceinline__ void frag_b_x2(uint32_t (&r)[2], uint32_t base, int ld, int n0,
                                          int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x2(r, base + ((n0 + (lane & 7)) * ld + k0 + 8 * ((lane >> 3) & 1)) * 2);
}
__device__ __forceinline__ void frag_b_t(uint32_t (&r)[4], uint32_t base, int ld, int n0,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, base + ((k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0 + 8 * (lane >> 4)) * 2);
}

// (v0, v1) -> hi = bf16(v), lo = bf16(v - hi), each a packed pair, v0 in
// the low half.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// A register of two bf16 -> two floats, exactly; the low half first.
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
// Sums over the four lanes of a quad (one row of a C fragment), and over
// the eight quads (one column).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Lane l: cs_l, the forward kernel's inclusive Hillis-Steele scan of dt_l A
// over the tile; returns it, and cs_L in `last`.
__device__ __forceinline__ float tile_cumsum(float dt, float a, float& last) {
  const int lane = threadIdx.x & 31;
  float v = __fmul_rn(dt, a);
#pragma unroll
  for (int k = 1; k < 32; k *= 2) {
    const float o = __shfl_up_sync(0xffffffffu, v, k);
    if (lane >= k) v = __fadd_rn(o, v);
  }
  last = __shfl_sync(0xffffffffu, v, kTile - 1);
  return v;
}

struct Args {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* Bm;
  const __nv_bfloat16* Cm;
  const float* D;
  const __nv_bfloat16* dy;
  int S, H, G, T;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
      dy_sb, dy_ss, dy_sh;
};

// ---- 1. the two walks over the tiles --------------------------------------
template <int P, int N>
struct WalkLayout {
  static constexpr int kThreads = 32 * (P / 16);  // a warp per 16 state rows
  static constexpr int kSN = N + 8;  // bf16 row stride of the B or C tile
  static constexpr int kSP = P + 8;  // of the x or dy tile
  // bytes, within a stage
  static constexpr int kK = 0;  // B (forward walk) or C (reverse walk)
  static constexpr int kV = kK + kTile * kSN * 2;  // x or dy
  static constexpr int kDt = kV + kTile * kSP * 2;
  static constexpr int kStage = kDt + kTile * 4;
  // after the two stages: each warp's 16 rows of one plane, on their way out
  static constexpr int kOut = 2 * kStage;
  static constexpr int kOutWarp = 16 * kSN * 2;
  static constexpr int kBytes = kOut + (P / 16) * kOutWarp;
  static_assert(kStage % 16 == 0, "16-byte aligned stages");
};

// blockIdx.x: 0 the forward walk (the states entering each tile into
// ws_s), 1 the reverse walk (the state gradients leaving each into ws_d);
// each [B, H, T, 2 (hi, lo), P, N] bf16.
template <int P, int N>
__global__ void __launch_bounds__(WalkLayout<P, N>::kThreads)
ssd_bwd_walk_kernel(const Args a, __nv_bfloat16* __restrict__ ws_s,
                    __nv_bfloat16* __restrict__ ws_d) {
  using L = WalkLayout<P, N>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sbase = smem_u32(smem);
  const bool rev = blockIdx.x == 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (a.H / a.G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* vb =
      rev ? a.dy + b * a.dy_sb + h * a.dy_sh : a.x + b * a.x_sb + h * a.x_sh;
  const long long v_ss = rev ? a.dy_ss : a.x_ss;
  const __nv_bfloat16* kb =
      rev ? a.Cm + b * a.c_sb + grp * a.c_sg : a.Bm + b * a.b_sb + grp * a.b_sg;
  const long long k_ss = rev ? a.c_ss : a.b_ss;
  const float* dtb = a.dt + b * a.dt_sb + h * a.dt_sh;
  const float A = a.A[h];
  __nv_bfloat16* out =
      (rev ? ws_d : ws_s) + (static_cast<long long>(b) * a.H + h) * a.T * 2 * P * N;
  __nv_bfloat16* sOut = reinterpret_cast<__nv_bfloat16*>(smem + L::kOut + warp * L::kOutWarp);

  auto load_tile = [&](int tile, int stage) {
    const int s0 = tile * kTile;
    const uint32_t st = sbase + stage * L::kStage;
    for (int c = threadIdx.x; c < kTile * (N / 8); c += L::kThreads) {
      const int r = c / (N / 8), col = (c % (N / 8)) * 8;
      const bool in = s0 + r < a.S;
      const long long pos = in ? s0 + r : 0;
      cp_async16(st + L::kK + (r * L::kSN + col) * 2, kb + pos * k_ss + col, in);
    }
    for (int c = threadIdx.x; c < kTile * (P / 8); c += L::kThreads) {
      const int r = c / (P / 8), col = (c % (P / 8)) * 8;
      const bool in = s0 + r < a.S;
      const long long pos = in ? s0 + r : 0;
      cp_async16(st + L::kV + (r * L::kSP + col) * 2, vb + pos * v_ss + col, in);
    }
    if (threadIdx.x < kTile) {  // dt hard-masked past S
      const bool in = s0 + threadIdx.x < a.S;
      const long long pos = in ? s0 + threadIdx.x : 0;
      cp_async4(st + L::kDt + threadIdx.x * 4, dtb + pos * a.dt_ss, in);
    }
    cp_async_commit();
  };

  float st[N / 8][4];  // carry[16 warp + g (+8)][8 n + 2 t4 (+1)]
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
  float decay = 1.f;  // the tile's exp(cs_L)
  load_tile(rev ? a.T - 1 : 0, 0);
  for (int it = 0; it < a.T; ++it) {
    const int tile = rev ? a.T - 1 - it : it;
    const int stage = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; every warp is done with it - 1
    if (it + 1 < a.T) load_tile(rev ? tile - 1 : tile + 1, stage ^ 1);
    const uint32_t sst = sbase + stage * L::kStage;
    const float dtl = reinterpret_cast<const float*>(smem + stage * L::kStage + L::kDt)[lane];
    float last;
    const float cs = tile_cumsum(dtl, A, last);
    // the weight of position `lane`: exp(cs_L - cs) dt, or exp(cs)
    const float wv = rev ? expf(cs) : expf(last - cs) * dtl;

    // the carry, as hi / lo planes: the state entering `tile`, or the
    // gradient of the state leaving it. Each plane's 16 rows go through
    // this warp's part of shared memory, so that the stores are whole
    // 16-byte vectors along the rows.
    __nv_bfloat16* o =
        out + static_cast<long long>(tile) * 2 * P * N + 16 * warp * N;
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          uint32_t hi, lo;
          split2(st[n][2 * rr], st[n][2 * rr + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(sOut + (g + 8 * rr) * L::kSN + 8 * n + 2 * t4) =
              plane ? lo : hi;
        }
      __syncwarp();
#pragma unroll
      for (int c = lane; c < 16 * (N / 8); c += 32) {
        const int r = c / (N / 8), col = (c % (N / 8)) * 8;
        *reinterpret_cast<uint4*>(o + plane * P * N + r * N + col) =
            *reinterpret_cast<const uint4*>(sOut + r * L::kSN + col);
      }
      __syncwarp();
    }

    // carry <- carry exp(cs_L) + (v w)^T K, v w as hi + lo
    decay = expf(last);
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t vr[4];  // A fragment of v^T [p][j]: v stored [j][p]
      frag_a_t(vr, sst + L::kV, L::kSP, 16 * warp, 16 * kk);
      const float w0 = __shfl_sync(0xffffffffu, wv, 16 * kk + 2 * t4);
      const float w1 = __shfl_sync(0xffffffffu, wv, 16 * kk + 2 * t4 + 1);
      const float w2 = __shfl_sync(0xffffffffu, wv, 16 * kk + 2 * t4 + 8);
      const float w3 = __shfl_sync(0xffffffffu, wv, 16 * kk + 2 * t4 + 9);
      uint32_t vh[4], vl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = unpack_bf16x2(vr[e]);
        split2(v.x * (e < 2 ? w0 : w2), v.y * (e < 2 ? w1 : w3), vh[e], vl[e]);
      }
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bf[4];
        frag_b_t(bf, sst + L::kK, L::kSN, 16 * np, 16 * kk);
#pragma unroll
        for (int part = 0; part < kXwParts; ++part) {
          const uint32_t* af = part ? vl : vh;
          mma_16816(st[2 * np], af, bf[0], bf[1]);
          mma_16816(st[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
}

// ---- 2. each tile's gradients, a group's heads in order -------------------
// Columns of a [kTile, W] product each warp owns: kGroups groups of
// W / kGroups, at least 16 (then the groups past W sit out).
constexpr int cols(int W) { return W / kGroups < 16 ? 16 : W / kGroups; }

template <int P, int N>
struct GradLayout {
  static constexpr int kSN = N + 8;      // bf16 row stride of B, C and the planes
  static constexpr int kSP = P + 8;      // of x and dy
  static constexpr int kSQ = kTile + 8;  // of M and Q
  static constexpr int kCn = cols(N), kCp = cols(P);
  // bytes
  static constexpr int kB = 0;
  static constexpr int kC = kB + kTile * kSN * 2;
  static constexpr int kStages = kC + kTile * kSN * 2;
  // within a stage: x, dy, the planes S_in hi, lo, dS_out hi, lo, dt
  static constexpr int kX = 0;
  static constexpr int kDY = kX + kTile * kSP * 2;
  static constexpr int kPlanes = kDY + kTile * kSP * 2;
  static constexpr int kPlane = P * kSN * 2;
  static constexpr int kDt = kPlanes + 4 * kPlane;
  static constexpr int kStage = kDt + kTile * 4;
  // after the stages: M hi, M lo, Q hi, Q lo [kTile][kSQ]
  static constexpr int kMQ = kStages + 2 * kStage;
  static constexpr int kMat = kTile * kSQ * 2;
  // fp32 partial sums, kTile each: rowE [4], colF [2], v [P / kCp],
  // cu [N / kCn]; then each product warp's parts of <dS_out, S_in> and
  // x . dy
  static constexpr int kRowE = kMQ + 4 * kMat;
  static constexpr int kColF = kRowE + 4 * kTile * 4;
  static constexpr int kV = kColF + 2 * kTile * 4;
  static constexpr int kCu = kV + (P / kCp) * kTile * 4;
  static constexpr int kRed = kCu + (N / kCn) * kTile * 4;
  static constexpr int kBytes = kRed + 2 * kProductWarps * 4;
  static_assert(kStage % 16 == 0 && kStages % 16 == 0, "16-byte aligned stages");
};

// kIntraParts: the parts of M and Q in their products, 2 (hi + lo, the
// default) or 1 (bf16-intra: one bf16 rounding of each).
template <int P, int N, int kIntraParts>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_grad_kernel(const Args a, const __nv_bfloat16* __restrict__ ws_s,
                    const __nv_bfloat16* __restrict__ ws_d, __nv_bfloat16* __restrict__ dx,
                    float* __restrict__ ddt, __nv_bfloat16* __restrict__ dB,
                    __nv_bfloat16* __restrict__ dC, float* __restrict__ ws_da,
                    float* __restrict__ ws_dd) {
  using L = GradLayout<P, N>;
  constexpr int kCn = L::kCn, kCp = L::kCp;
  constexpr int kMParts = kIntraParts;  // M, in M^T dy
  constexpr int kQParts = kIntraParts;  // Q, in Q^T C and Q B
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sbase = smem_u32(smem);
  float* sRowE = reinterpret_cast<float*>(smem + L::kRowE);
  float* sColF = reinterpret_cast<float*>(smem + L::kColF);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sCu = reinterpret_cast<float*>(smem + L::kCu);
  float* sRed = reinterpret_cast<float*>(smem + L::kRed);  // [2][kProductWarps]
  const int t = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int hg = a.H / a.G;
  const int s0 = t * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const bool sums = warp == kProductWarps;  // the per-position sums' warp
  const int mi = warp & 1, nq = warp >> 1;  // rows 16 mi.., column group nq
  const int i0 = 16 * mi + g;               // this thread's rows: i0, i0 + 8
  const int j0 = 8 * nq + 2 * t4;           // its columns of q, G, M, Q: j0, j0 + 1
  const bool n_on = !sums && nq < N / kCn;  // the [kTile, N] products
  const bool p_on = !sums && nq < P / kCp;  // the [kTile, P] products
  const __nv_bfloat16* bb = a.Bm + b * a.b_sb + grp * a.b_sg;
  const __nv_bfloat16* cb = a.Cm + b * a.c_sb + grp * a.c_sg;

  // head `k` of the group into stage `stage`: x, dy, dt (zeros past S) and
  // its two states' planes
  auto load_head = [&](int k, int stage) {
    const int h = grp * hg + k;
    const uint32_t st = sbase + L::kStages + stage * L::kStage;
    const __nv_bfloat16* xb = a.x + b * a.x_sb + h * a.x_sh;
    const __nv_bfloat16* dyb = a.dy + b * a.dy_sb + h * a.dy_sh;
    for (int c = threadIdx.x; c < kTile * (P / 8); c += kThreads) {
      const int r = c / (P / 8), col = (c % (P / 8)) * 8;
      const bool in = s0 + r < a.S;
      const long long pos = in ? s0 + r : 0;
      const uint32_t off = (r * L::kSP + col) * 2;
      cp_async16(st + L::kX + off, xb + pos * a.x_ss + col, in);
      cp_async16(st + L::kDY + off, dyb + pos * a.dy_ss + col, in);
    }
    const long long bht = (static_cast<long long>(b) * a.H + h) * a.T + t;
    const __nv_bfloat16* ps = ws_s + bht * 2 * P * N;
    const __nv_bfloat16* pd = ws_d + bht * 2 * P * N;
    for (int c = threadIdx.x; c < 2 * P * (N / 8); c += kThreads) {
      const int r = c / (N / 8), col = (c % (N / 8)) * 8;  // row r of 2P: plane r / P
      const uint32_t off = (r * L::kSN + col) * 2;
      cp_async16(st + L::kPlanes + off, ps + r * N + col, true);
      cp_async16(st + L::kPlanes + 2 * L::kPlane + off, pd + r * N + col, true);
    }
    if (threadIdx.x < kTile) {
      const bool in = s0 + threadIdx.x < a.S;
      const long long pos = in ? s0 + threadIdx.x : 0;
      cp_async4(st + L::kDt + threadIdx.x * 4,
                a.dt + b * a.dt_sb + h * a.dt_sh + pos * a.dt_ss, in);
    }
    cp_async_commit();
  };

  for (int c = threadIdx.x; c < kTile * (N / 8); c += kThreads) {
    const int r = c / (N / 8), col = (c % (N / 8)) * 8;
    const bool in = s0 + r < a.S;
    const long long pos = in ? s0 + r : 0;
    const uint32_t off = (r * L::kSN + col) * 2;
    cp_async16(sbase + L::kB + off, bb + pos * a.b_ss + col, in);
    cp_async16(sbase + L::kC + off, cb + pos * a.c_ss + col, in);
  }
  load_head(0, 0);  // one group with B and C

  float gm[4];  // G for rows i0 (+8), columns j0 (+1)
  float sum_db[kCn / 8][4], sum_dc[kCn / 8][4];  // the cross-head sums
#pragma unroll
  for (int n = 0; n < kCn / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum_db[n][e] = sum_dc[n][e] = 0.f;

  for (int kh = 0; kh < hg; ++kh) {
    const int h = grp * hg + kh;
    const int stage = kh & 1;
    const uint32_t st = sbase + L::kStages + stage * L::kStage;
    const uint32_t sPl = st + L::kPlanes;  // S_in hi, lo, dS_out hi, lo
    const uint8_t* stp = smem + L::kStages + stage * L::kStage;
    const __nv_bfloat16* sX = reinterpret_cast<const __nv_bfloat16*>(stp + L::kX);
    const __nv_bfloat16* sDY = reinterpret_cast<const __nv_bfloat16*>(stp + L::kDY);
    cp_async_wait_all();
    __syncthreads();  // head kh landed; every warp is done with head kh - 1
    if (kh + 1 < hg) load_head(kh + 1, stage ^ 1);

    if (kh == 0 && !sums) {  // G = C B^T, once
#pragma unroll
      for (int e = 0; e < 4; ++e) gm[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t af[4], bf[2];
        frag_a(af, sbase + L::kC, L::kSN, 16 * mi, 16 * kk);
        frag_b_x2(bf, sbase + L::kB, L::kSN, 8 * nq, 16 * kk);
        mma_16816(gm, af, bf[0], bf[1]);
      }
    }
    // lane l: position l's dt, cs, exp(cs), exp(cs_L - cs) dt
    const float A = a.A[h];
    const float dtl = reinterpret_cast<const float*>(stp + L::kDt)[lane];
    float last;
    const float cs = tile_cumsum(dtl, A, last);
    const float ecs = expf(cs);
    const float wl = expf(last - cs) * dtl;
    // this thread's rows' exp(cs_i) and exp(cs_L - cs_j) dt_j
    const float ecs_r[2] = {__shfl_sync(0xffffffffu, ecs, i0),
                            __shfl_sync(0xffffffffu, ecs, i0 + 8)};
    const float wl_r[2] = {__shfl_sync(0xffffffffu, wl, i0),
                           __shfl_sync(0xffffffffu, wl, i0 + 8)};
    float xdy = 0.f;  // this tile's part of dD: the diagonal of q

    if (!sums) {  // q = dy x^T; M, Q (hi / lo into shared memory), F's sums
      float qv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t af[4], bf[2];
        frag_a(af, st + L::kDY, L::kSP, 16 * mi, 16 * kk);
        frag_b_x2(bf, st + L::kX, L::kSP, 8 * nq, 16 * kk);
        mma_16816(qv, af, bf[0], bf[1]);
      }
      const float cs_i[2] = {__shfl_sync(0xffffffffu, cs, i0),
                             __shfl_sync(0xffffffffu, cs, i0 + 8)};
      float m[2][2], qq[2][2], row_e[2] = {0.f, 0.f}, col_f[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + c;
        const float cs_j = __shfl_sync(0xffffffffu, cs, j);
        const float dt_j = __shfl_sync(0xffffffffu, dtl, j);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = i0 + 8 * rr, e = 2 * rr + c;
          const float w = j <= i ? expf(cs_i[rr] - cs_j) : 0.f;
          const float gw = gm[e] * w;
          const float f = gw * qv[e];
          m[rr][c] = gw * dt_j;
          qq[rr][c] = w * dt_j * qv[e];
          row_e[rr] += f * dt_j;
          col_f[c] += f;
          if (i == j) xdy += qv[e];
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int off = ((i0 + 8 * rr) * L::kSQ + j0) * 2;
        uint32_t hi, lo;
        split2(m[rr][0], m[rr][1], hi, lo);
        *reinterpret_cast<uint32_t*>(smem + L::kMQ + off) = hi;
        if (kMParts == 2) *reinterpret_cast<uint32_t*>(smem + L::kMQ + L::kMat + off) = lo;
        split2(qq[rr][0], qq[rr][1], hi, lo);
        *reinterpret_cast<uint32_t*>(smem + L::kMQ + 2 * L::kMat + off) = hi;
        if (kQParts == 2)
          *reinterpret_cast<uint32_t*>(smem + L::kMQ + 3 * L::kMat + off) = lo;
        const float s = quad_sum(row_e[rr]);
        if (t4 == 0) sRowE[nq * kTile + i0 + 8 * rr] = s;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float s = column_sum(col_f[c]);
        if (g == 0) sColF[mi * kTile + j0 + c] = s;
      }
    }

    // the head's dC_i = exp(cs_i) S_in^T dy_i (+ Q B below) and dB_j =
    // exp(cs_L - cs_j) dt_j dS_out^T x_j (+ Q^T C below), with C_k . U_k;
    // and <dS_out, S_in> from the same fragments of the planes, each
    // element once: the row half mi takes the k-steps with kk mod 2 = mi
    float dc[kCn / 8][4], db[kCn / 8][4], dot = 0.f;
#pragma unroll
    for (int n = 0; n < kCn / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dc[n][e] = db[n][e] = 0.f;
    if (n_on) {
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t ady[4], ax[4];
        frag_a(ady, st + L::kDY, L::kSP, 16 * mi, 16 * kk);
        frag_a(ax, st + L::kX, L::kSP, 16 * mi, 16 * kk);
#pragma unroll
        for (int np = 0; np < kCn / 16; ++np) {
          uint32_t bs[kStateParts][4], bd[kStateParts][4];
#pragma unroll
          for (int part = 0; part < kStateParts; ++part) {
            frag_b_t(bs[part], sPl + part * L::kPlane, L::kSN, kCn * nq + 16 * np, 16 * kk);
            frag_b_t(bd[part], sPl + (2 + part) * L::kPlane, L::kSN, kCn * nq + 16 * np,
                     16 * kk);
            mma_16816(dc[2 * np], ady, bs[part][0], bs[part][1]);
            mma_16816(dc[2 * np + 1], ady, bs[part][2], bs[part][3]);
            mma_16816(db[2 * np], ax, bd[part][0], bd[part][1]);
            mma_16816(db[2 * np + 1], ax, bd[part][2], bd[part][3]);
          }
          if ((kk & 1) == mi) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float2 sv = make_float2(0.f, 0.f), dv = sv;
#pragma unroll
              for (int part = 0; part < kStateParts; ++part) {
                const float2 s1 = unpack_bf16x2(bs[part][r]), d1 = unpack_bf16x2(bd[part][r]);
                sv.x += s1.x; sv.y += s1.y;
                dv.x += d1.x; dv.y += d1.y;
              }
              dot = fmaf(sv.x, dv.x, dot);
              dot = fmaf(sv.y, dv.y, dot);
            }
          }
        }
      }
      const __nv_bfloat16* sC = reinterpret_cast<const __nv_bfloat16*>(smem + L::kC);
      float cu[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kCn / 8; ++n)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int col = kCn * nq + 8 * n + 2 * t4;
          const float2 cv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sC + (i0 + 8 * rr) * L::kSN + col));
          cu[rr] = fmaf(cv.x, dc[n][2 * rr], cu[rr]);
          cu[rr] = fmaf(cv.y, dc[n][2 * rr + 1], cu[rr]);
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float s = quad_sum(cu[rr]);
        if (t4 == 0) sCu[nq * kTile + i0 + 8 * rr] = s;
      }
#pragma unroll
      for (int n = 0; n < kCn / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dc[n][e] *= ecs_r[e >> 1];
          db[n][e] *= wl_r[e >> 1];
        }
    }

    // dS_out B_j [kTile x P], with v_j = x_j . (dS_out B_j)
    float sb[kCp / 8][4];
#pragma unroll
    for (int n = 0; n < kCp / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[n][e] = 0.f;
    if (p_on) {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t af[4];
        frag_a(af, sbase + L::kB, L::kSN, 16 * mi, 16 * kk);
#pragma unroll
        for (int np = 0; np < kCp / 16; ++np) {
#pragma unroll
          for (int part = 0; part < kStateParts; ++part) {
            uint32_t bf[4];
            frag_b(bf, sPl + (2 + part) * L::kPlane, L::kSN, kCp * nq + 16 * np, 16 * kk);
            mma_16816(sb[2 * np], af, bf[0], bf[1]);
            mma_16816(sb[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      }
      float v[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kCp / 8; ++n)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              sX + (i0 + 8 * rr) * L::kSP + kCp * nq + 8 * n + 2 * t4));
          v[rr] = fmaf(xv.x, sb[n][2 * rr], v[rr]);
          v[rr] = fmaf(xv.y, sb[n][2 * rr + 1], v[rr]);
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float s = quad_sum(v[rr]);
        if (t4 == 0) sV[nq * kTile + i0 + 8 * rr] = s;
      }
    }

    if (!sums) {
      dot = warp_sum(dot);
      xdy = warp_sum(xdy);
      if (lane == 0) {
        sRed[warp] = dot;
        sRed[kProductWarps + warp] = xdy;
      }
    }
    __syncthreads();  // M, Q and the partial sums are in

    if (sums) {  // lane k: dcs, da, ddt; dA's and dD's tile partials
      const int k = lane;
      float v = 0.f, cu = 0.f, row_e = 0.f, dot_all = 0.f, xdy_all = 0.f;
#pragma unroll
      for (int c = 0; c < P / kCp; ++c) v += sV[c * kTile + k];
#pragma unroll
      for (int c = 0; c < N / kCn; ++c) cu += sCu[c * kTile + k];
#pragma unroll
      for (int c = 0; c < kGroups; ++c) row_e += sRowE[c * kTile + k];
      const float col_f = sColF[k] + sColF[kTile + k];
#pragma unroll
      for (int w = 0; w < kProductWarps; ++w) {
        dot_all += sRed[w];
        xdy_all += sRed[kProductWarps + w];
      }
      const float wv = wl * v;
      float dcs = row_e - dtl * col_f + ecs * cu - wv;
      const float wv_all = warp_sum(wv);
      if (k == kTile - 1) dcs += expf(last) * dot_all + wv_all;
      float da = dcs;  // suffix sum: da_k = sum_{m >= k} dcs_m
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_down_sync(0xffffffffu, da, off);
        if (k + off < 32) da += o;
      }
      const float gr = A * da + col_f + expf(last - cs) * v;
      if (s0 + k < a.S) ddt[(static_cast<long long>(b) * a.S + s0 + k) * a.H + h] = gr;
      const float da_sum = warp_sum(dtl * da);
      if (k == 0) {
        const long long bht = (static_cast<long long>(b) * a.H + h) * a.T + t;
        ws_da[bht] = da_sum;
        ws_dd[bht] = xdy_all;
      }
    }

    // dx_j = sum_i M_ij dy_i + exp(cs_L - cs_j) dt_j dS_out B_j + D dy_j
    if (p_on) {
#pragma unroll
      for (int n = 0; n < kCp / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sb[n][e] *= wl_r[e >> 1];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t af[kMParts][4];  // A fragments of M^T [j][i]: M stored [i][j]
#pragma unroll
        for (int part = 0; part < kMParts; ++part)
          frag_a_t(af[part], sbase + L::kMQ + part * L::kMat, L::kSQ, 16 * mi, 16 * kk);
#pragma unroll
        for (int np = 0; np < kCp / 16; ++np) {
          uint32_t bf[4];
          frag_b_t(bf, st + L::kDY, L::kSP, kCp * nq + 16 * np, 16 * kk);
#pragma unroll
          for (int part = 0; part < kMParts; ++part) {
            mma_16816(sb[2 * np], af[part], bf[0], bf[1]);
            mma_16816(sb[2 * np + 1], af[part], bf[2], bf[3]);
          }
        }
      }
      const float d_skip = a.D[h];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = i0 + 8 * rr;
        if (s0 + j >= a.S) continue;
        __nv_bfloat16* row = dx + ((static_cast<long long>(b) * a.S + s0 + j) * a.H + h) * P;
#pragma unroll
        for (int n = 0; n < kCp / 8; ++n) {
          const int p = kCp * nq + 8 * n + 2 * t4;
          const float2 dv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sDY + j * L::kSP + p));
          *reinterpret_cast<__nv_bfloat162*>(row + p) = __floats2bfloat162_rn(
              sb[n][2 * rr] + d_skip * dv.x, sb[n][2 * rr + 1] + d_skip * dv.y);
        }
      }
    }
    // dB_j += sum_i Q_ij C_i, dC_i += sum_j Q_ij B_j; then into the sums
    if (n_on) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t aqt[kQParts][4], aq[kQParts][4];  // Q^T [j][i] and Q [i][j]
#pragma unroll
        for (int part = 0; part < kQParts; ++part) {
          frag_a_t(aqt[part], sbase + L::kMQ + (2 + part) * L::kMat, L::kSQ, 16 * mi, 16 * kk);
          frag_a(aq[part], sbase + L::kMQ + (2 + part) * L::kMat, L::kSQ, 16 * mi, 16 * kk);
        }
#pragma unroll
        for (int np = 0; np < kCn / 16; ++np) {
          uint32_t bc[4], bbf[4];
          frag_b_t(bc, sbase + L::kC, L::kSN, kCn * nq + 16 * np, 16 * kk);
          frag_b_t(bbf, sbase + L::kB, L::kSN, kCn * nq + 16 * np, 16 * kk);
#pragma unroll
          for (int part = 0; part < kQParts; ++part) {
            mma_16816(db[2 * np], aqt[part], bc[0], bc[1]);
            mma_16816(db[2 * np + 1], aqt[part], bc[2], bc[3]);
            mma_16816(dc[2 * np], aq[part], bbf[0], bbf[1]);
            mma_16816(dc[2 * np + 1], aq[part], bbf[2], bbf[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kCn / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum_db[n][e] += db[n][e];
          sum_dc[n][e] += dc[n][e];
        }
    }
  }

  // dB, dC: the group's sums, once
  if (n_on) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = i0 + 8 * rr;
      if (s0 + i >= a.S) continue;
      const long long o = ((static_cast<long long>(b) * a.S + s0 + i) * a.G + grp) * N;
#pragma unroll
      for (int n = 0; n < kCn / 8; ++n) {
        const int col = kCn * nq + 8 * n + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(dB + o + col) =
            __floats2bfloat162_rn(sum_db[n][2 * rr], sum_db[n][2 * rr + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dC + o + col) =
            __floats2bfloat162_rn(sum_dc[n][2 * rr], sum_dc[n][2 * rr + 1]);
      }
    }
  }
}

// ---- 3. dA, dD: each head's tile partials summed over (batch, tile) -----
// A warp per head: lane l adds the partials l, l + 32, ... in order, then
// the lanes' sums meet in a fixed butterfly.
__global__ void ssd_bwd_head_sum_kernel(const float* __restrict__ ws_da,
                                        const float* __restrict__ ws_dd,
                                        float* __restrict__ dA, float* __restrict__ dD,
                                        int Bsz, int H, int T) {
  const int h = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (h >= H) return;
  float sa = 0.f, sd = 0.f;
  for (int i = lane; i < Bsz * T; i += 32) {
    const long long o = (static_cast<long long>(i / T) * H + h) * T + i % T;
    sa += ws_da[o];
    sd += ws_dd[o];
  }
  sa = warp_sum(sa);
  sd = warp_sum(sd);
  if (lane == 0) {
    dA[h] = sa;
    dD[h] = sd;
  }
}

// The workspace's parts, in floats, in this order: the two states' hi / lo
// planes [B, H, T, 2, P, N] bf16 (as many bytes as fp32 [B, H, T, P, N]),
// dA and dD per tile [B, H, T].
struct Workspace {
  long long states, bht;
  Workspace(int Bsz, int S, int H, int P, int N) {
    const long long T = (S + kTile - 1) / kTile;
    states = static_cast<long long>(Bsz) * H * T * P * N;
    bht = static_cast<long long>(Bsz) * H * T;
  }
  long long floats() const { return 2 * states + 2 * bht; }
};

template <int P, int N, int kIntraParts>
int launch(const Args& a, int Bsz, __nv_bfloat16* dx, float* ddt, float* dA,
           __nv_bfloat16* dB, __nv_bfloat16* dC, float* dD, float* ws, cudaStream_t stream) {
  using WL = WalkLayout<P, N>;
  using GL = GradLayout<P, N>;
  const Workspace w(Bsz, a.S, a.H, P, N);
  auto* ws_s = reinterpret_cast<__nv_bfloat16*>(ws);
  auto* ws_d = reinterpret_cast<__nv_bfloat16*>(ws + w.states);
  float* ws_da = ws + 2 * w.states;
  float* ws_dd = ws_da + w.bht;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_walk_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, WL::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_grad_kernel<P, N, kIntraParts>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, GL::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_walk_kernel<P, N><<<dim3(2, a.H, Bsz), WL::kThreads, WL::kBytes, stream>>>(a, ws_s,
                                                                                     ws_d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_grad_kernel<P, N, kIntraParts><<<dim3(a.T, a.G, Bsz), kThreads, GL::kBytes, stream>>>(
      a, ws_s, ws_d, dx, ddt, dB, dC, ws_da, ws_dd);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_sum_kernel<<<(a.H + 3) / 4, 128, 0, stream>>>(ws_da, ws_dd, dA, dD, Bsz,
                                                             a.H, a.T);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int kIntraParts>
int launch_p(int N, const Args& a, int Bsz, __nv_bfloat16* dx, float* ddt, float* dA,
             __nv_bfloat16* dB, __nv_bfloat16* dC, float* dD, float* ws,
             cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<P, 16, kIntraParts>(a, Bsz, dx, ddt, dA, dB, dC, dD, ws, stream);
    case 64:
      return launch<P, 64, kIntraParts>(a, Bsz, dx, ddt, dA, dB, dC, dD, ws, stream);
    case 128:
      return launch<P, 128, kIntraParts>(a, Bsz, dx, ddt, dA, dB, dC, dD, ws, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Bytes of fp32 workspace repro_ssd_chunked_bwd_bf16 needs for these
// shapes.
extern "C" long long repro_ssd_chunked_bwd_workspace_bytes(int Bsz, int S, int H, int P,
                                                           int N) {
  return 4 * Workspace(Bsz, S, H, P, N).floats();
}

// Inputs as repro_ssd_chunked_fwd_bf16's, with dy [B, S, H, P] bf16 like x
// (its own strides). Outputs, contiguous: dx [B, S, H, P] bf16, ddt
// [B, S, H] fp32, dA, dD [H] fp32, dB, dC [B, S, G, N] bf16. `workspace`:
// repro_ssd_chunked_bwd_workspace_bytes of scratch, 16-byte aligned.
// m_parts: 2 (M and Q as hi + lo) or 1 (the bf16-intra instance, the
// gradient of the forward's); any other is cudaErrorInvalidValue.
// Returns a cudaError_t.
extern "C" int repro_ssd_chunked_bwd_bf16(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* D, const void* dy, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* dD, void* workspace, int Bsz, int S, int H, int P, int G, int N,
    const long long* x_strides, const long long* dt_strides, const long long* b_strides,
    const long long* c_strides, const long long* dy_strides, int m_parts, void* stream) {
  if (S < 1 || G < 1 || H % G != 0 || (m_parts != 1 && m_parts != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool one_part = m_parts == 1;  // the bf16-intra instance
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const float*>(dt),
               static_cast<const float*>(A),
               static_cast<const __nv_bfloat16*>(Bm),
               static_cast<const __nv_bfloat16*>(Cm),
               static_cast<const float*>(D),
               static_cast<const __nv_bfloat16*>(dy),
               S, H, G, (S + kTile - 1) / kTile,
               x_strides[0], x_strides[1], x_strides[2],
               dt_strides[0], dt_strides[1], dt_strides[2],
               b_strides[0], b_strides[1], b_strides[2],
               c_strides[0], c_strides[1], c_strides[2],
               dy_strides[0], dy_strides[1], dy_strides[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* odx = static_cast<__nv_bfloat16*>(dx);
  auto* oddt = static_cast<float*>(ddt);
  auto* odA = static_cast<float*>(dA);
  auto* odB = static_cast<__nv_bfloat16*>(dB);
  auto* odC = static_cast<__nv_bfloat16*>(dC);
  auto* odD = static_cast<float*>(dD);
  auto* ws = static_cast<float*>(workspace);
  if (P == 32)
    return one_part ? launch_p<32, 1>(N, a, Bsz, odx, oddt, odA, odB, odC, odD, ws, s)
                    : launch_p<32, 2>(N, a, Bsz, odx, oddt, odA, odB, odC, odD, ws, s);
  if (P == 64)
    return one_part ? launch_p<64, 1>(N, a, Bsz, odx, oddt, odA, odB, odC, odD, ws, s)
                    : launch_p<64, 2>(N, a, Bsz, odx, oddt, odA, odB, odC, odD, ws, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
