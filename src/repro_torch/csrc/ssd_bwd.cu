// Mamba2 SSD chunked scan, backward, for Hopper (sm_90a): bf16 x/B/C/dy,
// fp32 dt/A/D; fp32 arithmetic throughout; bf16 dx/dB/dC, fp32 ddt/dA/dD.
//
// No TPU kernel had a backward: this replaces `jax.grad` of the pure-jnp
// `ssd_chunked` (src/repro/models/ssm.py:37), the gradient of what the
// forward kernel csrc/ssd.cu computes. With the forward's tiles of kTile =
// 32 positions and, per (batch, head) and tile, cs the within-tile
// inclusive cumulative sum of a_j = dt_j A, cs_L its last entry, S_in the
// state entering the tile and dS_out the gradient of the state leaving it:
//   G_ij = C_i . B_j,  q_ij = dy_i . x_j,  w_ij = exp(cs_i - cs_j)  (j <= i)
//   dx_j  = sum_{i>=j} G_ij w_ij dt_j dy_i + exp(cs_L - cs_j) dt_j dS_out B_j
//           + D dy_j
//   dB_j  = sum_{i>=j} w_ij dt_j q_ij C_i + exp(cs_L - cs_j) dt_j dS_out^T x_j
//   dC_i  = sum_{j<=i} w_ij dt_j q_ij B_j + exp(cs_i) S_in^T dy_i
//   dcs_k = sum_j e_kj - sum_i e_ik + exp(cs_k) C_k . (S_in^T dy_k)
//           - exp(cs_L - cs_k) dt_k v_k, e_ij = G_ij w_ij dt_j q_ij,
//           v_k = x_k . (dS_out B_k); at k = kTile - 1 also
//           exp(cs_L) <dS_out, S_in> + sum_j exp(cs_L - cs_j) dt_j v_j
//   da_j  = sum_{k>=j} dcs_k;  ddt_j = A da_j + sum_{i>=j} G_ij w_ij q_ij
//           + exp(cs_L - cs_j) v_j;  dA = sum dt_j da_j;  dD = sum dy . x
//   dS_in = exp(cs_L) dS_out + sum_i exp(cs_i) dy_i C_i^T (the tile before's
//           dS_out)
// dB and dC are summed over the heads of B's group, dA and dD over (batch,
// position). The final state's gradient is not an input (the train path
// drops the state), so the last tile's dS_out is zero. Positions at or
// past S read zeros (dt = 0 among them), so every term they touch is zero
// and nothing is written for them. exp(cs_i - cs_j) is formed only for
// j <= i, where it is at most 1: above the diagonal it can overflow.
//
// Design: chunk-parallel, in five launches, deterministic (no atomics;
// every sum has a fixed order, so two calls give the same bits):
//   1. ssd_bwd_chunk_kernel, one block per (tile, head, batch): the tile's
//      own contributions to the state, sum_j exp(cs_L - cs_j) dt_j x_j B_j^T,
//      and to the state gradient, sum_i exp(cs_i) dy_i C_i^T, into a
//      workspace [B, H, T, P, N] each, and exp(cs_L).
//   2. ssd_bwd_scan_kernel, one thread per (batch, head, p, n): a forward
//      walk over the tiles turns the first into the state entering each
//      tile, a reverse walk the second into the gradient leaving each, in
//      place.
//   3. ssd_bwd_grad_kernel, one block per (tile, head, batch): everything
//      above from the tile's inputs and its two states; dx and ddt to the
//      outputs, dB/dC per head and dA/dD per tile into the workspace.
//   4. ssd_bwd_group_sum_kernel: dB, dC summed over each group's heads in
//      head order.
//   5. ssd_bwd_head_sum_kernel: dA, dD summed over (batch, tile) in order.
//
// What bounds it. At the training shape (B = 8, S = 2048, H = 32, P = 64,
// N = 128, G = 1) the compulsory traffic is reading x, dy (67.1 MB each),
// B, C (4.2 MB each) and dt (2.1 MB) and writing dx (67.1 MB), dB, dC and
// ddt: 222 MB, 66 us at 3.35 TB/s. The least work (chip_smoke.py's
// ssd_bwd_flops) is ~50 GFLOP: the tiles' triangles and, per position and
// head, five [P, N] products (the state recomputed, S_in^T dy, dS_out B,
// dS_out^T x, the state gradient's update). On bf16 tensor cores that is
// ~50 us, so the bound is bytes; this first version runs its products as
// fp32 FMA on the CUDA cores (67 TFLOP/s: 0.74 ms), with the per-tile
// workspace of both states (2 x 537 MB at the training shape) written
// once and read twice. Tensor cores (`mma.sync` with the forward's hi/lo
// splits) and a coarser state workspace are later work.
//   - Blocks of 256 threads; each product is a register-tiled loop over
//     fp32 operands in shared memory (row strides padded so the column
//     reads hit distinct banks), float4 along the contraction.
//   - The grad kernel's shared memory (P = 64, N = 128): x, dy, B, C as
//     fp32 tiles (51,200 bytes), one [P, N] state buffer (33,024; S_in,
//     then dS_out over it), M^T, Q, Q^T (13,824) and per-position vectors:
//     100,544 bytes, so two blocks share an SM at up to 128 registers.
//
// Error budget. Every product is of exact fp32 values (bf16 inputs
// widened) summed in fp32, as autograd of the fp32 chunked scan sums them,
// in another order: ~2^-24 relative per term. The state and its gradient
// are carried in fp32 across tiles, as the reference carries them across
// chunks. dx, dB and dC are rounded once to bf16 (2^-9 relative). dcs is a
// difference of sums and da its suffix sum within one tile (32 terms),
// against the reference's chunk of 256. Emulated on the CPU
// (kernels/ref.py::ssd_backward_tiles) every output agrees with jax.grad
// to ~1e-5 relative (tests/test_torch_train_ssm.py); chip_smoke.py holds
// the kernel to autograd of the plain version by the worst row at 2e-2.
//
// Every C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // positions per tile: csrc/ssd.cu's kTile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared-memory layout in floats. Rows of x, dy (kSX), B, C (kSB) and the
// 32 x 32 products (kSQ) are multiples of 4 floats, so float4 reads along
// them are aligned; the state's rows (kSS) are odd, so a warp reading one
// column of it hits 32 banks.
template <int P, int N>
struct Smem {
  static constexpr int kSX = P + 4;
  static constexpr int kSB = N + 4;
  static constexpr int kSS = N + 1;
  static constexpr int kSQ = kTile + 4;
  static constexpr int kX = 0;
  static constexpr int kDY = kX + kTile * kSX;
  static constexpr int kB = kDY + kTile * kSX;
  static constexpr int kC = kB + kTile * kSB;
  static constexpr int kTiles = kC + kTile * kSB;  // end of the four tiles
  // per-position vectors, kTile floats each, at kVec + kTile * index
  enum { kDt, kCs, kEcs, kWl, kRowE, kNVec };
  // the chunk kernel: the tiles and the vectors
  static constexpr int kChunkVec = kTiles;
  static constexpr int kChunkFloats = kChunkVec + kNVec * kTile;
  // the grad kernel: the state, M^T, Q, Q^T, the vectors, partial sums
  static constexpr int kS = kTiles;
  static constexpr int kMT = kS + ((P * kSS + 3) / 4) * 4;
  static constexpr int kQ = kMT + kTile * kSQ;
  static constexpr int kQT = kQ + kTile * kSQ;
  static constexpr int kVec = kQT + kTile * kSQ;
  static constexpr int kColF = kVec + kNVec * kTile;          // [kWarps][kTile]
  static constexpr int kPartV = kColF + kWarps * kTile;       // [P / 32][kTile]
  static constexpr int kPartU = kPartV + (P / 32) * kTile;    // [groups][kTile]
  static constexpr int kRed = kPartU + (N >= 32 ? N / 32 : 1) * kTile;
  static constexpr int kGradFloats = kRed + 2 * kWarps;
  static_assert(kSX % 4 == 0 && kSB % 4 == 0 && kMT % 4 == 0, "aligned rows");
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A register of two bf16 -> two floats, exactly; the low half first.
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// Rows [s0, s0 + kTile) of a bf16 slice [., W] (row stride `rs` elements,
// 16-byte aligned rows) into fp32 shared rows of stride `ld`; zeros at
// positions >= S.
template <int W>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const __nv_bfloat16* src,
                                          long long rs, int s0, int S) {
  for (int c = threadIdx.x; c < kTile * (W / 8); c += kThreads) {
    const int r = c / (W / 8), col = (c % (W / 8)) * 8;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (s0 + r < S) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(src + static_cast<long long>(s0 + r) * rs + col);
      const float2 a = unpack_bf16x2(v.x), b = unpack_bf16x2(v.y);
      const float2 c2 = unpack_bf16x2(v.z), d = unpack_bf16x2(v.w);
      lo = make_float4(a.x, a.y, b.x, b.y);
      hi = make_float4(c2.x, c2.y, d.x, d.y);
    }
    *reinterpret_cast<float4*>(dst + r * ld + col) = lo;
    *reinterpret_cast<float4*>(dst + r * ld + col + 4) = hi;
  }
}

// dt over the tile, zero past S; threads [0, kTile).
__device__ __forceinline__ void load_dt(float* dst, const float* dtb,
                                        long long dt_ss, int s0, int S) {
  if (threadIdx.x < kTile) {
    const int s = s0 + threadIdx.x;
    dst[threadIdx.x] = s < S ? dtb[static_cast<long long>(s) * dt_ss] : 0.f;
  }
}

// Warp 0: cs_l (the forward kernel's inclusive Hillis-Steele scan of
// dt_l A), exp(cs_l) and exp(cs_L - cs_l) dt_l; lane l holds position l.
__device__ __forceinline__ void tile_cumsum(const float* sDt, float a, float* sCs,
                                            float* sEcs, float* sWl) {
  const int lane = threadIdx.x;
  float v = __fmul_rn(sDt[lane], a);
#pragma unroll
  for (int k = 1; k < 32; k *= 2) {
    const float o = __shfl_up_sync(0xffffffffu, v, k);
    if (lane >= k) v = __fadd_rn(o, v);
  }
  const float last = __shfl_sync(0xffffffffu, v, 31);
  sCs[lane] = v;
  sEcs[lane] = expf(v);
  sWl[lane] = expf(last - v) * sDt[lane];
}

// out[i][w] += sum_k A[i][k] Bm(k, w) for a [kTile x W] output: this
// thread's column w = tid % W and rows i = tid / W + (kThreads / W) r.
// A is row-major in shared memory (stride lda, read as float4 along k);
// Bm(k, w) = bm[k * bk + w * bw]. k runs in order, one fmaf chain per
// output.
template <int W, int K>
__device__ __forceinline__ void gemm_rows(float (&acc)[kTile * W / kThreads],
                                          const float* A, int lda, const float* bm,
                                          int bk, int bw) {
  constexpr int R = kTile * W / kThreads;
  constexpr int kStep = kThreads / W;
  const int w = threadIdx.x % W, i0 = threadIdx.x / W;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const float b0 = bm[k * bk + w * bw], b1 = bm[(k + 1) * bk + w * bw];
    const float b2 = bm[(k + 2) * bk + w * bw], b3 = bm[(k + 3) * bk + w * bw];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + (i0 + kStep * r) * lda + k);
      acc[r] = fmaf(a.x, b0, acc[r]);
      acc[r] = fmaf(a.y, b1, acc[r]);
      acc[r] = fmaf(a.z, b2, acc[r]);
      acc[r] = fmaf(a.w, b3, acc[r]);
    }
  }
}

// sum_w acc[r] * A[i][w] over each of this thread's rows (gemm_rows's
// layout), across the threads that share them: a butterfly within each
// group of min(W, 32) lanes, then one partial per group of 32 columns into
// part[group * kTile + i].
template <int W>
__device__ __forceinline__ void row_partials(const float (&acc)[kTile * W / kThreads],
                                             const float* A, int lda, float* part) {
  constexpr int R = kTile * W / kThreads;
  constexpr int kStep = kThreads / W;
  constexpr int kSpan = W < 32 ? W : 32;
  const int w = threadIdx.x % W, i0 = threadIdx.x / W;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + kStep * r;
    float v = acc[r] * A[i * lda + w];
#pragma unroll
    for (int off = kSpan / 2; off > 0; off /= 2)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (threadIdx.x % kSpan == 0) part[(w / kSpan) * kTile + i] = v;
  }
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
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss,
      c_sg, dy_sb, dy_ss, dy_sh;
};

// ---- 1. each tile's own contributions to the state and its gradient -----
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const Args a, float* __restrict__ ws_s, float* __restrict__ ws_d,
                     float* __restrict__ ws_decay) {
  using L = Smem<P, N>;
  extern __shared__ __align__(16) float sm[];
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (a.H / a.G);
  const int s0 = t * kTile;
  float* sX = sm + L::kX;
  float* sDY = sm + L::kDY;
  float* sDt = sm + L::kChunkVec + kTile * L::kDt;
  float* sCs = sm + L::kChunkVec + kTile * L::kCs;
  float* sEcs = sm + L::kChunkVec + kTile * L::kEcs;
  float* sWl = sm + L::kChunkVec + kTile * L::kWl;
  load_rows<P>(sX, L::kSX, a.x + b * a.x_sb + h * a.x_sh, a.x_ss, s0, a.S);
  load_rows<P>(sDY, L::kSX, a.dy + b * a.dy_sb + h * a.dy_sh, a.dy_ss, s0, a.S);
  load_rows<N>(sm + L::kB, L::kSB, a.Bm + b * a.b_sb + grp * a.b_sg, a.b_ss, s0, a.S);
  load_rows<N>(sm + L::kC, L::kSB, a.Cm + b * a.c_sb + grp * a.c_sg, a.c_ss, s0, a.S);
  load_dt(sDt, a.dt + b * a.dt_sb + h * a.dt_sh, a.dt_ss, s0, a.S);
  __syncthreads();
  const long long bht = (static_cast<long long>(b) * a.H + h) * a.T + t;
  if (threadIdx.x < 32) {
    tile_cumsum(sDt, a.A[h], sCs, sEcs, sWl);
    if (threadIdx.x == 31) ws_decay[bht] = expf(sCs[31]);
  }
  __syncthreads();
  // x_j w_j and dy_i exp(cs_i), in place
  for (int e = threadIdx.x; e < kTile * P; e += kThreads) {
    const int l = e / P, p = e % P;
    sX[l * L::kSX + p] *= sWl[l];
    sDY[l * L::kSX + p] *= sEcs[l];
  }
  __syncthreads();
  // out[p][n] = sum_l At[l][p] Bm[l][n]: this thread's column n and rows
  // [R (tid / N), R (tid / N) + R), At read as float4 along them
  constexpr int R = P * N / kThreads;
  const int n = threadIdx.x % N, p0 = (threadIdx.x / N) * R;
  for (int which = 0; which < 2; ++which) {
    const float* At = which ? sDY : sX;
    const float* bm = sm + (which ? L::kC : L::kB);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 2
    for (int l = 0; l < kTile; ++l) {
      const float bv = bm[l * L::kSB + n];
      if constexpr (R % 4 == 0) {
#pragma unroll
        for (int r = 0; r < R; r += 4) {
          const float4 av = *reinterpret_cast<const float4*>(At + l * L::kSX + p0 + r);
          acc[r] = fmaf(av.x, bv, acc[r]);
          acc[r + 1] = fmaf(av.y, bv, acc[r + 1]);
          acc[r + 2] = fmaf(av.z, bv, acc[r + 2]);
          acc[r + 3] = fmaf(av.w, bv, acc[r + 3]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(At[l * L::kSX + p0 + r], bv, acc[r]);
      }
    }
    float* out = (which ? ws_d : ws_s) + bht * P * N;
#pragma unroll
    for (int r = 0; r < R; ++r) out[(p0 + r) * N + n] = acc[r];
  }
}

// ---- 2. the two walks over the tiles, in place ---------------------------
// Each thread walks both ways at once, kAhead tiles' loads in flight before
// their stores: a walk's loads do not wait for its carry.
constexpr int kAhead = 8;

__global__ void __launch_bounds__(kThreads)
ssd_bwd_scan_kernel(float* __restrict__ ws_s, float* __restrict__ ws_d,
                    const float* __restrict__ ws_decay, int H, int T, int PN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const long long bh = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  const float* decay = ws_decay + bh * T;
  float* s = ws_s + bh * T * PN + e;
  float* d = ws_d + bh * T * PN + e;
  float carry_s = 0.f;  // the state entering tile t
  float carry_d = 0.f;  // the gradient of the state leaving tile T - 1 - t
  for (int t0 = 0; t0 < T; t0 += kAhead) {
    float loc_s[kAhead], loc_d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k < T) {
        loc_s[k] = s[static_cast<long long>(t0 + k) * PN];
        loc_d[k] = d[static_cast<long long>(T - 1 - t0 - k) * PN];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int tf = t0 + k, tr = T - 1 - t0 - k;
      if (tf < T) {
        s[static_cast<long long>(tf) * PN] = carry_s;
        carry_s = fmaf(decay[tf], carry_s, loc_s[k]);
        d[static_cast<long long>(tr) * PN] = carry_d;
        carry_d = fmaf(decay[tr], carry_d, loc_d[k]);
      }
    }
  }
}

// ---- 3. each tile's gradients --------------------------------------------
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_grad_kernel(const Args a, const float* __restrict__ ws_s,
                    const float* __restrict__ ws_d, __nv_bfloat16* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ ws_db,
                    float* __restrict__ ws_dc, float* __restrict__ ws_da,
                    float* __restrict__ ws_dd) {
  using L = Smem<P, N>;
  extern __shared__ __align__(16) float sm[];
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (a.H / a.G);
  const int s0 = t * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sX = sm + L::kX;
  float* sDY = sm + L::kDY;
  float* sB = sm + L::kB;
  float* sC = sm + L::kC;
  float* sS = sm + L::kS;
  float* sMT = sm + L::kMT;
  float* sQ = sm + L::kQ;
  float* sQT = sm + L::kQT;
  float* sDt = sm + L::kVec + kTile * L::kDt;
  float* sCs = sm + L::kVec + kTile * L::kCs;
  float* sEcs = sm + L::kVec + kTile * L::kEcs;
  float* sWl = sm + L::kVec + kTile * L::kWl;
  float* sRowE = sm + L::kVec + kTile * L::kRowE;
  float* sColF = sm + L::kColF;
  float* sPartV = sm + L::kPartV;
  float* sPartU = sm + L::kPartU;
  float* sRed = sm + L::kRed;

  load_rows<P>(sX, L::kSX, a.x + b * a.x_sb + h * a.x_sh, a.x_ss, s0, a.S);
  load_rows<P>(sDY, L::kSX, a.dy + b * a.dy_sb + h * a.dy_sh, a.dy_ss, s0, a.S);
  load_rows<N>(sB, L::kSB, a.Bm + b * a.b_sb + grp * a.b_sg, a.b_ss, s0, a.S);
  load_rows<N>(sC, L::kSB, a.Cm + b * a.c_sb + grp * a.c_sg, a.c_ss, s0, a.S);
  load_dt(sDt, a.dt + b * a.dt_sb + h * a.dt_sh, a.dt_ss, s0, a.S);
  const long long bht = (static_cast<long long>(b) * a.H + h) * a.T + t;
  const float* s_in = ws_s + bht * P * N;
  const float* ds_out = ws_d + bht * P * N;
  for (int e = threadIdx.x; e < P * N; e += kThreads)
    sS[(e / N) * L::kSS + e % N] = s_in[e];
  __syncthreads();

  if (warp == 0) tile_cumsum(sDt, a.A[h], sCs, sEcs, sWl);
  // U_i = S_in^T dy_i [kTile x N]
  constexpr int RN = kTile * N / kThreads, RP = kTile * P / kThreads;
  float acc_u[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) acc_u[r] = 0.f;
  gemm_rows<N, P>(acc_u, sDY, L::kSX, sS, L::kSS, 1);
  __syncthreads();  // cs is in; S_in has been read

  // dS_out over S_in, and <dS_out, S_in> on the way
  float dot = 0.f;
  for (int e = threadIdx.x; e < P * N; e += kThreads) {
    const int idx = (e / N) * L::kSS + e % N;
    const float v = ds_out[e];
    dot = fmaf(sS[idx], v, dot);
    sS[idx] = v;
  }
  // G_ij, q_ij for rows i = warp + 8 r and column j = lane; then M^T, Q,
  // Q^T, the row sums of F_ij dt_j and this warp's column sums of F_ij
  {
    const int j = lane;
    float gv[kTile / kWarps], qv[kTile / kWarps];
#pragma unroll
    for (int r = 0; r < kTile / kWarps; ++r) gv[r] = qv[r] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      const float4 bv = *reinterpret_cast<const float4*>(sB + j * L::kSB + n);
#pragma unroll
      for (int r = 0; r < kTile / kWarps; ++r) {
        const float4 cv =
            *reinterpret_cast<const float4*>(sC + (warp + kWarps * r) * L::kSB + n);
        gv[r] = fmaf(cv.x, bv.x, gv[r]);
        gv[r] = fmaf(cv.y, bv.y, gv[r]);
        gv[r] = fmaf(cv.z, bv.z, gv[r]);
        gv[r] = fmaf(cv.w, bv.w, gv[r]);
      }
    }
#pragma unroll 4
    for (int p = 0; p < P; p += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(sX + j * L::kSX + p);
#pragma unroll
      for (int r = 0; r < kTile / kWarps; ++r) {
        const float4 dv =
            *reinterpret_cast<const float4*>(sDY + (warp + kWarps * r) * L::kSX + p);
        qv[r] = fmaf(dv.x, xv.x, qv[r]);
        qv[r] = fmaf(dv.y, xv.y, qv[r]);
        qv[r] = fmaf(dv.z, xv.z, qv[r]);
        qv[r] = fmaf(dv.w, xv.w, qv[r]);
      }
    }
    const float cs_j = sCs[j], dt_j = sDt[j];
    float col_f = 0.f;
#pragma unroll
    for (int r = 0; r < kTile / kWarps; ++r) {
      const int i = warp + kWarps * r;
      const float w = j <= i ? expf(sCs[i] - cs_j) : 0.f;
      const float qw = w * dt_j * qv[r];
      const float f = gv[r] * w * qv[r];
      sMT[j * L::kSQ + i] = gv[r] * w * dt_j;
      sQ[i * L::kSQ + j] = qw;
      sQT[j * L::kSQ + i] = qw;
      const float row_e = warp_sum(f * dt_j);
      if (lane == 0) sRowE[i] = row_e;
      col_f += f;
    }
    sColF[warp * kTile + j] = col_f;
  }
  dot = warp_sum(dot);
  float xdy = 0.f;  // this tile's part of dD
  for (int e = threadIdx.x; e < kTile * P; e += kThreads)
    xdy = fmaf(sX[(e / P) * L::kSX + e % P], sDY[(e / P) * L::kSX + e % P], xdy);
  xdy = warp_sum(xdy);
  if (lane == 0) {
    sRed[warp] = dot;
    sRed[kWarps + warp] = xdy;
  }
  __syncthreads();  // dS_out, M^T, Q, Q^T, the sums are in

  // dS_out B_j [kTile x P] and dS_out^T x_j [kTile x N]
  float acc_sb[RP], acc_sx[RN];
#pragma unroll
  for (int r = 0; r < RP; ++r) acc_sb[r] = 0.f;
#pragma unroll
  for (int r = 0; r < RN; ++r) acc_sx[r] = 0.f;
  gemm_rows<P, N>(acc_sb, sB, L::kSB, sS, 1, L::kSS);
  gemm_rows<N, P>(acc_sx, sX, L::kSX, sS, L::kSS, 1);
  row_partials<P>(acc_sb, sX, L::kSX, sPartV);  // v_j = x_j . dS_out B_j
  row_partials<N>(acc_u, sC, L::kSB, sPartU);   // C_k . S_in^T dy_k
  __syncthreads();

  if (warp == 0) {  // lane k: dcs, da, ddt; dA's and dD's tile partials
    const int k = lane;
    float v = 0.f, cu = 0.f, col_f = 0.f, dot_all = 0.f, xdy_all = 0.f;
#pragma unroll
    for (int c = 0; c < P / 32; ++c) v += sPartV[c * kTile + k];
#pragma unroll
    for (int c = 0; c < (N >= 32 ? N / 32 : 1); ++c) cu += sPartU[c * kTile + k];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      col_f += sColF[w * kTile + k];
      dot_all += sRed[w];
      xdy_all += sRed[kWarps + w];
    }
    const float cs = sCs[k], cs_last = sCs[kTile - 1], dt_k = sDt[k];
    const float wv = sWl[k] * v;
    float dcs = sRowE[k] - dt_k * col_f + sEcs[k] * cu - wv;
    const float wv_all = warp_sum(wv);
    if (k == kTile - 1) dcs += expf(cs_last) * dot_all + wv_all;
    float da = dcs;  // suffix sum: da_k = sum_{m >= k} dcs_m
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float o = __shfl_down_sync(0xffffffffu, da, off);
      if (k + off < 32) da += o;
    }
    const float g = a.A[h] * da + col_f + expf(cs_last - cs) * v;
    if (s0 + k < a.S) ddt[(static_cast<long long>(b) * a.S + s0 + k) * a.H + h] = g;
    const float da_sum = warp_sum(dt_k * da);
    if (k == 0) {
      ws_da[bht] = da_sum;
      ws_dd[bht] = xdy_all;
    }
  }

  // dx_j = sum_i M_ij dy_i + exp(cs_L - cs_j) dt_j dS_out B_j + D dy_j
  {
    float acc[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) acc[r] = 0.f;
    gemm_rows<P, kTile>(acc, sMT, L::kSQ, sDY, L::kSX, 1);
    const float d_skip = a.D[h];
    const int p = threadIdx.x % P;
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int j = threadIdx.x / P + (kThreads / P) * r;
      if (s0 + j >= a.S) continue;
      const float o = acc[r] + sWl[j] * acc_sb[r] + d_skip * sDY[j * L::kSX + p];
      dx[((static_cast<long long>(b) * a.S + s0 + j) * a.H + h) * P + p] =
          __float2bfloat16_rn(o);
    }
  }
  // dB_j = sum_i Q_ij C_i + exp(cs_L - cs_j) dt_j dS_out^T x_j, this head's;
  // dC_i = sum_j Q_ij B_j + exp(cs_i) S_in^T dy_i, this head's
  {
    float acc_b[RN], acc_c[RN];
#pragma unroll
    for (int r = 0; r < RN; ++r) acc_b[r] = acc_c[r] = 0.f;
    gemm_rows<N, kTile>(acc_b, sQT, L::kSQ, sC, L::kSB, 1);
    gemm_rows<N, kTile>(acc_c, sQ, L::kSQ, sB, L::kSB, 1);
    const int n = threadIdx.x % N;
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int j = threadIdx.x / N + (kThreads / N) * r;
      if (s0 + j >= a.S) continue;
      const long long o = ((static_cast<long long>(b) * a.S + s0 + j) * a.H + h) * N + n;
      ws_db[o] = acc_b[r] + sWl[j] * acc_sx[r];
      ws_dc[o] = acc_c[r] + sEcs[j] * acc_u[r];
    }
  }
}

// ---- 4. dB, dC: each group's heads summed in order ----------------------
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_sum_kernel(const float* __restrict__ ws_db, const float* __restrict__ ws_dc,
                         __nv_bfloat16* __restrict__ dB, __nv_bfloat16* __restrict__ dC,
                         long long total, int H, int G, int N) {
  const int hg = H / G;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long n = e % N, g = (e / N) % G, row = e / (static_cast<long long>(N) * G);
    const long long src = (row * H + g * hg) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < hg; ++k) {
      sb += ws_db[src + static_cast<long long>(k) * N];
      sc += ws_dc[src + static_cast<long long>(k) * N];
    }
    dB[e] = __float2bfloat16_rn(sb);
    dC[e] = __float2bfloat16_rn(sc);
  }
}

// ---- 5. dA, dD: each head's tile partials summed over (batch, tile) -----
__global__ void ssd_bwd_head_sum_kernel(const float* __restrict__ ws_da,
                                        const float* __restrict__ ws_dd,
                                        float* __restrict__ dA, float* __restrict__ dD,
                                        int Bsz, int H, int T) {
  for (int h = blockIdx.x * blockDim.x + threadIdx.x; h < H; h += gridDim.x * blockDim.x) {
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < Bsz; ++b) {
      const long long base = (static_cast<long long>(b) * H + h) * T;
      for (int t = 0; t < T; ++t) {
        sa += ws_da[base + t];
        sd += ws_dd[base + t];
      }
    }
    dA[h] = sa;
    dD[h] = sd;
  }
}

// The workspace's parts, in floats, in this order: the two state
// workspaces [B, H, T, P, N], exp(cs_L) [B, H, T], dB and dC per head
// [B, S, H, N], dA and dD per tile [B, H, T].
struct Workspace {
  long long states, bht, heads;
  Workspace(int Bsz, int S, int H, int P, int N) {
    const long long T = (S + kTile - 1) / kTile;
    states = static_cast<long long>(Bsz) * H * T * P * N;
    bht = static_cast<long long>(Bsz) * H * T;
    heads = static_cast<long long>(Bsz) * S * H * N;
  }
  long long floats() const { return 2 * states + 3 * bht + 2 * heads; }
};

template <int P, int N>
int launch(const Args& a, int Bsz, __nv_bfloat16* dx, float* ddt, float* dA,
           __nv_bfloat16* dB, __nv_bfloat16* dC, float* dD, float* ws,
           cudaStream_t stream) {
  using L = Smem<P, N>;
  const Workspace w(Bsz, a.S, a.H, P, N);
  float* ws_s = ws;
  float* ws_d = ws_s + w.states;
  float* ws_decay = ws_d + w.states;
  float* ws_da = ws_decay + w.bht;
  float* ws_dd = ws_da + w.bht;
  float* ws_db = ws_dd + w.bht;
  float* ws_dc = ws_db + w.heads;
  const int chunk_bytes = L::kChunkFloats * 4, grad_bytes = L::kGradFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_grad_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, grad_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 tiles(a.T, a.H, Bsz);
  ssd_bwd_chunk_kernel<P, N><<<tiles, kThreads, chunk_bytes, stream>>>(a, ws_s, ws_d,
                                                                       ws_decay);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 lanes((P * N + kThreads - 1) / kThreads, a.H, Bsz);
  ssd_bwd_scan_kernel<<<lanes, kThreads, 0, stream>>>(ws_s, ws_d, ws_decay, a.H, a.T, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_grad_kernel<P, N><<<tiles, kThreads, grad_bytes, stream>>>(
      a, ws_s, ws_d, dx, ddt, ws_db, ws_dc, ws_da, ws_dd);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(Bsz) * a.S * a.G * N;
  const long long blocks = (total + kThreads - 1) / kThreads;
  ssd_bwd_group_sum_kernel<<<static_cast<int>(blocks < 65536 ? blocks : 65536), kThreads,
                             0, stream>>>(ws_db, ws_dc, dB, dC, total, a.H, a.G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_sum_kernel<<<(a.H + 127) / 128, 128, 0, stream>>>(ws_da, ws_dd, dA, dD,
                                                                 Bsz, a.H, a.T);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_p(int N, const Args& a, int Bsz, __nv_bfloat16* dx, float* ddt, float* dA,
             __nv_bfloat16* dB, __nv_bfloat16* dC, float* dD, float* ws,
             cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<P, 16>(a, Bsz, dx, ddt, dA, dB, dC, dD, ws, stream);
    case 64:
      return launch<P, 64>(a, Bsz, dx, ddt, dA, dB, dC, dD, ws, stream);
    case 128:
      return launch<P, 128>(a, Bsz, dx, ddt, dA, dB, dC, dD, ws, stream);
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
// repro_ssd_chunked_bwd_workspace_bytes of fp32 scratch, 16-byte aligned.
// Returns a cudaError_t.
extern "C" int repro_ssd_chunked_bwd_bf16(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* D, const void* dy, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* dD, void* workspace, int Bsz, int S, int H, int P, int G, int N,
    const long long* x_strides, const long long* dt_strides, const long long* b_strides,
    const long long* c_strides, const long long* dy_strides, void* stream) {
  if (S < 1 || G < 1 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
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
  if (P == 32) return launch_p<32>(N, a, Bsz, odx, oddt, odA, odB, odC, odD, ws, s);
  if (P == 64) return launch_p<64>(N, a, Bsz, odx, oddt, odA, odB, odC, odD, ws, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
