// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a): bf16 x/B/C/y,
// fp32 dt/A/D, fp32 arithmetic and fp32 final state.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_chunked_kernel` in
// src/repro/kernels/ssd.py. For each (batch, head) it computes, chunk by
// chunk along the sequence, with cs the within-chunk cumulative sum of
// dt * A:
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j   (intra)
//          + exp(cs_i) (C_i . state)                              (inter)
//          + D x_i                                                (skip)
//   state <- state exp(cs_last) + sum_j x_j exp(cs_last - cs_j) dt_j B_j^T
// Positions at or past S get dt = 0, so they add nothing and leave the
// decay flat; y and final_state equal the unpadded recurrence's. Head h
// reads B/C group h / (H / G).
//
// Tile. The TPU kernel's chunk of 256 needs a 256 x 256 fp32 score tile
// (256 KB), more than a block's 227 KB of shared memory. This kernel walks
// the sequence in tiles of kTile = 64 positions instead; the result does
// not depend on the chunk except by rounding (the model's chunk of 256
// reaches the plain version only). The cumulative sum within a tile is
// taken by one thread, left to right, in the order of the reference's
// sequential cumsum; only its restart every 64 positions instead of every
// 256 differs.
//
// Blocks. One block of 256 threads owns one (batch, head, 32 rows of P):
// the rows of the [P, N] state are independent (y[:, p] needs only
// state[p, :] and x[:, p]), so P = 64 splits in two. At the serving shape
// that gives 8 * 32 * 2 = 512 blocks for 132 SMs, two resident per SM
// (108 KB of shared memory each at N = 128), instead of 256 blocks that
// would leave the second wave a third empty. The price is that both halves
// recompute the tile's C . B^T and decays. Each thread keeps its 16 state
// values in registers for the whole sequence; a shared copy serves the
// inter-chunk product. The masked upper triangle of the decay matrix is
// selected away (never multiplied), so exp(cs_i - cs_j) > 1 above the
// diagonal cannot turn into inf * 0.
//
// What bounds it. At the serving shape (B = 8, S = 1024, H = 32, P = 64,
// N = 128, G = 1) the compulsory traffic is x and y (33.5 MB each), dt
// (1.0 MB), B and C (2.1 MB each) and the final state (8.4 MB): 80.7 MB,
// 24 us at 3.35 TB/s. The least work, with C . B^T shared by the group's
// heads, is ~2 * (2 N P + L P / 2) FLOPs per token and head plus
// 2 L N / 2 per token and group: ~10 GFLOP at L = 64, ~0.15 ms on the
// 67 TFLOP/s fp32 CUDA cores this kernel uses, ~10 us on bf16 tensor
// cores. So it is bound by operations, and this first version, plain fp32
// FMAs on shared-memory tiles with 4 x 4 / 4 x 2 register blocks, is
// bound by shared-memory loads (about one per two FMAs) and recomputes
// C . B^T per head and half of P. mma.sync for C . B^T (exact in bf16), a
// group-shared score pass, TMA and wgmma are the later redesign.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // positions per tile along S
constexpr int kPBlk = 32;     // rows of P per block
constexpr int kThreads = 256;

template <int N>
struct Smem {
  static constexpr int kStrideBC = N + 1;      // odd: conflict-free columns
  static constexpr int kStrideM = kTile + 1;
  static constexpr int kB = 0;
  static constexpr int kC = kB + kTile * kStrideBC;
  static constexpr int kX = kC + kTile * kStrideBC;
  static constexpr int kM = kX + kTile * kPBlk;
  static constexpr int kState = kM + kTile * kStrideM;
  static constexpr int kCs = kState + kPBlk * kStrideBC;
  static constexpr int kDt = kCs + kTile;
  static constexpr int kEcs = kDt + kTile;
  static constexpr int kW = kEcs + kTile;
  static constexpr int kFloats = kW + kTile;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ A,
               const __nv_bfloat16* __restrict__ Bm,
               const __nv_bfloat16* __restrict__ Cm,
               const float* __restrict__ D, __nv_bfloat16* __restrict__ y,
               float* __restrict__ final_state, int S, int H, int P, int G,
               long long x_sb, long long x_ss, long long x_sh,
               long long dt_sb, long long dt_ss, long long dt_sh,
               long long b_sb, long long b_ss, long long b_sg,
               long long c_sb, long long c_ss, long long c_sg,
               long long y_sb, long long y_ss, long long y_sh) {
  using L = Smem<N>;
  constexpr int kSB = L::kStrideBC;
  constexpr int kSM = L::kStrideM;
  // state ownership: kNLanes threads along n, the rest along p
  constexpr int kNLanes = N < 32 ? N : 32;
  constexpr int kPGroups = kThreads / kNLanes;
  constexpr int kRows = kPBlk / kPGroups;  // p rows per thread
  constexpr int kCols = N / kNLanes;       // n columns per thread
  static_assert(kRows * kCols * kThreads == kPBlk * N, "state mapping");

  extern __shared__ float smem[];
  float* sB = smem + L::kB;
  float* sC = smem + L::kC;
  float* sX = smem + L::kX;
  float* sM = smem + L::kM;
  float* sState = smem + L::kState;
  float* sCs = smem + L::kCs;
  float* sDt = smem + L::kDt;
  float* sEcs = smem + L::kEcs;
  float* sW = smem + L::kW;

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPBlk;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const float a = A[h];
  const float d_skip = D[h];

  const __nv_bfloat16* xb = x + b * x_sb + h * x_sh + p0;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const __nv_bfloat16* bb = Bm + b * b_sb + g * b_sg;
  const __nv_bfloat16* cb = Cm + b * c_sb + g * c_sg;
  __nv_bfloat16* yb = y + b * y_sb + h * y_sh + p0;

  // this thread's state block: rows sp + kPGroups * r, columns sn + kNLanes * c
  const int sn = tid % kNLanes;
  const int sp = tid / kNLanes;
  float st[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) st[r][c] = 0.f;
  for (int i = tid; i < kPBlk * kSB; i += kThreads) sState[i] = 0.f;

  // score block (4 x 4) and output block (4 x 2) of this thread
  const int si = tid / 16, sj = tid % 16;
  const int yi = tid / 16, yp = tid % 16;

  for (int s0 = 0; s0 < S; s0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kTile * N; idx += kThreads) {
      const int i = idx / N, n = idx % N;
      const bool in = s0 + i < S;
      sB[i * kSB + n] = in ? __bfloat162float(bb[(s0 + i) * b_ss + n]) : 0.f;
      sC[i * kSB + n] = in ? __bfloat162float(cb[(s0 + i) * c_ss + n]) : 0.f;
    }
    for (int idx = tid; idx < kTile * kPBlk; idx += kThreads) {
      const int i = idx / kPBlk, p = idx % kPBlk;
      sX[idx] = s0 + i < S ? __bfloat162float(xb[(s0 + i) * x_ss + p]) : 0.f;
    }
    if (tid < kTile)  // dt hard-masked past S
      sDt[tid] = s0 + tid < S ? dtb[(s0 + tid) * dt_ss] : 0.f;
    __syncthreads();
    if (tid == 0) {  // in order, as the reference's cumsum
      float acc = 0.f;
      for (int i = 0; i < kTile; ++i) {
        // dt * A rounded before the add, as the reference's dA; no fma
        acc = __fadd_rn(acc, __fmul_rn(sDt[i], a));
        sCs[i] = acc;
      }
    }
    __syncthreads();
    const float cs_last = sCs[kTile - 1];
    if (tid < kTile) {
      sEcs[tid] = expf(sCs[tid]);
      sW[tid] = expf(cs_last - sCs[tid]) * sDt[tid];
    }

    // M = (C B^T) * exp(cs_i - cs_j) * dt_j on and below the diagonal
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(si + 16 * r) * kSB + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sB[(sj + 16 * c) * kSB + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = si + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = sj + 16 * c;
          sM[i * kSM + j] =
              i >= j ? acc[r][c] * expf(sCs[i] - sCs[j]) * sDt[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = M x + exp(cs) (C state^T) + D x, rows yi + 16 r, columns yp + 16 c
    {
      float intra[4][2], inter[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) intra[r][c] = inter[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float mv[4], xv[2];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = sM[(yi + 16 * r) * kSM + j];
#pragma unroll
        for (int c = 0; c < 2; ++c) xv[c] = sX[j * kPBlk + yp + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) intra[r][c] = fmaf(mv[r], xv[c], intra[r][c]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[2];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(yi + 16 * r) * kSB + n];
#pragma unroll
        for (int c = 0; c < 2; ++c) sv[c] = sState[(yp + 16 * c) * kSB + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) inter[r][c] = fmaf(cv[r], sv[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = yi + 16 * r;
        if (s0 + i >= S) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int p = yp + 16 * c;
          const float xv = sX[i * kPBlk + p];
          const float out = (intra[r][c] + inter[r][c] * sEcs[i]) + xv * d_skip;
          yb[(s0 + i) * y_ss + p] = __float2bfloat16_rn(out);
        }
      }
    }

    // state <- state exp(cs_last) + sum_j (x_j w_j) B_j^T, in registers
    {
      float upd[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) upd[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        const float w = sW[j];
        float xw[kRows], bv[kCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r) xw[r] = sX[j * kPBlk + sp + kPGroups * r] * w;
#pragma unroll
        for (int c = 0; c < kCols; ++c) bv[c] = sB[j * kSB + sn + kNLanes * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c) upd[r][c] = fmaf(xw[r], bv[c], upd[r][c]);
      }
      const float decay = expf(cs_last);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) st[r][c] = st[r][c] * decay + upd[r][c];
    }
    __syncthreads();  // every reader of the old shared state is done
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        sState[(sp + kPGroups * r) * kSB + sn + kNLanes * c] = st[r][c];
  }

  float* fs = final_state + ((static_cast<long long>(b) * H + h) * P + p0) * N;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      fs[(sp + kPGroups * r) * N + sn + kNLanes * c] = st[r][c];
}

template <int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* final_state, int Bsz,
           int S, int H, int P, int G, const long long* xs,
           const long long* dts, const long long* bs, const long long* cs,
           const long long* ys, cudaStream_t stream) {
  const size_t bytes = Smem<N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(P / kPBlk, H, Bsz);
  ssd_fwd_kernel<N><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(D),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(final_state), S, H,
      P, G, xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2],
      cs[0], cs[1], cs[2], ys[0], ys[1], ys[2]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [B, S, H, P] bf16, dt: [B, S, H] fp32, A, D: [H] fp32 contiguous,
// B/C: [B, S, G, N] bf16, y: [B, S, H, P] bf16, final_state: [B, H, P, N]
// fp32 contiguous. x, B, C and y have a unit stride on their last axis;
// each *_strides array holds the (batch, seq, head or group) strides in
// elements (dt's third is its head stride). P in {32, 64}, N in
// {16, 64, 128}, G dividing H. Returns a cudaError_t.
extern "C" int repro_ssd_chunked_fwd_bf16(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, void* y, void* final_state, int Bsz, int S,
    int H, int P, int G, int N, const long long* x_strides,
    const long long* dt_strides, const long long* b_strides,
    const long long* c_strides, const long long* y_strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || P % kPBlk != 0 || P > 64 || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (N) {
    case 16:
      return launch<16>(x, dt, A, Bm, Cm, D, y, final_state, Bsz, S, H, P, G,
                        x_strides, dt_strides, b_strides, c_strides,
                        y_strides, s);
    case 64:
      return launch<64>(x, dt, A, Bm, Cm, D, y, final_state, Bsz, S, H, P, G,
                        x_strides, dt_strides, b_strides, c_strides,
                        y_strides, s);
    case 128:
      return launch<128>(x, dt, A, Bm, Cm, D, y, final_state, Bsz, S, H, P,
                         G, x_strides, dt_strides, b_strides, c_strides,
                         y_strides, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
