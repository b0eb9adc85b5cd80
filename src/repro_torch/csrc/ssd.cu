// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a): bf16 x/B/C/y,
// fp32 dt/A/D, bf16 tensor-core products accumulated in fp32, fp32 final
// state.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_chunked_kernel` in
// src/repro/kernels/ssd.py. For each (batch, head) it computes, tile by
// tile along the sequence, with cs the within-tile cumulative sum of
// dt * A:
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j   (intra)
//          + exp(cs_i) (C_i . state)                              (inter)
//          + D x_i                                                (skip)
//   state <- state exp(cs_last) + sum_j x_j exp(cs_last - cs_j) dt_j B_j^T
// Positions at or past S get dt = 0 (and zero x, B, C), so they add
// nothing and leave the decay flat; y and final_state equal the unpadded
// recurrence's. Head h reads B/C group h / (H / G). The TPU kernel's chunk
// of 256 needs a 256 x 256 fp32 score tile, more than a block's shared
// memory; this kernel walks the sequence in tiles of kTile = 32, which
// changes the result by rounding only.
//
// What bounds it. At the serving shape (B = 8, S = 1024, H = 32, P = 64,
// N = 128, G = 1) the compulsory traffic is x and y (33.5 MB each), dt
// (1.0 MB), B and C (2.1 MB each) and the final state (8.4 MB): 80.7 MB,
// 24 us at 3.35 TB/s. The least work is ~9 GFLOP (chip_smoke.py's
// ssd_bound), ~9 us on bf16 tensor cores: so on tensor cores the bound is
// bytes. The work is a serial chain of tiles per (batch, head), each a
// handful of small products; what the design does about it:
//   - All four products run on tensor cores, `mma.sync.m16n8k16` bf16 ->
//     fp32 with `ldmatrix` fragments: C B^T, M x (M the decay-weighted
//     scores), C state^T and (x w)^T B.
//   - Blocks: one per (batch, head) with all of P, so C B^T is computed
//     once per head. Warps 0-1 each own 16 rows of the tile: C B^T up to
//     the diagonal, M in registers, M x, and y. Warps 2.. (P / 16 of them)
//     each own 16 rows of the [P, N] state, in fp32 registers for the whole
//     sequence, and compute the inter term transposed, state C^T, with the
//     state as the A operand straight from its accumulators (the C
//     fragments of an MMA are the A fragments of the next over the same
//     columns), then the state update into the same accumulators. The
//     state never goes through shared memory.
//   - Loads: cp.async, double-buffered: tile t + 1's B, C, x and dt land
//     while tile t computes, issued by warps 0-1. B, C and x stay bf16 in
//     shared memory, rows padded by 16 bytes so ldmatrix's eight rows hit
//     distinct banks.
//   - Two block barriers per tile: one when the tile has landed, one when
//     the cumulative sum and the inter term are in shared memory.
//   - Registers set the tile: two blocks of 6 warps share an SM at up to
//     168 registers a thread, which the state (64 at N = 128), the inter
//     term's accumulators (16) and the hi/lo fragments fit without a
//     spill. Tiles of 64 need 8 warps, whose 128-register cap the 32
//     accumulators of a 64-row inter term overflow.
//   - Shared memory (P = 64, N = 128): 2 x 22,144 bytes of tiles, 8,704 of
//     inter term, 384 of cs / w / exp(cs): 53,376 bytes; 256 blocks of 192
//     threads fit the 132 SMs at once.
//
// Error budget. B, C and x are bf16, so C B^T is exact products summed in
// fp32. Each fp32 operand of the other products -- M, the state and x w --
// is split into hi = bf16(v) and lo = bf16(v - hi), and each product is
// two MMAs into one fp32 accumulator (kMParts, kStateParts, kXwParts): the
// relative error per term is ~2^-16 instead of fp32's 2^-24. Emulated on
// the CPU at B = 2, S = 1024, H = 4, P = 64, N = 128 against the Pallas
// kernel (tests/test_torch_ssm.py), the final state's worst row errs
// 2.5e-5, as the fp32 chunked scan does (3.0e-5), 40x under chip_smoke.py's
// 1e-3; one bf16 rounding of x w instead errs 3.6e-3 in the state, of the
// state 1.2e-2 in y, of M 3.4e-2 in y. The upper triangle of M is selected
// away, never multiplied, so exp(cs_i - cs_j) > 1 above the diagonal
// cannot turn into inf * 0.
//
// Cumulative sum: warp 0, lane l holding position l: d_l = dt_l * A
// rounded, then an inclusive Hillis-Steele scan over the 32 lanes (v_l =
// v_{l-k} + v_l for k = 1, 2, 4, 8, 16), cs_l = v_l. It restarts at every
// tile.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;               // positions per tile along S
constexpr int kIntraWarps = kTile / 16;  // one per 16 rows of the tile
// hi + lo parts of each fp32 operand of a tensor-core product
constexpr int kMParts = 2;      // M = (C B^T) exp(cs_i - cs_j) dt_j
constexpr int kStateParts = 2;  // the state, in C state^T
constexpr int kXwParts = 2;     // x w, in the state update

template <int P, int N>
struct Layout {
  static constexpr int kThreads = 32 * (kIntraWarps + P / 16);
  static constexpr int kSN = N + 8;  // bf16 row stride of the B and C tiles
  static constexpr int kSP = P + 8;  // bf16 row stride of the x tile
  static constexpr int kSY = P + 4;  // fp32 row stride of the inter term
  // bytes, within a stage
  static constexpr int kB = 0;
  static constexpr int kC = kB + kTile * kSN * 2;
  static constexpr int kX = kC + kTile * kSN * 2;
  static constexpr int kDt = kX + kTile * kSP * 2;
  static constexpr int kStage = kDt + kTile * 4;
  // bytes, after the two stages
  static constexpr int kY = 2 * kStage;  // inter term [kTile][kSY] fp32
  static constexpr int kCs = kY + kTile * kSY * 4;
  static constexpr int kW = kCs + kTile * 4;
  static constexpr int kEcs = kW + kTile * 4;
  static constexpr int kBytes = kEcs + kTile * 4;
  static_assert(kStage % 16 == 0, "16-byte aligned stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies with a zero fill: src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
// Every thread of the block; the two roles reach it from their own loops.
__device__ __forceinline__ void block_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Fragment layout of m16n8k16 (lane = 4 g + t):
//   A (16x16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//              a3 = (g+8, 2t+8..)
//   B (16x8):  b0 = (k = 2t..2t+1, n = g), b1 = (k = 2t+8.., n = g)
//   C (16x8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// so the C fragments of two neighbouring n-tiles are the A fragment of one
// k-step over those 16 columns.
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A register of two bf16 -> two floats, exactly; the low half first.
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
// (v0, v1) -> hi = bf16(v), lo = bf16(v - hi), each a packed pair, v0 in
// the low half.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// The A fragment of k-step kk from accumulators acc[2 kk], acc[2 kk + 1].
__device__ __forceinline__ void split_frag(const float* c0, const float* c1,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

template <int P, int N>
__global__ void __launch_bounds__(Layout<P, N>::kThreads, 2)
ssd_fwd_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ A,
               const __nv_bfloat16* __restrict__ Bm,
               const __nv_bfloat16* __restrict__ Cm,
               const float* __restrict__ D, __nv_bfloat16* __restrict__ y,
               float* __restrict__ final_state, int S, int H, int G,
               long long x_sb, long long x_ss, long long x_sh,
               long long dt_sb, long long dt_ss, long long dt_sh,
               long long b_sb, long long b_ss, long long b_sg,
               long long c_sb, long long c_ss, long long c_sg,
               long long y_sb, long long y_ss, long long y_sh) {
  using L = Layout<P, N>;
  constexpr int kThreads = L::kThreads;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sbase = smem_u32(smem);
  float* sY = reinterpret_cast<float*>(smem + L::kY);
  float* sCs = reinterpret_cast<float*>(smem + L::kCs);
  float* sW = reinterpret_cast<float*>(smem + L::kW);
  float* sEcs = reinterpret_cast<float*>(smem + L::kEcs);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (H / G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = (S + kTile - 1) / kTile;

  const __nv_bfloat16* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const __nv_bfloat16* bb = Bm + b * b_sb + grp * b_sg;
  const __nv_bfloat16* cb = Cm + b * c_sb + grp * c_sg;

  // Tile `tile` into stage `stage`, zeros at positions >= S; issued by the
  // intra warps alone, so the state warps hold no pointers or strides.
  constexpr int kLoaders = 32 * kIntraWarps;
  auto load_tile = [&](int tile, int stage) {
    const int s0 = tile * kTile;
    const uint32_t st = sbase + stage * L::kStage;
    for (int c = threadIdx.x; c < kTile * (N / 8); c += kLoaders) {
      const int r = c / (N / 8), col = (c % (N / 8)) * 8;
      const bool in = s0 + r < S;
      const long long pos = in ? s0 + r : 0;
      const uint32_t off = (r * L::kSN + col) * 2;
      cp_async16(st + L::kB + off, bb + pos * b_ss + col, in);
      cp_async16(st + L::kC + off, cb + pos * c_ss + col, in);
    }
    for (int c = threadIdx.x; c < kTile * (P / 8); c += kLoaders) {
      const int r = c / (P / 8), col = (c % (P / 8)) * 8;
      const bool in = s0 + r < S;
      const long long pos = in ? s0 + r : 0;
      cp_async16(st + L::kX + (r * L::kSP + col) * 2, xb + pos * x_ss + col, in);
    }
    if (threadIdx.x < kTile) {  // dt hard-masked past S
      const bool in = s0 + threadIdx.x < S;
      const long long pos = in ? s0 + threadIdx.x : 0;
      cp_async4(st + L::kDt + threadIdx.x * 4, dtb + pos * dt_ss, in);
    }
    cp_async_commit();
  };

  if (warp < kIntraWarps) {
    if (threadIdx.x < kTile) sCs[threadIdx.x] = 0.f;
    load_tile(0, 0);
    // ---- rows [16 warp, 16 warp + 16) of each tile: C B^T, M x, y --------
    const float a = A[h];
    const float d_skip = D[h];
    __nv_bfloat16* yb = y + b * y_sb + h * y_sh;
    const int i0 = 16 * warp + g;  // this thread's rows: i0, i0 + 8
    for (int it = 0; it < n_tiles; ++it) {
      const int s0 = it * kTile;
      const int stage = it & 1;
      cp_async_wait_all();
      block_sync(1, kThreads);  // tile it landed; tile it - 1 is done
      if (it + 1 < n_tiles) load_tile(it + 1, stage ^ 1);
      const uint32_t st = sbase + stage * L::kStage;
      const float* sDt = reinterpret_cast<const float*>(smem + stage * L::kStage + L::kDt);
      const __nv_bfloat16* sX =
          reinterpret_cast<const __nv_bfloat16*>(smem + stage * L::kStage + L::kX);

      if (warp == 0) {  // lane l holds position l
        const float d = __fmul_rn(sDt[lane], a);
        const float start = 0.f;  // the decay restarts at every tile
        float v = d;
#pragma unroll
        for (int k = 1; k < 32; k *= 2) {
          const float o = __shfl_up_sync(0xffffffffu, v, k);
          if (lane >= k) v = __fadd_rn(o, v);
        }
        const float c = __fadd_rn(start, v);
        const float last = __shfl_sync(0xffffffffu, c, 31);
        sCs[lane] = c;
        sW[lane] = expf(last - c) * sDt[lane];
        sEcs[lane] = expf(c);
      }

      // scores C B^T for this warp's rows, column tiles up to the diagonal
      float sc[kTile / 8][4];
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, st + L::kC +
                        ((16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::kSN +
                         16 * kk + 8 * (lane >> 4)) * 2);
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
          if (np > warp) continue;
          uint32_t bf[4];
          ldsm_x4(bf, st + L::kB +
                          ((16 * np + (lane & 7) + 8 * (lane >> 4)) * L::kSN +
                           16 * kk + 8 * ((lane >> 3) & 1)) * 2);
          mma_16816(sc[2 * np], af, bf[0], bf[1]);
          mma_16816(sc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
      block_sync(2, kThreads);  // cs, w, exp(cs) and the inter term are in

      // M = (C B^T) exp(cs_i - cs_j) dt_j on and below the diagonal
      const float cs_i[2] = {sCs[i0], sCs[i0 + 8]};
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        if (n / 2 > warp) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 8 * (e >> 1);
          const int j = 8 * n + 2 * t + (e & 1);
          sc[n][e] = i >= j ? sc[n][e] * expf(cs_i[e >> 1] - sCs[j]) * sDt[j] : 0.f;
        }
      }
      // intra term M x, M as hi + lo
      float yi[P / 8][4];
#pragma unroll
      for (int n = 0; n < P / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yi[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        if (kk > warp) continue;
        uint32_t mh[4], ml[4];
        split_frag(sc[2 * kk], sc[2 * kk + 1], mh, ml);
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4_t(bf, st + L::kX +
                            ((16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::kSP +
                             16 * np + 8 * (lane >> 4)) * 2);
#pragma unroll
          for (int part = 0; part < kMParts; ++part) {
            const uint32_t* af = part ? ml : mh;
            mma_16816(yi[2 * np], af, bf[0], bf[1]);
            mma_16816(yi[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      }
      // y = M x + exp(cs) (C state^T) + D x
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = i0 + 8 * rr;
        if (s0 + i >= S) continue;
        const float ecs = sEcs[i];
        __nv_bfloat16* yrow = yb + (s0 + i) * y_ss;
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
          const int p = 8 * n + 2 * t;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sX + i * L::kSP + p));
          const float o0 = (yi[n][2 * rr] + sY[i * L::kSY + p] * ecs) + xv.x * d_skip;
          const float o1 =
              (yi[n][2 * rr + 1] + sY[i * L::kSY + p + 1] * ecs) + xv.y * d_skip;
          *reinterpret_cast<__nv_bfloat162*>(yrow + p) = __floats2bfloat162_rn(o0, o1);
        }
      }
    }
  } else {
    // ---- state rows [16 sw, 16 sw + 16): C state^T, then the update ------
    const int sw = warp - kIntraWarps;
    float stt[N / 8][4];  // state[16 sw + g (+8)][8 n + 2 t (+1)]
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) stt[n][e] = 0.f;
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it & 1;
      block_sync(1, kThreads);  // tile it landed (the intra warps load)
      const uint32_t st = sbase + stage * L::kStage;

      // inter term, transposed: yt[p][i] = sum_n state[p][n] C[i][n], with
      // the state as hi + lo A fragments from its own accumulators
      float yt[kTile / 8][4];
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t sh[4], sl[4];
        split_frag(stt[2 * kk], stt[2 * kk + 1], sh, sl);
#pragma unroll
        for (int ip = 0; ip < kTile / 16; ++ip) {
          uint32_t bf[4];
          ldsm_x4(bf, st + L::kC +
                          ((16 * ip + (lane & 7) + 8 * (lane >> 4)) * L::kSN +
                           16 * kk + 8 * ((lane >> 3) & 1)) * 2);
#pragma unroll
          for (int part = 0; part < kStateParts; ++part) {
            const uint32_t* af = part ? sl : sh;
            mma_16816(yt[2 * ip], af, bf[0], bf[1]);
            mma_16816(yt[2 * ip + 1], af, bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sY[(8 * n + 2 * t + (e & 1)) * L::kSY + 16 * sw + g + 8 * (e >> 1)] =
              yt[n][e];
      block_sync(2, kThreads);

      // state <- state exp(cs_last) + (x w)^T B, x w as hi + lo
      const float decay = expf(sCs[kTile - 1]);
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) stt[n][e] *= decay;
#pragma unroll 1
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t xr[4];  // A fragment of x^T [p][j]: x stored [j][p]
        ldsm_x4_t(xr, st + L::kX +
                          ((16 * kk + (lane & 7) + 8 * (lane >> 4)) * L::kSP +
                           16 * sw + 8 * ((lane >> 3) & 1)) * 2);
        const float2 w_lo = *reinterpret_cast<const float2*>(sW + 16 * kk + 2 * t);
        const float2 w_hi = *reinterpret_cast<const float2*>(sW + 16 * kk + 2 * t + 8);
        uint32_t xh[4], xl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xv = unpack_bf16x2(xr[e]);
          const float2 w = e < 2 ? w_lo : w_hi;
          split2(xv.x * w.x, xv.y * w.y, xh[e], xl[e]);
        }
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4_t(bf, st + L::kB +
                            ((16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::kSN +
                             16 * np + 8 * (lane >> 4)) * 2);
#pragma unroll
          for (int part = 0; part < kXwParts; ++part) {
            const uint32_t* af = part ? xl : xh;
            mma_16816(stt[2 * np], af, bf[0], bf[1]);
            mma_16816(stt[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      }
    }
    float* fs = final_state + (static_cast<long long>(b) * H + h) * P * N;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(fs + (16 * sw + g + 8 * rr) * N + 8 * n + 2 * t) =
            make_float2(stt[n][2 * rr], stt[n][2 * rr + 1]);
  }
}

template <int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* final_state, int Bsz,
           int S, int H, int G, const long long* xs, const long long* dts,
           const long long* bs, const long long* cs, const long long* ys,
           cudaStream_t stream) {
  using L = Layout<P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Bsz);
  ssd_fwd_kernel<P, N><<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(D),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(final_state), S, H, G,
      xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2], cs[0],
      cs[1], cs[2], ys[0], ys[1], ys[2]);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_p(int N, const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* D, void* y, void* final_state, int Bsz,
             int S, int H, int G, const long long* xs, const long long* dts,
             const long long* bs, const long long* cs, const long long* ys,
             cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<P, 16>(x, dt, A, Bm, Cm, D, y, final_state, Bsz, S, H, G, xs,
                           dts, bs, cs, ys, stream);
    case 64:
      return launch<P, 64>(x, dt, A, Bm, Cm, D, y, final_state, Bsz, S, H, G, xs,
                           dts, bs, cs, ys, stream);
    case 128:
      return launch<P, 128>(x, dt, A, Bm, Cm, D, y, final_state, Bsz, S, H, G, xs,
                            dts, bs, cs, ys, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: [B, S, H, P] bf16, dt: [B, S, H] fp32, A, D: [H] fp32 contiguous,
// B/C: [B, S, G, N] bf16, y: [B, S, H, P] bf16, final_state: [B, H, P, N]
// fp32 contiguous. x, B, C and y have a unit stride on their last axis,
// other strides multiples of 8 elements and 16-byte aligned bases; each
// *_strides array holds the (batch, seq, head or group) strides in
// elements (dt's third is its head stride). P in {32, 64}, N in
// {16, 64, 128}, G dividing H. Returns a cudaError_t.
extern "C" int repro_ssd_chunked_fwd_bf16(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, void* y, void* final_state, int Bsz, int S,
    int H, int P, int G, int N, const long long* x_strides,
    const long long* dt_strides, const long long* b_strides,
    const long long* c_strides, const long long* y_strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || G < 1 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 32)
    return launch_p<32>(N, x, dt, A, Bm, Cm, D, y, final_state, Bsz, S, H, G,
                        x_strides, dt_strides, b_strides, c_strides, y_strides, s);
  if (P == 64)
    return launch_p<64>(N, x, dt, A, Bm, Cm, D, y, final_state, Bsz, S, H, G,
                        x_strides, dt_strides, b_strides, c_strides, y_strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
