// The two kernels of the vocab-chunked unembedding and cross-entropy
// (kernels/unembed_ce.py), for Hopper (sm_90a): a row reduction that folds
// one chunk of fp32 logits into each row's running (max, sum of exp), and
// a fused elementwise pass that turns a chunk of logits into the softmax
// gradient, as three bf16 planes or in fp32.
//
// They replace no TPU kernel. Together with the products around them they
// replace the jnp unembedding and log-sum-exp of the JAX model's
// train_loss (src/repro/models/model.py:643-650: `unembed`, a dot_general
// of bf16 operands into fp32 logits of the whole vocabulary, then
// `logsumexp` and the label's logit), and `jax.grad` through them. The
// loop over chunks of Vc columns lives in kernels/unembed_ce.py, so that
// no [T, V] fp32 tensor is ever made: each chunk's logits [T, Vc] are a
// bf16 x bf16 product with fp32 accumulation and fp32 output (a plain
// product, torch.mm with out_dtype), written once and read here.
//
// What bounds them: bytes. At mamba2-370m's training shape (T = 16 x 2048
// = 32,768 rows, V = 50,432, Vc = 5,632) a forward reads the 6.61 GB of
// chunk logits once (`ce_fold_kernel`, ~2.0 ms at 3.35 TB/s); a backward
// reads them once more and writes 1.5 times their bytes as planes
// (`ce_grad_kernel`, ~4.9 ms). Each does a few operations a byte, so the
// design is about moving each byte once:
//   - One block per row, 256 threads, 16-byte loads (float4) along the row
//     where the row's width and stride allow, else 4-byte ones; each
//     thread folds its elements into an online (max, sum of exp) pair, the
//     pairs are combined by warp shuffles and then across the block's
//     warps. One pass over the chunk, no second read for the max.
//   - The running state of each row (max, sum, the label's logit) is three
//     fp32 values in device memory, read and written once per chunk; the
//     first chunk starts it, the last writes the row's log-sum-exp.
//   - The gradient pass reads a logit, forms g = (exp(x - lse) - [col ==
//     label]) * (dce / T) in fp32 and writes it as hi = bf16(g), mid =
//     bf16(g - hi), lo = bf16(g - hi - mid): three planes [T, 3, Vc] that
//     sum to g exactly (8 + 8 + 8 of fp32's 24 significant bits; exact
//     wherever g's lowest bit lies above bf16's least subnormal), so the
//     bf16 tensor-core products of the backward lose nothing of the fp32
//     operand. With fp32 operands it writes g itself, in place over the
//     logits.
// The scale dce / T is read on the device: the host never waits for the
// loss's gradient.
//
// Numerics: expf and logf (correctly rounded to ~1 ulp, no fast math);
// the row sums in another order than the plain version
// (ref.ce_fold_reference), the same to fp32 rounding. A label outside
// [0, V) leaves that row's picked logit NaN, and so the loss.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (m, s) <- the fold of (m, s) and (m2, s2): the larger max, each sum
// rescaled to it. An empty pair (-inf, 0) leaves the other as it is.
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    ce_fold_kernel(const float* __restrict__ logits, long long ld, int w,
                   const int* __restrict__ labels, int v0,
                   float* __restrict__ state, int rows,
                   float* __restrict__ lse, bool first, bool last) {
  const int row = blockIdx.x;
  const float* x = logits + static_cast<long long>(row) * ld;
  float m = -INFINITY, s = 0.f;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int i = threadIdx.x; i < w / 4; i += kThreads) {
      const float4 q = x4[i];
      const float mn = fmaxf(m, fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w)));
      s = s * expf(m - mn) + expf(q.x - mn) + expf(q.y - mn) +
          expf(q.z - mn) + expf(q.w - mn);
      m = mn;
    }
  } else {
    for (int i = threadIdx.x; i < w; i += kThreads) {
      const float v = x[i];
      const float mn = fmaxf(m, v);
      s = s * expf(m - mn) + expf(v - mn);
      m = mn;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    combine(m, s, m2, s2);
  }
  __shared__ float sm[kWarps], ss[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int k = 1; k < kWarps; ++k) combine(m, s, sm[k], ss[k]);
  float* m_run = state;
  float* s_run = state + rows;
  float* picked = state + 2 * static_cast<long long>(rows);
  if (!first) combine(m, s, m_run[row], s_run[row]);
  if (first) picked[row] = __int_as_float(0x7fc00000);  // NaN until found
  const int lab = labels[row] - v0;
  if (lab >= 0 && lab < w) picked[row] = x[lab];
  if (last) {
    lse[row] = m + logf(s);
  } else {
    m_run[row] = m;
    s_run[row] = s;
  }
}

struct __align__(8) Planes4 {
  __nv_bfloat16 v[4];
};

__device__ __forceinline__ void split3(float g, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(g);
  const float r1 = g - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

// kPlanes: write g as three bf16 planes [rows, 3, w]; else g in fp32 into
// `out` [rows, ld] (which may be the logits themselves).
template <bool kPlanes, bool kVec>
__global__ void __launch_bounds__(kThreads)
    ce_grad_kernel(const float* logits, long long ld, int w,
                   const int* __restrict__ labels, int v0,
                   const float* __restrict__ lse,
                   const float* __restrict__ dce, int rows,
                   __nv_bfloat16* __restrict__ planes, float* out) {
  const int row = blockIdx.x;
  const long long r = static_cast<long long>(row);
  const float* x = logits + r * ld;
  const float l = lse[row];
  const float scale = dce[0] / static_cast<float>(rows);
  const int lab = labels[row] - v0;
  __nv_bfloat16* hi_row = planes + r * 3 * w;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int i = threadIdx.x; i < w / 4; i += kThreads) {
      const float4 q = x4[i];
      float g[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        g[k] = (expf(g[k] - l) - (4 * i + k == lab ? 1.f : 0.f)) * scale;
      if (kPlanes) {
        Planes4 a, b, c;
#pragma unroll
        for (int k = 0; k < 4; ++k) split3(g[k], a.v[k], b.v[k], c.v[k]);
        reinterpret_cast<Planes4*>(hi_row)[i] = a;
        reinterpret_cast<Planes4*>(hi_row + w)[i] = b;
        reinterpret_cast<Planes4*>(hi_row + 2 * w)[i] = c;
      } else {
        reinterpret_cast<float4*>(out + r * ld)[i] =
            make_float4(g[0], g[1], g[2], g[3]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < w; i += kThreads) {
      const float g = (expf(x[i] - l) - (i == lab ? 1.f : 0.f)) * scale;
      if (kPlanes) {
        split3(g, hi_row[i], hi_row[w + i], hi_row[2 * w + i]);
      } else {
        out[r * ld + i] = g;
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Folds the chunk `logits` [rows, w] (row stride ld, columns v0 .. v0 + w
// of the vocabulary) into `state` [3, rows] (running max, running sum of
// exp, the label's logit); `first` starts the state, `last` writes each
// row's log-sum-exp into `lse` [rows] instead of the running pair.
extern "C" int repro_ce_fold(const void* logits, long long ld, int rows,
                             int w, const void* labels, int v0, void* state,
                             void* lse, int first, int last, void* stream) {
  if (rows < 1 || w < 1 || ld < w) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ld % 4 == 0 && w % 4 == 0 && aligned16(logits);
  auto* x = static_cast<const float*>(logits);
  auto* lab = static_cast<const int*>(labels);
  auto* s = static_cast<float*>(state);
  auto* out = static_cast<float*>(lse);
  if (vec)
    ce_fold_kernel<true><<<rows, kThreads, 0, st>>>(x, ld, w, lab, v0, s,
                                                    rows, out, first, last);
  else
    ce_fold_kernel<false><<<rows, kThreads, 0, st>>>(x, ld, w, lab, v0, s,
                                                     rows, out, first, last);
  return static_cast<int>(cudaGetLastError());
}

// The softmax gradient of the chunk `logits` [rows, w] (row stride ld,
// columns v0 .. v0 + w) for the loss's gradient dce[0], the loss being the
// mean over the rows: as three bf16 planes into `planes` [rows, 3, w] (planes != 0),
// or in fp32 into `out` [rows, ld], which may alias `logits`.
extern "C" int repro_ce_grad(const void* logits, long long ld, int rows,
                             int w, const void* labels, int v0,
                             const void* lse, const void* dce, void* planes,
                             void* out, void* stream) {
  if (rows < 1 || w < 1 || ld < w ||
      (planes == nullptr) == (out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const float*>(logits);
  auto* lab = static_cast<const int*>(labels);
  auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<const float*>(dce);
  auto* pl = static_cast<__nv_bfloat16*>(planes);
  auto* o = static_cast<float*>(out);
  const bool vec = ld % 4 == 0 && w % 4 == 0 && aligned16(logits) &&
                   (pl != nullptr ? reinterpret_cast<uintptr_t>(pl) % 8 == 0
                                  : aligned16(o));
#define CE_GRAD(planes_, vec_)                                              \
  ce_grad_kernel<planes_, vec_><<<rows, kThreads, 0, st>>>(                \
      x, ld, w, lab, v0, l, d, rows, pl, o)
  if (pl != nullptr) {
    if (vec) CE_GRAD(true, true); else CE_GRAD(true, false);
  } else {
    if (vec) CE_GRAD(false, true); else CE_GRAD(false, false);
  }
#undef CE_GRAD
  return static_cast<int>(cudaGetLastError());
}
