// Fused Adam / AdamW for Hopper (sm_90a), with a plain C interface.
//
// Replaces `_fused_kernel` of analytics_zoo_tpu/pallas/fused_adam.py (L93),
// launched there per leaf by `_leaf_update` (L125) through `pl.pallas_call`
// (L150) with the params and moments aliased to the outputs (in place).
//
// What it computes, per element of one leaf, in place (`_adam_math`, L83):
//   m <- b1 * m + (1 - b1) * g
//   v <- b2 * v + (1 - b2) * g * g
//   p <- p - a * m / (sqrt(v) + b) - lrwd * p
// with the bias correction folded into the scalars on the host
// (`_fold_scalars`, L70): a = lr * sqrt(1 - b2^t) / (1 - b1^t),
// b = eps * sqrt(1 - b2^t), lrwd = lr * weight_decay, t the step number
// after the increment. p and g are f32 or bf16 (each read as f32, p written
// back rounded to its dtype); m and v are f32. Every operation is an IEEE
// round-to-nearest intrinsic in the order `_adam_math` writes it, with no
// fused multiply-adds (`azt::adam_update` in common.cuh, shared with the
// segment-Adam kernel), so the kernel agrees with the plain PyTorch version
// (`kernels/fused_adam.py`, one rounding per operation) bit for bit.
//
// What bounds it on an H100: per element it reads g, p, m, v and writes p,
// m, v (the 7-pass floor of `leaf_cost`, L104) for about 12 operations, so
// it is a memory stream: n * (4 + 2 * p_itemsize + 16) bytes at 3.35 TB/s.
//
// What its design does about that: one pass, in place, coalesced (a warp
// reads 32 neighbouring elements of each array), a grid-stride loop over a
// grid of a few blocks per SM. One launch per leaf, as the TPU version;
// a single launch over every leaf (a multi-tensor apply) would remove the
// per-leaf launch cost and is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(P* __restrict__ p, float* __restrict__ m,
                  float* __restrict__ v, const G* __restrict__ g, long long n,
                  azt::AdamScalars s) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    float pi = azt::to_float(p[i]);
    float mi = m[i];
    float vi = v[i];
    azt::adam_update(pi, mi, vi, azt::to_float(g[i]), s);
    m[i] = mi;
    v[i] = vi;
    azt::from_float(p + i, pi);
  }
}

template <typename P, typename G>
void launch(void* p, void* m, void* v, const void* g, long long n,
            const azt::AdamScalars& s, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < 132 * 8 ? blocks : 132 * 8;  // 8 blocks per SM
  fused_adam_kernel<P, G><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<P*>(p), static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const G*>(g), n, s);
}

}  // namespace

extern "C" {

// p_dtype, g_dtype: 0 = float32, 1 = bfloat16. p, m, v, g: contiguous, n
// elements each (n > 0); m and v float32. one_minus_b1 / one_minus_b2 are
// (1 - b1), (1 - b2) formed in double and rounded to f32, as Python forms
// them. Returns the cudaError_t of the launch (0 on success).
int azt_fused_adam(void* p, void* m, void* v, const void* g, long long n,
                   float a, float b, float lrwd, float b1, float b2,
                   float one_minus_b1, float one_minus_b2, int p_dtype,
                   int g_dtype, void* stream) {
  if (n <= 0 || p_dtype < 0 || p_dtype > 1 || g_dtype < 0 || g_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const azt::AdamScalars s{a, b, lrwd, b1, b2, one_minus_b1, one_minus_b2};
  if (p_dtype == 0 && g_dtype == 0) {
    launch<float, float>(p, m, v, g, n, s, st);
  } else if (p_dtype == 0) {
    launch<float, __nv_bfloat16>(p, m, v, g, n, s, st);
  } else if (g_dtype == 0) {
    launch<__nv_bfloat16, float>(p, m, v, g, n, s, st);
  } else {
    launch<__nv_bfloat16, __nv_bfloat16>(p, m, v, g, n, s, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
