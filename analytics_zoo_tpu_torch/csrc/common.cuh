// Helpers shared by the port's CUDA sources: float32 / bfloat16 loads and
// stores of four elements, conversions, and the small vector arithmetic the
// attention kernels are written in. Every value is carried as f32 inside a
// kernel whatever the tensor's dtype.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace azt {

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four elements [d, d+4) of a row of `dim` (zeros past `dim`): one vector
// access when rows are a whole number of 4-element groups (`vec`), else
// element by element, since such rows are not 8/16-byte aligned.
template <typename T>
__device__ __forceinline__ float4 load_group(const T* row, int d, int dim,
                                             bool vec) {
  if (vec) {
    return load4(row + d);
  }
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[e] = d + e < dim ? to_float(row[d + e]) : 0.f;
  }
  return make_float4(x[0], x[1], x[2], x[3]);
}

template <typename T>
__device__ __forceinline__ void store_group(T* row, int d, int dim, bool vec,
                                            float4 v) {
  if (vec) {
    store4(row + d, v);
    return;
  }
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (d + e < dim) {
      from_float(row + d + e, x[e]);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float p, float4 v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// The Adam / AdamW update of one element, in place, with the bias
// correction folded into (a, b) on the host (`_fold_scalars` of
// analytics_zoo_tpu/pallas/fused_adam.py, L70):
//   m <- b1 * m + (1 - b1) * g
//   v <- b2 * v + (1 - b2) * g * g
//   p <- p - a * m / (sqrt(v) + b) - lrwd * p
// Every operation is an IEEE round-to-nearest intrinsic in the order
// `_adam_math` (L83) writes it, with no fused multiply-adds, so a kernel
// built on it agrees with the plain PyTorch version bit for bit. The fused
// Adam and the row-sparse (segment) Adam kernels both call it.
struct AdamScalars {
  float a, b, lrwd, b1, b2, one_minus_b1, one_minus_b2;
};

// (a, b, lrwd) change every step: they are read from device memory (the
// step's row of the scalar table, `folded`), so a captured CUDA graph
// reads each replay's values. b1, b2 and their complements are constants
// of the optimizer and come by value.
__device__ __forceinline__ AdamScalars with_folded(AdamScalars s,
                                                   const float* folded) {
  s.a = __ldg(folded);
  s.b = __ldg(folded + 1);
  s.lrwd = __ldg(folded + 2);
  return s;
}

__device__ __forceinline__ void adam_update(float& p, float& m, float& v,
                                            float g, const AdamScalars& s) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v),
                __fmul_rn(s.one_minus_b2, __fmul_rn(g, g)));
  const float step = __fdiv_rn(__fmul_rn(s.a, m), __fadd_rn(__fsqrt_rn(v),
                                                            s.b));
  p = __fsub_rn(__fsub_rn(p, step), __fmul_rn(s.lrwd, p));
}

}  // namespace azt
