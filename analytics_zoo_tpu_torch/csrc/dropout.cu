// Inverted dropout for Hopper (sm_90a), with a plain C interface.
//
// Replaces `_kernel` of analytics_zoo_tpu/pallas/dropout.py (L110),
// launched there by `_apply` (L123) through `pl.pallas_call` (L131). The
// backward there (`_fused_bwd`, L162) is the same kernel on dout with the
// same seed; here too, so no mask is ever stored.
//
// What it computes, for element i of a contiguous tensor viewed flat:
//   bits_i = word i%4 of Philox-4x32-10 at counter (i/4, 0, 1), key seed,
//            the seed read from device memory (`SeedPath`, `philox.cuh`)
//   out_i  = bits_i >= threshold ? x_i * scale : 0
// threshold = min(floor(rate * 2^32), 2^32 - 1) and scale = 1 / (1 - rate)
// rounded to the tensor's dtype: the uint32 rule of `_dropout_threshold`
// (L58) and `_kernel` (L116-120). The bits come from Philox (`philox.cuh`),
// not the TPU's PRNG, so the masks differ from the TPU's; the rule and the
// keep probability are the same. x * scale is formed in f32 and rounded
// once to the dtype, which is what a bf16 multiply gives.
//
// What bounds it on an H100: one read and one write per element and a few
// operations (10 Philox rounds of two 32-bit multiplies per 4 elements), so
// it is a memory stream: 2 * n * itemsize bytes at 3.35 TB/s.
//
// What its design does about that: one thread takes 4 neighbouring
// elements, which share one Philox call, and moves them as one 16-byte (f32)
// or 8-byte (bf16) access when the tensor allows (n % 4 == 0, aligned), so
// a warp's accesses are contiguous; a grid-stride loop over a grid of a few
// blocks per SM keeps loads in flight. CUDA C++ rather than Triton: one
// toolchain and one build path (`kernels/_build.py`) for every kernel of the
// port.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
               const __grid_constant__ azt::SeedPath seed, uint32_t threshold,
               float scale) {
  const unsigned long long z = azt::path_seed(seed);
  const uint32_t k0 = static_cast<uint32_t>(z);
  const uint32_t k1 = static_cast<uint32_t>(z >> 32);
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < groups; g += stride) {
    const azt::Philox4 r = azt::dropout_bits(k0, k1, g);
    const long long i0 = 4 * g;
    if (kVec) {
      float4 v = azt::load4(x + i0);
      v.x = r.w[0] >= threshold ? __fmul_rn(v.x, scale) : 0.f;
      v.y = r.w[1] >= threshold ? __fmul_rn(v.y, scale) : 0.f;
      v.z = r.w[2] >= threshold ? __fmul_rn(v.z, scale) : 0.f;
      v.w = r.w[3] >= threshold ? __fmul_rn(v.w, scale) : 0.f;
      azt::store4(out + i0, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i0 + e < n) {
          const float xv = azt::to_float(x[i0 + e]);
          azt::from_float(out + i0 + e,
                          r.w[e] >= threshold ? __fmul_rn(xv, scale) : 0.f);
        }
      }
    }
  }
}

template <typename T>
void launch(const void* x, void* out, long long n, const azt::SeedPath& seed,
            uint32_t threshold, float scale, bool vec, cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  blocks = blocks < 132 * 16 ? blocks : 132 * 16;  // 16 blocks per SM
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (vec) {
    dropout_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(xp, op, n, seed, threshold, scale);
  } else {
    dropout_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(xp, op, n, seed, threshold, scale);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, out: contiguous, n elements (n > 0),
// `vec` only when n % 4 == 0 and both pointers are 16-byte aligned; `scale`
// is 1 / (1 - rate) already rounded to the dtype. The seed: the int64 at
// `seed_base` (device memory) taken through the `seed_depth` site indices
// of `seed_sites` (a host array, depth <= 8). Returns the cudaError_t of
// the launch (0 on success).
int azt_dropout(const void* x, void* out, long long n, const void* seed_base,
                int seed_depth, const long long* seed_sites,
                unsigned int threshold, float scale, int dtype, int vec,
                void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1) || seed_base == nullptr ||
      seed_depth < 0 || seed_depth > azt::kMaxSeedDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const azt::SeedPath seed =
      azt::make_seed_path(seed_base, seed_depth, seed_sites);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, out, n, seed, threshold, scale, vec != 0, s);
  } else {
    launch<__nv_bfloat16>(x, out, n, seed, threshold, scale, vec != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
