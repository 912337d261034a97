// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces `_fwd_kernel` of analytics_zoo_tpu/pallas/flash_attention.py
// (L217), launched there by `_flash_fwd` (L278) through `pl.pallas_call`
// (L290), at dropout rate 0 (the serving path).
//
// What it computes, for each (batch*head) and query row i of [B*H, T, D]:
//   s_j   = (q_i . k_j) * (1/sqrt(D)) + mask[b, j]    additive [B,1,1,T] f32
//   O_i   = sum_j softmax(s)_j * v_j                   stored in the input dtype
//   lse_i = max_j s_j + log(sum_j exp(s_j - max))      f32, for the backward
// Inputs are f32 or bf16; every score, softmax statistic and accumulator is
// f32. D may be any size up to 128 (rows whose length is not a multiple of 4
// are read element by element); T need not be a multiple of the
// tile: keys past T get a score of -inf inside the kernel (the TPU version
// pads T with a -1e9 mask instead).
//
// What bounds it on an H100: per head the work is 4*T^2*D FLOP against
// 4*T*D elements moved, about T FLOP per element (512 at BERT's T = 512),
// so it is compute-shaped, not a memory stream. This first version does its
// FLOPs as f32 FMAs on the CUDA cores (67 TFLOP/s peak), not on the tensor
// cores; mma/wgmma tiles are later work.
//
// What its design does about that. The TPU grid carries (acc, m, l) across a
// sequential k-block grid axis in VMEM scratch; on Hopper blocks run in no
// order, so one thread block owns one (b*h, q-tile) and loops over the
// k-tiles itself:
//   - each K/V tile is read from device memory once per block, converted to
//     f32 and staged in shared memory, then reused by all the block's query
//     rows (128 rows at D <= 64), so device traffic is ~T/128 passes over K
//     and V and the scores never leave registers;
//   - each thread owns one query row (two threads per row for D > 64, one
//     shuffle joins their half dot products) and keeps q and the output
//     accumulator in registers;
//   - shared-memory reads are 16-byte broadcasts (every lane reads the same
//     key), one per four FMAs;
//   - the softmax runs in the log2 domain (log2 e folded into the scale,
//     exp2f), rescaling the accumulator once per chunk of 16 keys, and the
//     division by l happens once at the end.
// A row whose running max is still -inf (no finite score yet) uses 0 as the
// exponent base, so exp(-inf - -inf) never occurs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // threads per block
constexpr int kDimsPerThread = 64;  // head dims one thread owns
constexpr int kGroups = kDimsPerThread / 4;  // float4 groups one thread owns
constexpr int kChunk = 16;          // keys per online-softmax update
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// TPR: threads per query row (1 for D <= 64, 2 for D <= 128). Thread h of a
// row owns the float4 groups g = h + TPR*i, i < kGroups, so the lanes of a
// row pair read neighbouring 16-byte words of a key (no bank conflict).
template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, int heads,
                 int seq, int dim, float scale) {
  constexpr int kDMax = kDimsPerThread * TPR;
  constexpr int kRows = kThreads / TPR;   // query rows per block
  constexpr int kKeys = 4096 / kDMax;     // keys per tile: K+V = 32 KB f32
  constexpr int kRowGroups = kDMax / 4;
  static_assert(kKeys % kChunk == 0, "tile must hold whole chunks");

  __shared__ __align__(16) float ks[kKeys * kDMax];
  __shared__ __align__(16) float vs[kKeys * kDMax];
  __shared__ float ms[kKeys];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int tid = threadIdx.x;
  const int h = tid % TPR;
  const int row = blockIdx.x * kRows + tid / TPR;
  const bool row_ok = row < seq;
  const size_t head = (size_t)bh * seq * dim;
  const float scale_log2 = scale * kLog2e;
  const bool vec = dim % 4 == 0;

  float4 qr[kGroups];
  float4 acc[kGroups];
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int d = 4 * (h + TPR * i);
    qr[i] = (row_ok && d < dim)
                ? load_group(q + head + (size_t)row * dim, d, dim, vec)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;  // running max of the log2-domain scores
  float l = 0.f;        // running sum of 2^(s - m)

  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < kKeys * kRowGroups; e += kThreads) {
      const int j = e / kRowGroups;
      const int d = 4 * (e % kRowGroups);
      const int key = k0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (key < seq && d < dim) {
        kk = load_group(k + head + (size_t)key * dim, d, dim, vec);
        vv = load_group(v + head + (size_t)key * dim, d, dim, vec);
      }
      store4(&ks[j * kDMax + d], kk);
      store4(&vs[j * kDMax + d], vv);
    }
    for (int j = tid; j < kKeys; j += kThreads) {
      const int key = k0 + j;
      float bias = -INFINITY;  // ragged edge: keys past T never count
      if (key < seq) {
        bias = mask != nullptr ? mask[(size_t)b * seq + key] * kLog2e : 0.f;
      }
      ms[j] = bias;
    }
    __syncthreads();

    const int n_keys = min(kKeys, seq - k0);
    for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float* kr = &ks[(c0 + c) * kDMax];
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kGroups; ++i) {
          dot = dot4(qr[i], load4(kr + 4 * (h + TPR * i)), dot);
        }
        if (TPR == 2) {
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        }
        // (q.k) * scale + mask, all times log2 e
        s[c] = fmaf(dot, scale_log2, ms[c0 + c]);
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float base = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f(m - base);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        s[c] = exp2f(s[c] - base);
        psum += s[c];
      }
      l = fmaf(l, alpha, psum);
      m = m_new;
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
        acc[i].z *= alpha;
        acc[i].w *= alpha;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float* vr = &vs[(c0 + c) * kDMax];
#pragma unroll
        for (int i = 0; i < kGroups; ++i) {
          axpy4(s[c], load4(vr + 4 * (h + TPR * i)), acc[i]);
        }
      }
    }
  }

  if (row_ok) {
    const float inv_l = 1.f / l;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int d = 4 * (h + TPR * i);
      if (d < dim) {
        store_group(o + head + (size_t)row * dim, d, dim, vec,
                    make_float4(acc[i].x * inv_l, acc[i].y * inv_l,
                                acc[i].z * inv_l, acc[i].w * inv_l));
      }
    }
    if (h == 0) {
      lse[(size_t)bh * seq + row] = (m + log2f(l)) * kLn2;
    }
  }
}

template <typename T, int TPR>
void launch(const void* q, const void* k, const void* v, const void* mask,
            void* o, void* lse, int bh, int heads, int seq, int dim,
            float scale, cudaStream_t stream) {
  constexpr int kRows = kThreads / TPR;
  const dim3 grid((seq + kRows - 1) / kRows, bh);
  flash_fwd_kernel<T, TPR><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(o), static_cast<float*>(lse), heads, seq, dim, scale);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous [bh, seq, dim],
// 16-byte aligned, dim <= 128; mask: contiguous f32 [bh / heads, seq] or
// null; lse: f32 [bh, seq]. Returns the cudaError_t of the launch (0 on
// success).
int azt_flash_attn_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* o, void* lse, int bh,
                       int heads, int seq, int dim, float scale, int dtype,
                       void* stream) {
  if (bh <= 0 || bh > 65535 || heads <= 0 || bh % heads != 0 || seq <= 0 ||
      dim <= 0 || dim > 128 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (dim <= 64) {
      launch<float, 1>(q, k, v, mask, o, lse, bh, heads, seq, dim, scale, s);
    } else {
      launch<float, 2>(q, k, v, mask, o, lse, bh, heads, seq, dim, scale, s);
    }
  } else {
    if (dim <= 64) {
      launch<__nv_bfloat16, 1>(q, k, v, mask, o, lse, bh, heads, seq, dim,
                               scale, s);
    } else {
      launch<__nv_bfloat16, 2>(q, k, v, mask, o, lse, bh, heads, seq, dim,
                               scale, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
