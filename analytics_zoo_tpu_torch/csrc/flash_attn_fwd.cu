// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces `_fwd_kernel` of analytics_zoo_tpu/pallas/flash_attention.py
// (L217), launched there by `_flash_fwd` (L278) through `pl.pallas_call`
// (L290), with its in-kernel attention dropout (L242-250).
//
// What it computes, for each (batch*head) and query row i of [B*H, T, D]:
//   s_j   = (q_i . k_j) * (1/sqrt(D)) + mask[b, j]    additive [B,1,1,T] f32
//   p_j   = exp(s_j - max_j s_j)
//   O_i   = sum_j p_j * keep_ij * v_j / sum_j p_j     in the input dtype
//   lse_i = max_j s_j + log(sum_j exp(s_j - max))      f32, for the backward
// keep_ij is 1 without dropout; with dropout it is the keep scale of the
// byte rule (`philox.cuh`: 256/t where the byte of (seed, b*h, i, j) is
// below t, else 0). As in the TPU kernel, the denominator sums the
// undropped p, so dropout applies to the normalised weights. The backward
// kernels (`flash_attn_bwd.cu`) regenerate the same bits.
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
// cores; mma/wgmma tiles are later work. Dropout adds one Philox call (10
// rounds) per 16 scores.
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
//     division by l happens once at the end;
//   - a chunk of 16 keys starts at a multiple of 16, so one Philox call
//     gives the chunk's 16 keep bytes.
// A row whose running max is still -inf (no finite score yet) uses 0 as the
// exponent base, so exp(-inf - -inf) never occurs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

using azt::axpy4;
using azt::dot4;
using azt::load4;
using azt::load_group;
using azt::store4;
using azt::store_group;

constexpr int kThreads = 128;       // threads per block
constexpr int kDimsPerThread = 64;  // head dims one thread owns
constexpr int kGroups = kDimsPerThread / 4;  // float4 groups one thread owns
constexpr int kChunk = 16;          // keys per online-softmax update
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// TPR: threads per query row (1 for D <= 64, 2 for D <= 128). Thread h of a
// row owns the float4 groups g = h + TPR*i, i < kGroups, so the lanes of a
// row pair read neighbouring 16-byte words of a key (no bank conflict).
template <typename T, int TPR, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, int heads,
                 int seq, int dim, float scale, azt::AttnDropout drop) {
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
  float l = 0.f;        // running sum of 2^(s - m), undropped

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
      if (kDrop) {
        // the denominator above took the undropped p; the PV product
        // takes p * keep scale
        const azt::Philox4 bits = azt::attn_keep_bits(
            drop.k0, drop.k1, bh, row, (k0 + c0) / kChunk);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          s[c] = azt::keep_byte(bits, c) < drop.t ? s[c] * drop.keep_scale
                                                  : 0.f;
        }
      }
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
                    azt::scale4(acc[i], inv_l));
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
            float scale, azt::AttnDropout drop, cudaStream_t stream) {
  constexpr int kRows = kThreads / TPR;
  const dim3 grid((seq + kRows - 1) / kRows, bh);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* mp = static_cast<const float*>(mask);
  T* op = static_cast<T*>(o);
  float* lp = static_cast<float*>(lse);
  if (drop.t != 0) {
    flash_fwd_kernel<T, TPR, true><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, mp, op, lp, heads, seq, dim, scale, drop);
  } else {
    flash_fwd_kernel<T, TPR, false><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, mp, op, lp, heads, seq, dim, scale, drop);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous [bh, seq, dim],
// 16-byte aligned, dim <= 128; mask: contiguous f32 [bh / heads, seq] or
// null; lse: f32 [bh, seq]. keep_threshold: the byte rule's t in [1, 255],
// or 0 for no dropout; keep_scale = 256 / t. Returns the cudaError_t of the
// launch (0 on success).
int azt_flash_attn_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* o, void* lse, int bh,
                       int heads, int seq, int dim, float scale, int dtype,
                       unsigned long long seed, int keep_threshold,
                       float keep_scale, void* stream) {
  if (bh <= 0 || bh > 65535 || heads <= 0 || bh % heads != 0 || seq <= 0 ||
      dim <= 0 || dim > 128 || (dtype != 0 && dtype != 1) ||
      keep_threshold < 0 || keep_threshold > 255) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const azt::AttnDropout drop = {static_cast<uint32_t>(seed),
                        static_cast<uint32_t>(seed >> 32),
                        static_cast<uint32_t>(keep_threshold), keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (dim <= 64) {
      launch<float, 1>(q, k, v, mask, o, lse, bh, heads, seq, dim, scale,
                       drop, s);
    } else {
      launch<float, 2>(q, k, v, mask, o, lse, bh, heads, seq, dim, scale,
                       drop, s);
    }
  } else {
    if (dim <= 64) {
      launch<__nv_bfloat16, 1>(q, k, v, mask, o, lse, bh, heads, seq, dim,
                               scale, drop, s);
    } else {
      launch<__nv_bfloat16, 2>(q, k, v, mask, o, lse, bh, heads, seq, dim,
                               scale, drop, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
