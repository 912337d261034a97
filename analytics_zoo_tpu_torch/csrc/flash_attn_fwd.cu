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
// f32. D may be any size up to 128; T need not be a multiple of the tile:
// keys past T get a score of -inf inside the kernel (the TPU version pads
// T with a -1e9 mask instead). A row whose running max is still -inf (no
// finite score yet) uses 0 as the exponent base, so exp(-inf - -inf)
// never occurs.
//
// What bounds it on an H100: per head the work is 4*T^2*D FLOP against
// 4*T*D elements moved, about T FLOP per element (512 at BERT's T = 512),
// well above the card's ~295 bf16 FLOP per byte, so it is bound by the
// products, then by the softmax's exponentials (one MUFU ex2 per score,
// 16 per SM per clock) and, with dropout, by Philox's integer work (one
// 10-round call per 16 scores, of the order of the product's work).
//
// Two kernels, one per dtype:
//
// bf16 (`flash_fwd_mma_kernel`): the products on the tensor cores. One
// block of 4 warps owns one (b*h, 64 query rows), each warp 16 rows, and
// walks the keys 64 at a time:
//   - Q's 16 x D fragments are read from shared memory once, by ldmatrix,
//     and held in registers;
//   - K and V tiles of 64 keys are staged by cp.async into padded shared
//     memory, double-buffered: tile j+1's copy is in flight while tile j's
//     products run; rows past T and columns past D are zero-filled (a NaN
//     in a pad would survive a zero weight);
//   - S = Q.K^T is 8 x D/16 mma.sync m16n8k16 (bf16 in, f32 accumulate),
//     K's fragments by ldmatrix;
//   - the online softmax runs on the accumulator fragments in the log2
//     domain (log2 e folded into the scale, exp2f); a lane holds 16 scores
//     of each of its two rows, and the row max is joined across the four
//     lanes of a quad by two shuffles; l is kept per lane and joined once
//     at the end;
//   - P * keep is rounded to bf16 (as the TPU kernel does, L247-248) and
//     is already the A fragment of O += P.V; V's fragments come
//     transposed by ldmatrix.trans;
//   - dropout: each (row, 16-key chunk) is drawn once per quad, two Philox
//     calls a lane per tile, and the keep masks traded by shuffle
//     (`mma.cuh` keep_rows);
//   - the epilogue divides by l, stores O in bf16 and lse in f32.
// Shared memory: (1 + 2 + 2) tiles of 64 x (D_pad + 8) bf16 and two mask
// rows: 46.6 KB at D_pad 64, 87.6 KB at 128 (above 48 KB by
// cudaFuncSetAttribute). D_pad is D rounded up to 32, 64 or 128.
//
// f32 (`flash_fwd_kernel`, the first version, kept as it was): f32 FMAs
// on the CUDA cores (67 TFLOP/s); the tensor cores would mean TF32, which
// changes the numbers. One block owns one (b*h, q-tile) and loops over the
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
//   - the softmax runs in the log2 domain, rescaling the accumulator once
//     per chunk of 16 keys, and the division by l happens once at the end;
//   - a chunk of 16 keys starts at a multiple of 16, so one Philox call
//     gives the chunk's 16 keep bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
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
                 int seq, int dim, float scale,
                 const __grid_constant__ azt::AttnDropoutArg drop_arg) {
  const azt::AttnDropout drop = azt::resolve<kDrop>(drop_arg);
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

// The bf16 kernel on the tensor cores (see the note at the top). DP: the
// head dim padded to 32, 64 or 128.
template <int DP, bool kDrop>
__global__ void __launch_bounds__(azt::mma::kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ mask,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int heads, int seq, int dim, float scale,
                     const __grid_constant__ azt::AttnDropoutArg drop_arg) {
  const azt::AttnDropout drop = azt::resolve<kDrop>(drop_arg);
  using namespace azt::mma;
  constexpr int kElems = tile_elems<DP>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kElems;      // two buffers
  bf16* vs = ks + 2 * kElems;  // two buffers
  float* ms = reinterpret_cast<float*>(vs + 2 * kElems);  // two rows of 64

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const size_t head = (size_t)bh * seq * dim;
  const bool vec = dim % 8 == 0;
  const float* mrow = mask != nullptr ? mask + (size_t)b * seq : nullptr;
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = (seq + kTile - 1) / kTile;

  auto stage_kv = [&](int j) {
    const int buf = j & 1;
    stage_rows<DP>(ks + buf * kElems, k + head, j * kTile, seq, dim, vec,
                   tid);
    stage_rows<DP>(vs + buf * kElems, v + head, j * kTile, seq, dim, vec,
                   tid);
    if (mrow != nullptr && tid < kTile) {
      stage_float(ms + buf * kTile, mrow, j * kTile, seq, tid);
    }
    cp_async_commit();
  };

  stage_rows<DP>(qs, q + head, q0, seq, dim, vec, tid);
  cp_async_commit();
  stage_kv(0);
  cp_async_wait<1>();  // Q has landed; tile 0 may still be in flight
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    load_a<DP>(qf[kk], qs, warp * 16, kk, lane);
  }

  float acc[DP / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this lane's share of the sum

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      stage_kv(j + 1);  // overwrites the buffer tile j - 1 used
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int key0 = j * kTile;
    const float* mt = ms + buf * kTile;

    float s[8][4] = {};
    gemm_nt<DP>(s, qf, ks + buf * kElems, lane);

    // (q.k) * scale + mask, all times log2 e; keys past T never count
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nb * 8 + 2 * t + (e & 1);
        float bias = -INFINITY;
        if (key0 + c < seq) {
          bias = mrow != nullptr ? mt[c] * kLog2e : 0.f;
        }
        s[nb][e] = fmaf(s[nb][e], scale_log2, bias);
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[nb][e]);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - base[e >> 1]);
        psum[e >> 1] += s[nb][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = fmaf(l[r], alpha[r], psum[r]);
    }
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[nb][e] *= alpha[e >> 1];
      }
    }
    if (kDrop) {
      // l took the undropped p; the PV product takes p * keep scale
      keep_rows(s, drop, bh, row, key0, lane);
    }
    gemm_wb<DP>(acc, s, vs + buf * kElems, lane);
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i >= seq) {
      continue;
    }
    const float inv_l = 1.f / l[r];
    bf16* orow = o + head + (size_t)i * dim;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int c = nb * 8 + 2 * t;
      const float x0 = acc[nb][2 * r] * inv_l;
      const float x1 = acc[nb][2 * r + 1] * inv_l;
      if (vec) {
        if (c < dim) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(x0, x1);
        }
      } else {
        if (c < dim) {
          orow[c] = __float2bfloat16(x0);
        }
        if (c + 1 < dim) {
          orow[c + 1] = __float2bfloat16(x1);
        }
      }
    }
    if (t == 0) {
      lse[(size_t)bh * seq + i] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// Dynamic shared memory of the bf16 kernel: Q, two K and two V tiles, two
// mask rows.
template <int DP>
constexpr int mma_smem_bytes() {
  return 5 * azt::mma::tile_elems<DP>() * 2 + 2 * azt::mma::kTile * 4;
}

template <int DP, bool kDrop>
cudaError_t launch_mma_drop(const void* q, const void* k, const void* v,
                            const void* mask, void* o, void* lse, int bh,
                            int heads, int seq, int dim, float scale,
                            azt::AttnDropoutArg drop, cudaStream_t stream) {
  constexpr int kBytes = mma_smem_bytes<DP>();
  auto kernel = flash_fwd_mma_kernel<DP, kDrop>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid((seq + azt::mma::kTile - 1) / azt::mma::kTile, bh);
  kernel<<<grid, azt::mma::kThreads, kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), heads, seq,
      dim, scale, drop);
  return cudaSuccess;
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* mask, void* o, void* lse, int bh,
                       int heads, int seq, int dim, float scale,
                       azt::AttnDropoutArg drop, cudaStream_t stream) {
  if (drop.t != 0) {
    return launch_mma_drop<DP, true>(q, k, v, mask, o, lse, bh, heads, seq,
                                     dim, scale, drop, stream);
  }
  return launch_mma_drop<DP, false>(q, k, v, mask, o, lse, bh, heads, seq,
                                    dim, scale, drop, stream);
}

template <typename T, int TPR>
void launch(const void* q, const void* k, const void* v, const void* mask,
            void* o, void* lse, int bh, int heads, int seq, int dim,
            float scale, azt::AttnDropoutArg drop, cudaStream_t stream) {
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
// or 0 for no dropout; keep_scale = 256 / t. The dropout seed: the int64 at
// `seed_base` (device memory; unread without dropout) taken through the
// `seed_depth` (<= 8) site indices of the host array `seed_sites`. Returns
// the cudaError_t of the launch (0 on success).
int azt_flash_attn_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* o, void* lse, int bh,
                       int heads, int seq, int dim, float scale, int dtype,
                       const void* seed_base, int seed_depth,
                       const long long* seed_sites, int keep_threshold,
                       float keep_scale, void* stream) {
  if (bh <= 0 || bh > 65535 || heads <= 0 || bh % heads != 0 || seq <= 0 ||
      dim <= 0 || dim > 128 || (dtype != 0 && dtype != 1) ||
      keep_threshold < 0 || keep_threshold > 255 || seed_depth < 0 ||
      seed_depth > azt::kMaxSeedDepth ||
      (keep_threshold != 0 && seed_base == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const azt::AttnDropoutArg drop = {
      static_cast<uint32_t>(keep_threshold), keep_scale,
      azt::make_seed_path(seed_base, seed_depth, seed_sites)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (dtype == 0) {
    if (dim <= 64) {
      launch<float, 1>(q, k, v, mask, o, lse, bh, heads, seq, dim, scale,
                       drop, s);
    } else {
      launch<float, 2>(q, k, v, mask, o, lse, bh, heads, seq, dim, scale,
                       drop, s);
    }
  } else if (dim <= 32) {
    err = launch_mma<32>(q, k, v, mask, o, lse, bh, heads, seq, dim, scale,
                         drop, s);
  } else if (dim <= 64) {
    err = launch_mma<64>(q, k, v, mask, o, lse, bh, heads, seq, dim, scale,
                         drop, s);
  } else {
    err = launch_mma<128>(q, k, v, mask, o, lse, bh, heads, seq, dim, scale,
                          drop, s);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
