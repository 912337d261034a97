// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// two kernels, dK/dV and dQ, plus a helper that exports the attention
// dropout's keep-scale matrix for the checks.
//
// Replaces the three backward kernels of
// analytics_zoo_tpu/pallas/flash_attention.py, launched by `_flash_bwd`
// (L462): `_bwd_fused_kernel` (L407, `pl.pallas_call` at L497), `_dq_kernel`
// (L323, L540) and `_dkv_kernel` (L362, L562). The TPU picks the fused
// kernel or the pair by how many k-blocks fit its VMEM (`n_kb <= 4`, L496);
// that choice is about VMEM and does not carry over: here there is always
// the pair.
//
// What they compute, for each (batch*head), query row i and key j, from the
// forward's inputs, its lse and delta_i = rowsum(dO_i * O_i) (L480,
// computed outside the kernels as there):
//   P_ij  = exp((q_i . k_j) * scale + mask_j - lse_i)     softmax weights
//   dP_ij = (dO_i . v_j) * keep_ij
//   dS_ij = P_ij * (dP_ij - delta_i)
//   dV_j  = sum_i P_ij * keep_ij * dO_i
//   dK_j  = scale * sum_i dS_ij * q_i                        (L384-404)
//   dQ_i  = scale * sum_j dS_ij * k_j                        (L346-359)
// keep_ij is the forward's keep scale, regenerated from the seed by the
// same Philox byte rule (`philox.cuh`), so no mask is stored. Inputs are
// f32 or bf16, every sum is f32, dQ, dK and dV are written in the input
// dtype. The padding mask gets no gradient (zero in the TPU version,
// L594-596). Each kernel owns its output rows and loops over the other
// axis itself, so no partial sums cross blocks: deterministic, no atomics.
//
// What bounds them on an H100: the pair does 7 T x T x D products per head
// (the fused TPU kernel 5; dkv 4, dq 3), about 2*T FLOP per element moved,
// so they are bound by the products, then by the exponentials (one per
// score in each kernel) and, with dropout, by Philox's integer work.
//
// bf16 (`flash_bwd_dkv_mma_kernel`, `flash_bwd_dq_mma_kernel`): the
// products on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
// accumulate), operands by ldmatrix from padded shared memory, the walked
// tiles staged by cp.async and double-buffered (`mma.cuh`). Blocks of 4
// warps, 16 rows a warp, tiles of 64:
//   - dkv: one block owns one (b*h, 64 keys) and walks the query tiles; Q,
//     dO, lse and delta of 64 rows are double-buffered. It computes
//     S^T = K.Q^T and dP^T = V.dO^T in the transposed orientation, so the
//     accumulators of (P*keep)^T and dS^T are, rounded to bf16, the A
//     operands of dV += (P*keep)^T.dO and dK += dS^T.Q, with Q and dO
//     transposed by ldmatrix.trans: 4 products a tile. A warp's 16 keys
//     are one 16-key chunk of the byte rule, so the tile's keep bytes are
//     64 draws a warp, two a lane, traded by shuffle.
//   - dq: one block owns one (b*h, 64 query rows) and walks the key tiles
//     (K, V and the mask double-buffered): S = Q.K^T, dP = dO.V^T, then
//     dS = P * (dP * keep - delta) in registers, then dQ += dS.K with K
//     through ldmatrix.trans: 3 products. Dropout as in the forward.
//   - Q, dO (dq) and K, V (dkv) are read from shared memory by ldmatrix
//     one k-step at a time rather than held in registers: at D 64 the
//     four accumulator sets already take 128 registers a thread.
//   - ragged T and D: rows past T and columns past D are zero-filled in
//     shared memory; keys past T get a -inf score (dq), query rows past T
//     a +inf lse, so P = 0 (dkv); rows past T are never stored.
//   Shared memory: 6 tiles of 64 x (D_pad + 8) bf16 plus the staged
//   vectors: 55-56 KB at D_pad 64, above 48 KB by cudaFuncSetAttribute.
//
// f32 (`flash_bwd_dkv_kernel`, `flash_bwd_dq_kernel`, the first version,
// kept as it was): f32 FMAs on the CUDA cores (67 TFLOP/s), since the
// tensor cores would mean TF32:
//   - dkv: one block owns one (b*h, tile of 128/TPR keys); a thread owns a
//     32-wide slice of one key's k, v and its dK, dV accumulators in
//     registers (TPR = 1, 2, 4 threads per key for D <= 32, 64, 128; one
//     or two shuffles join the partial dots). The block walks the query
//     tiles, staging q, dO, lse and delta of 32-64 rows in shared memory,
//     read back as 16-byte broadcasts; the dropout keep bytes of a tile are
//     drawn once per tile into shared memory (one Philox call per 16 keys).
//   - dq: one block owns one (b*h, tile of 128/TPR query rows); a thread
//     owns a 32-wide slice of one row's q, dO and dQ accumulator, and walks
//     the key tiles staged in shared memory, 16 keys at a time, so one
//     Philox call gives the 16 keep bytes, as in the forward.
//   - ragged T: keys past T get a -inf bias (dq) or are never stored
//     (dkv); query rows past T are never visited (dkv) or stored (dq).
//   Threads past the end still run the loops, on zeros, so every lane
//   takes part in the shuffles.

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

constexpr int kThreads = 128;  // threads per block
constexpr int kGroups = 8;     // float4 groups one thread owns: 32 dims
constexpr int kChunk = 16;     // keys per step of the dq loop
constexpr float kLog2e = 1.4426950408889634f;

// Sum over the TPR neighbouring lanes that share one row.
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
  if (TPR >= 2) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
  }
  if (TPR >= 4) {
    x += __shfl_xor_sync(0xffffffffu, x, 2);
  }
  return x;
}

// A 32-wide slice of one row: thread h of the row's TPR lanes owns the
// float4 groups g = h + TPR*i, so neighbouring lanes read neighbouring
// 16-byte words.
template <typename T, int TPR>
__device__ __forceinline__ void load_slice(const T* row, int h, int dim,
                                           bool vec, bool ok, float4* out) {
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int d = 4 * (h + TPR * i);
    out[i] = (ok && d < dim) ? load_group(row, d, dim, vec)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T, int TPR>
__device__ __forceinline__ void store_slice(T* row, int h, int dim, bool vec,
                                            const float4* acc, float s) {
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int d = 4 * (h + TPR * i);
    if (d < dim) {
      store_group(row, d, dim, vec, azt::scale4(acc[i], s));
    }
  }
}

template <typename T, int TPR, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int seq, int dim,
                     float scale,
                     const __grid_constant__ azt::AttnDropoutArg drop_arg) {
  const azt::AttnDropout drop = azt::resolve<kDrop>(drop_arg);
  constexpr int kDMax = 32 * TPR;
  constexpr int kRowGroups = kDMax / 4;
  constexpr int kKeysPerBlock = kThreads / TPR;
  constexpr int kQRows = TPR == 4 ? 32 : 64;  // q rows per staged tile
  constexpr int kCol16 = kKeysPerBlock / kChunk;
  static_assert(kKeysPerBlock % kChunk == 0, "whole 16-key groups");

  __shared__ __align__(16) float qs[kQRows * kDMax];
  __shared__ __align__(16) float dos[kQRows * kDMax];
  __shared__ float lse_s[kQRows];  // log2 domain
  __shared__ float delta_s[kQRows];
  __shared__ uint8_t keep_s[kDrop ? kQRows * kKeysPerBlock : 1];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int tid = threadIdx.x;
  const int h = tid % TPR;
  const int key0 = blockIdx.x * kKeysPerBlock;
  const int jl = tid / TPR;
  const int key = key0 + jl;
  const bool key_ok = key < seq;
  const size_t head = (size_t)bh * seq * dim;
  const float scale_log2 = scale * kLog2e;
  const bool vec = dim % 4 == 0;

  float4 kr[kGroups], vr[kGroups], dk_acc[kGroups], dv_acc[kGroups];
  load_slice<T, TPR>(k + head + (size_t)key * dim, h, dim, vec, key_ok, kr);
  load_slice<T, TPR>(v + head + (size_t)key * dim, h, dim, vec, key_ok, vr);
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    dk_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[i] = dk_acc[i];
  }
  const float mj = (key_ok && mask != nullptr)
                       ? mask[(size_t)b * seq + key] * kLog2e
                       : 0.f;

  for (int i0 = 0; i0 < seq; i0 += kQRows) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < kQRows * kRowGroups; e += kThreads) {
      const int r = e / kRowGroups;
      const int d = 4 * (e % kRowGroups);
      const int row = i0 + r;
      float4 qq = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 dd = qq;
      if (row < seq && d < dim) {
        qq = load_group(q + head + (size_t)row * dim, d, dim, vec);
        dd = load_group(dout + head + (size_t)row * dim, d, dim, vec);
      }
      store4(&qs[r * kDMax + d], qq);
      store4(&dos[r * kDMax + d], dd);
    }
    for (int r = tid; r < kQRows; r += kThreads) {
      const int row = i0 + r;
      lse_s[r] = row < seq ? lse[(size_t)bh * seq + row] * kLog2e : 0.f;
      delta_s[r] = row < seq ? delta[(size_t)bh * seq + row] : 0.f;
    }
    if (kDrop) {
      for (int e = tid; e < kQRows * kCol16; e += kThreads) {
        const int r = e / kCol16;
        const int c16 = e % kCol16;
        const azt::Philox4 bits = azt::attn_keep_bits(
            drop.k0, drop.k1, bh, i0 + r, key0 / kChunk + c16);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          keep_s[r * kKeysPerBlock + c16 * kChunk + c] =
              azt::keep_byte(bits, c) < drop.t;
        }
      }
    }
    __syncthreads();

    const int n_rows = min(kQRows, seq - i0);
    for (int r = 0; r < n_rows; ++r) {
      const float* qrow = &qs[r * kDMax];
      const float* drow = &dos[r * kDMax];
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int off = 4 * (h + TPR * i);
        s = dot4(load4(qrow + off), kr[i], s);
        dp = dot4(load4(drow + off), vr[i], dp);
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const float p = exp2f(fmaf(s, scale_log2, mj) - lse_s[r]);
      float pv = p;
      if (kDrop) {
        const float ksc = keep_s[r * kKeysPerBlock + jl] ? drop.keep_scale
                                                         : 0.f;
        pv = p * ksc;
        dp = dp * ksc;
      }
      const float ds = p * (dp - delta_s[r]);
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int off = 4 * (h + TPR * i);
        axpy4(pv, load4(drow + off), dv_acc[i]);
        axpy4(ds, load4(qrow + off), dk_acc[i]);
      }
    }
  }

  if (key_ok) {
    store_slice<T, TPR>(dk + head + (size_t)key * dim, h, dim, vec, dk_acc,
                        scale);
    store_slice<T, TPR>(dv + head + (size_t)key * dim, h, dim, vec, dv_acc,
                        1.f);
  }
}

template <typename T, int TPR, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ mask,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int heads, int seq, int dim, float scale,
                    const __grid_constant__ azt::AttnDropoutArg drop_arg) {
  const azt::AttnDropout drop = azt::resolve<kDrop>(drop_arg);
  constexpr int kDMax = 32 * TPR;
  constexpr int kRowGroups = kDMax / 4;
  constexpr int kRows = kThreads / TPR;  // query rows per block
  constexpr int kKeys = 4096 / kDMax;    // keys per tile: K+V = 32 KB f32
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

  float4 qr[kGroups], dor[kGroups], dq_acc[kGroups];
  load_slice<T, TPR>(q + head + (size_t)row * dim, h, dim, vec, row_ok, qr);
  load_slice<T, TPR>(dout + head + (size_t)row * dim, h, dim, vec, row_ok,
                     dor);
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    dq_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float lse_i = row_ok ? lse[(size_t)bh * seq + row] * kLog2e : 0.f;
  const float delta_i = row_ok ? delta[(size_t)bh * seq + row] : 0.f;

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
      float dp[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float* kr = &ks[(c0 + c) * kDMax];
        const float* vr = &vs[(c0 + c) * kDMax];
        float a = 0.f;
        float bsum = 0.f;
#pragma unroll
        for (int i = 0; i < kGroups; ++i) {
          const int off = 4 * (h + TPR * i);
          a = dot4(qr[i], load4(kr + off), a);
          bsum = dot4(dor[i], load4(vr + off), bsum);
        }
        s[c] = row_sum<TPR>(a);
        dp[c] = row_sum<TPR>(bsum);
      }
      azt::Philox4 bits = {};
      if (kDrop) {
        bits = azt::attn_keep_bits(drop.k0, drop.k1, bh, row,
                                   (k0 + c0) / kChunk);
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p =
            exp2f(fmaf(s[c], scale_log2, ms[c0 + c]) - lse_i);
        float dpk = dp[c];
        if (kDrop) {
          dpk = azt::keep_byte(bits, c) < drop.t ? dpk * drop.keep_scale
                                                 : 0.f;
        }
        s[c] = p * (dpk - delta_i);  // dS
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float* kr = &ks[(c0 + c) * kDMax];
#pragma unroll
        for (int i = 0; i < kGroups; ++i) {
          axpy4(s[c], load4(kr + 4 * (h + TPR * i)), dq_acc[i]);
        }
      }
    }
  }

  if (row_ok) {
    store_slice<T, TPR>(dq + head + (size_t)row * dim, h, dim, vec, dq_acc,
                        scale);
  }
}

// The bf16 dK/dV kernel on the tensor cores (see the note at the top).
// DP: the head dim padded to 32, 64 or 128.
template <int DP, bool kDrop>
__global__ void __launch_bounds__(azt::mma::kThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int heads, int seq,
                         int dim, float scale,
                         const __grid_constant__ azt::AttnDropoutArg drop_arg) {
  const azt::AttnDropout drop = azt::resolve<kDrop>(drop_arg);
  using namespace azt::mma;
  constexpr int kElems = tile_elems<DP>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kElems;
  bf16* qs = vs + kElems;       // two buffers
  bf16* dos = qs + 2 * kElems;  // two buffers
  float* ls = reinterpret_cast<float*>(dos + 2 * kElems);  // two rows of 64
  float* dls = ls + 2 * kTile;                              // two rows of 64

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = blockIdx.x * kTile;
  const int key = key0 + warp * 16 + g;  // and key + 8
  const size_t head = (size_t)bh * seq * dim;
  const size_t vrow = (size_t)bh * seq;  // lse, delta
  const bool vec = dim % 8 == 0;
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = (seq + kTile - 1) / kTile;
  float bias[2];  // the mask of the lane's two keys, log2 domain
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key + 8 * r;
    bias[r] = (mask != nullptr && j < seq)
                  ? mask[(size_t)b * seq + j] * kLog2e
                  : 0.f;
  }

  auto stage_q = [&](int i) {
    const int buf = i & 1;
    stage_rows<DP>(qs + buf * kElems, q + head, i * kTile, seq, dim, vec,
                   tid);
    stage_rows<DP>(dos + buf * kElems, dout + head, i * kTile, seq, dim, vec,
                   tid);
    if (tid < kTile) {
      stage_float(ls + buf * kTile, lse + vrow, i * kTile, seq, tid);
    } else {
      stage_float(dls + buf * kTile, delta + vrow, i * kTile, seq,
                  tid - kTile);
    }
    cp_async_commit();
  };

  stage_rows<DP>(ks, k + head, key0, seq, dim, vec, tid);
  stage_rows<DP>(vs, v + head, key0, seq, dim, vec, tid);
  cp_async_commit();
  stage_q(0);

  float dk_acc[DP / 8][4] = {};
  float dv_acc[DP / 8][4] = {};

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) {
      stage_q(i + 1);  // overwrites the buffer tile i - 1 used
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = i * kTile;
    const bf16* qt = qs + buf * kElems;
    const bf16* dot = dos + buf * kElems;
    const float* lt = ls + buf * kTile;
    const float* dlt = dls + buf * kTile;

    float s[8][4] = {};   // S^T: rows the warp's 16 keys, columns queries
    float dp[8][4] = {};  // dP^T
    gemm_nt<DP>(s, ks, warp * 16, qt, lane);
    gemm_nt<DP>(dp, vs, warp * 16, dot, lane);

    // Keep bits: the warp's 16 keys are chunk c16 of the byte rule. Lane L
    // draws query rows q0 + L and q0 + L + 32 (16 keys each) and packs the
    // two masks into one word; the lane that holds query column c reads
    // word c % 32, half c / 32.
    uint32_t mine = 0;
    if (kDrop) {
      const uint32_t c16 = (key0 + warp * 16) / 16;
      mine = keep_mask16(azt::attn_keep_bits(drop.k0, drop.k1, bh, q0 + lane,
                                             c16),
                         drop.t) |
             keep_mask16(azt::attn_keep_bits(drop.k0, drop.k1, bh,
                                             q0 + lane + 32, c16),
                         drop.t)
                 << 16;
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t bits = 0;
        if (kDrop) {
          bits = __shfl_sync(0xffffffffu, mine, nb * 8 + 2 * t + e);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int blk = nb + 4 * h;
          const int c = blk * 8 + 2 * t + e;  // query column in the tile
          // rows past T: P = 0 (their q and dO are zero-filled)
          const float lse_c = q0 + c < seq ? lt[c] * kLog2e : INFINITY;
          const float delta_c = dlt[c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int el = 2 * r + e;
            const float p =
                exp2f(fmaf(s[blk][el], scale_log2, bias[r]) - lse_c);
            float dpk = dp[blk][el];
            float pk = p;
            if (kDrop) {
              const bool keep = (bits >> (16 * h + g + 8 * r)) & 1u;
              dpk = keep ? dpk * drop.keep_scale : 0.f;
              pk = keep ? p * drop.keep_scale : 0.f;
            }
            dp[blk][el] = p * (dpk - delta_c);  // dS^T
            s[blk][el] = pk;                    // (P * keep)^T
          }
        }
      }
    }
    gemm_wb<DP>(dv_acc, s, dot, lane);
    gemm_wb<DP>(dk_acc, dp, qt, lane);
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key + 8 * r;
    if (j >= seq) {
      continue;
    }
    bf16* dkr = dk + head + (size_t)j * dim;
    bf16* dvr = dv + head + (size_t)j * dim;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int c = nb * 8 + 2 * t;
      const float k0 = dk_acc[nb][2 * r] * scale;
      const float k1 = dk_acc[nb][2 * r + 1] * scale;
      const float v0 = dv_acc[nb][2 * r];
      const float v1 = dv_acc[nb][2 * r + 1];
      if (vec) {
        if (c < dim) {
          *reinterpret_cast<__nv_bfloat162*>(dkr + c) =
              __floats2bfloat162_rn(k0, k1);
          *reinterpret_cast<__nv_bfloat162*>(dvr + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      } else {
        if (c < dim) {
          dkr[c] = __float2bfloat16(k0);
          dvr[c] = __float2bfloat16(v0);
        }
        if (c + 1 < dim) {
          dkr[c + 1] = __float2bfloat16(k1);
          dvr[c + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// The bf16 dQ kernel on the tensor cores.
template <int DP, bool kDrop>
__global__ void __launch_bounds__(azt::mma::kThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ mask,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int heads, int seq,
                        int dim, float scale,
                        const __grid_constant__ azt::AttnDropoutArg drop_arg) {
  const azt::AttnDropout drop = azt::resolve<kDrop>(drop_arg);
  using namespace azt::mma;
  constexpr int kElems = tile_elems<DP>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kElems;
  bf16* ks = dos + kElems;     // two buffers
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
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    lse_r[r] = i < seq ? lse[(size_t)bh * seq + i] * kLog2e : 0.f;
    delta_r[r] = i < seq ? delta[(size_t)bh * seq + i] : 0.f;
  }

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
  stage_rows<DP>(dos, dout + head, q0, seq, dim, vec, tid);
  cp_async_commit();
  stage_kv(0);

  float dq_acc[DP / 8][4] = {};

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
    const bf16* kt = ks + buf * kElems;
    const float* mt = ms + buf * kTile;

    float s[8][4] = {};
    float dp[8][4] = {};
    gemm_nt<DP>(s, qs, warp * 16, kt, lane);
    gemm_nt<DP>(dp, dos, warp * 16, vs + buf * kElems, lane);
    if (kDrop) {
      keep_rows(dp, drop, bh, row, key0, lane);
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nb * 8 + 2 * t + (e & 1);
        float bias = -INFINITY;  // keys past T never count
        if (key0 + c < seq) {
          bias = mrow != nullptr ? mt[c] * kLog2e : 0.f;
        }
        const float p =
            exp2f(fmaf(s[nb][e], scale_log2, bias) - lse_r[e >> 1]);
        s[nb][e] = p * (dp[nb][e] - delta_r[e >> 1]);  // dS
      }
    }
    gemm_wb<DP>(dq_acc, s, kt, lane);
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i >= seq) {
      continue;
    }
    bf16* dqr = dq + head + (size_t)i * dim;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int c = nb * 8 + 2 * t;
      const float x0 = dq_acc[nb][2 * r] * scale;
      const float x1 = dq_acc[nb][2 * r + 1] * scale;
      if (vec) {
        if (c < dim) {
          *reinterpret_cast<__nv_bfloat162*>(dqr + c) =
              __floats2bfloat162_rn(x0, x1);
        }
      } else {
        if (c < dim) {
          dqr[c] = __float2bfloat16(x0);
        }
        if (c + 1 < dim) {
          dqr[c + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

__global__ void keep_scale_kernel(
    float* __restrict__ out, int bh_count, int seq,
    const __grid_constant__ azt::AttnDropoutArg drop_arg) {
  const azt::AttnDropout drop = azt::resolve<true>(drop_arg);
  const int n16 = (seq + kChunk - 1) / kChunk;
  const long long total = (long long)bh_count * seq * n16;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int c16 = static_cast<int>(e % n16);
    const long long rest = e / n16;
    const int row = static_cast<int>(rest % seq);
    const int bh = static_cast<int>(rest / seq);
    const azt::Philox4 bits =
        azt::attn_keep_bits(drop.k0, drop.k1, bh, row, c16);
    float* dst = out + ((size_t)bh * seq + row) * seq + c16 * kChunk;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c16 * kChunk + c < seq) {
        dst[c] = azt::keep_byte(bits, c) < drop.t ? drop.keep_scale : 0.f;
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, heads, seq, dim;
  float scale;
  azt::AttnDropoutArg drop;
  cudaStream_t stream;
};

template <typename T, int TPR, bool kDrop>
void launch_dkv(const Args& a) {
  constexpr int kKeysPerBlock = kThreads / TPR;
  const dim3 grid((a.seq + kKeysPerBlock - 1) / kKeysPerBlock, a.bh);
  flash_bwd_dkv_kernel<T, TPR, kDrop><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.heads, a.seq, a.dim, a.scale, a.drop);
}

template <typename T, int TPR, bool kDrop>
void launch_dq(const Args& a) {
  constexpr int kRows = kThreads / TPR;
  const dim3 grid((a.seq + kRows - 1) / kRows, a.bh);
  flash_bwd_dq_kernel<T, TPR, kDrop><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.heads,
      a.seq, a.dim, a.scale, a.drop);
}

template <typename T, int TPR>
void dkv_by_drop(const Args& a) {
  if (a.drop.t != 0) {
    launch_dkv<T, TPR, true>(a);
  } else {
    launch_dkv<T, TPR, false>(a);
  }
}

template <typename T, int TPR>
void dq_by_drop(const Args& a) {
  if (a.drop.t != 0) {
    launch_dq<T, TPR, true>(a);
  } else {
    launch_dq<T, TPR, false>(a);
  }
}

template <typename T>
void dkv_by_dim(const Args& a) {
  if (a.dim <= 32) {
    dkv_by_drop<T, 1>(a);
  } else if (a.dim <= 64) {
    dkv_by_drop<T, 2>(a);
  } else {
    dkv_by_drop<T, 4>(a);
  }
}

template <typename T>
void dq_by_dim(const Args& a) {
  if (a.dim <= 32) {
    dq_by_drop<T, 1>(a);
  } else if (a.dim <= 64) {
    dq_by_drop<T, 2>(a);
  } else {
    dq_by_drop<T, 4>(a);
  }
}

// Dynamic shared memory of the bf16 kernels: six tiles and the staged
// vectors (dkv: lse and delta, two buffers each; dq: two mask rows).
template <int DP>
constexpr int dkv_mma_smem_bytes() {
  return 6 * azt::mma::tile_elems<DP>() * 2 + 4 * azt::mma::kTile * 4;
}

template <int DP>
constexpr int dq_mma_smem_bytes() {
  return 6 * azt::mma::tile_elems<DP>() * 2 + 2 * azt::mma::kTile * 4;
}

template <int DP, bool kDrop>
cudaError_t launch_dkv_mma(const Args& a) {
  constexpr int kBytes = dkv_mma_smem_bytes<DP>();
  auto kernel = flash_bwd_dkv_mma_kernel<DP, kDrop>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid((a.seq + azt::mma::kTile - 1) / azt::mma::kTile, a.bh);
  using bf = __nv_bfloat16;
  kernel<<<grid, azt::mma::kThreads, kBytes, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const bf*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf*>(a.dk),
      static_cast<bf*>(a.dv), a.heads, a.seq, a.dim, a.scale, a.drop);
  return cudaSuccess;
}

template <int DP, bool kDrop>
cudaError_t launch_dq_mma(const Args& a) {
  constexpr int kBytes = dq_mma_smem_bytes<DP>();
  auto kernel = flash_bwd_dq_mma_kernel<DP, kDrop>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid((a.seq + azt::mma::kTile - 1) / azt::mma::kTile, a.bh);
  using bf = __nv_bfloat16;
  kernel<<<grid, azt::mma::kThreads, kBytes, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const bf*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf*>(a.dq), a.heads,
      a.seq, a.dim, a.scale, a.drop);
  return cudaSuccess;
}

template <int DP>
cudaError_t dkv_mma_by_drop(const Args& a) {
  return a.drop.t != 0 ? launch_dkv_mma<DP, true>(a)
                       : launch_dkv_mma<DP, false>(a);
}

template <int DP>
cudaError_t dq_mma_by_drop(const Args& a) {
  return a.drop.t != 0 ? launch_dq_mma<DP, true>(a)
                       : launch_dq_mma<DP, false>(a);
}

cudaError_t dkv_mma_by_dim(const Args& a) {
  if (a.dim <= 32) {
    return dkv_mma_by_drop<32>(a);
  }
  return a.dim <= 64 ? dkv_mma_by_drop<64>(a) : dkv_mma_by_drop<128>(a);
}

cudaError_t dq_mma_by_dim(const Args& a) {
  if (a.dim <= 32) {
    return dq_mma_by_drop<32>(a);
  }
  return a.dim <= 64 ? dq_mma_by_drop<64>(a) : dq_mma_by_drop<128>(a);
}

bool valid(int bh, int heads, int seq, int dim, int dtype, int t,
           const void* seed_base, int seed_depth) {
  return bh > 0 && bh <= 65535 && heads > 0 && bh % heads == 0 && seq > 0 &&
         dim > 0 && dim <= 128 && (dtype == 0 || dtype == 1) && t >= 0 &&
         t <= 255 && seed_depth >= 0 && seed_depth <= azt::kMaxSeedDepth &&
         (t == 0 || seed_base != nullptr);
}

Args make_args(const void* q, const void* k, const void* v, const void* mask,
               const void* dout, const void* lse, const void* delta,
               void* dq, void* dk, void* dv, int bh, int heads, int seq,
               int dim, float scale, const azt::SeedPath& seed,
               int keep_threshold, float keep_scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.bh = bh;
  a.heads = heads;
  a.seq = seq;
  a.dim = dim;
  a.scale = scale;
  a.drop = {static_cast<uint32_t>(keep_threshold), keep_scale, seed};
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dk, dv: contiguous
// [bh, seq, dim], 16-byte aligned, dim <= 128; mask: contiguous f32
// [bh / heads, seq] or null; lse, delta: f32 [bh, seq]. keep_threshold:
// the byte rule's t in [1, 255], or 0 for no dropout; keep_scale = 256 / t.
// The seed: the int64 at `seed_base` (device memory) taken through the
// `seed_depth` (<= 8) site indices of the host array `seed_sites`, as in
// `azt_flash_attn_fwd`. Returns the cudaError_t of the launch (0 on
// success).
int azt_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                           const void* mask, const void* dout,
                           const void* lse, const void* delta, void* dk,
                           void* dv, int bh, int heads, int seq, int dim,
                           float scale, int dtype, const void* seed_base,
                           int seed_depth, const long long* seed_sites,
                           int keep_threshold, float keep_scale,
                           void* stream) {
  if (!valid(bh, heads, seq, dim, dtype, keep_threshold, seed_base,
             seed_depth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = make_args(
      q, k, v, mask, dout, lse, delta, nullptr, dk, dv, bh, heads, seq, dim,
      scale, azt::make_seed_path(seed_base, seed_depth, seed_sites),
      keep_threshold, keep_scale, stream);
  if (dtype == 0) {
    dkv_by_dim<float>(a);
  } else {
    const cudaError_t err = dkv_mma_by_dim(a);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// As `azt_flash_attn_bwd_dkv`, writing dq [bh, seq, dim].
int azt_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                          const void* mask, const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int heads,
                          int seq, int dim, float scale, int dtype,
                          const void* seed_base, int seed_depth,
                          const long long* seed_sites, int keep_threshold,
                          float keep_scale, void* stream) {
  if (!valid(bh, heads, seq, dim, dtype, keep_threshold, seed_base,
             seed_depth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = make_args(
      q, k, v, mask, dout, lse, delta, dq, nullptr, nullptr, bh, heads, seq,
      dim, scale, azt::make_seed_path(seed_base, seed_depth, seed_sites),
      keep_threshold, keep_scale, stream);
  if (dtype == 0) {
    dq_by_dim<float>(a);
  } else {
    const cudaError_t err = dq_mma_by_dim(a);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The attention dropout's keep-scale matrix: out f32 [bh, seq, seq] gets
// keep_scale where the byte of (seed, b*h, row, column) is below
// keep_threshold (in [1, 255]), else 0; the seed as in
// `azt_flash_attn_fwd`. A test aid: the checks hand it to the plain
// version as an injected mask.
int azt_attn_keep_scale(void* out, int bh, int seq, const void* seed_base,
                        int seed_depth, const long long* seed_sites,
                        int keep_threshold, float keep_scale, void* stream) {
  if (bh <= 0 || seq <= 0 || keep_threshold < 1 || keep_threshold > 255 ||
      seed_base == nullptr || seed_depth < 0 ||
      seed_depth > azt::kMaxSeedDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const azt::AttnDropoutArg drop = {
      static_cast<uint32_t>(keep_threshold), keep_scale,
      azt::make_seed_path(seed_base, seed_depth, seed_sites)};
  const long long total =
      (long long)bh * seq * ((seq + kChunk - 1) / kChunk);
  long long blocks = (total + 255) / 256;
  blocks = blocks < 132 * 16 ? blocks : 132 * 16;
  keep_scale_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), bh, seq, drop);
  return static_cast<int>(cudaGetLastError());
}

const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
