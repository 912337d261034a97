// Decode attention for Hopper (sm_90a), contiguous and paged, with a plain
// C interface.
//
// Replaces the two kernels of analytics_zoo_tpu/pallas/decode_attention.py:
// `_decode_kernel` (L113, launched by `decode_attention` through
// `pl.pallas_call` at L181) over the contiguous KV pool, and
// `_paged_kernel` (L225, `paged_decode_attention`, L327) over the block
// pool through per-sequence block tables.
//
// What it computes. One query row per (slot s, head h): q[s, h, :] against
// the first kv_bucket positions of the slot's keys and values, positions at
// or past lengths[s] masked with -1e30 (not -inf), softmax across keys in
// f32, scores scaled by 1/sqrt(D), the weights rounded to the pool's dtype
// before the PV product (a no-op in f32), the sum in f32, the output cast
// to q's dtype. The TPU kernels walk the keys in blocks of 128 (contiguous)
// or block_len (paged) with an online softmax in VMEM scratch.
//
// One template serves both layouts: the address of logical position `pos`
// is the only difference,
//   contiguous: ((s*H + h)*L + pos)*D
//   paged:      ((tables[s, pos/block_len]*H + h)*block_len
//                + pos%block_len)*D,
// and every thread visits the same logical positions in the same order
// whatever block_len is, so the paged kernel's output equals the
// contiguous kernel's bit for bit on the same logical bytes.
//
// What bounds it on an H100: every live key and value row is read once,
// 2*D*itemsize bytes a position, against 4*D flops a position, so it is
// memory-bound: 2*S*H*n*D*itemsize bytes at 3.35 TB/s, where n is the live
// length of each slot (keys past lengths[s] are not read: their weight is
// exactly 0 in f32). At S=32, H=12, D=64, f32 and every slot at 1024
// positions that is 201 MB, 60 us a layer.
//
// What its design does about that: one block of 256 threads per (s, h).
// A group of G threads (G the power of two covering D/4, 16 for D=64)
// takes one key at a time, each thread four consecutive elements of the
// row (one 16-byte load in f32, 8 bytes in bf16), so a warp reads whole
// rows of neighbouring positions; the group's score is a butterfly sum
// over its lanes. Group g of the block takes positions
// (it*4 + j)*NG + g for j < 4 in iteration `it` (NG groups in the block):
// four keys' and values' loads are in flight before their softmax update,
// which keeps (m, l, acc) for the group in registers. A fixed-order
// combine in shared memory merges the NG groups' states. The paged
// kernel first copies the slot's block table into shared memory, so the
// indirection costs no extra device-memory latency per key. Split-K over
// the keys (flash-decoding) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxDim = 128;
constexpr float kMasked = -1e30f;
// The kernel's static shared memory (m_s, l_s, w_s, acc_s below); the
// paged kernel's table takes dynamic shared memory on top of it, and a
// block may hold 48 KB of the two without opting in to more.
constexpr size_t kStaticSmem = sizeof(float) * kThreads * 7;
constexpr size_t kMaxSmem = 48 * 1024;

// A softmax weight as the PV product takes it: rounded to the pool's dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        const int* __restrict__ tables, T* __restrict__ out,
                        int H, int rows, int D, int table_stride,
                        int kv_bucket, float scale, int group, bool vec) {
  // rows: L (positions a slot holds) when contiguous, block_len when paged
  extern __shared__ int tbl_s[];
  __shared__ float m_s[kThreads];
  __shared__ float l_s[kThreads];
  __shared__ float w_s[kThreads];
  __shared__ float acc_s[kThreads * 4];  // n_groups * D <= 4 * kThreads

  const int bh = blockIdx.x;
  const int s = bh / H;
  const int h = bh - s * H;
  const int tid = threadIdx.x;
  const int n_groups = kThreads / group;
  const int g = tid / group;
  const int lane = tid - g * group;
  const int d0 = lane * 4;
  const bool active = d0 < D;

  // Live keys: the first min(lengths[s], kv_bucket) positions. The
  // wrapper's contract is lengths[s] >= 1; a slot below it visits no key
  // and its row is undefined.
  const int n = min(lengths[s], kv_bucket);

  if (kPaged) {
    const int n_tbl = (n + rows - 1) / rows;
    for (int i = tid; i < n_tbl; i += kThreads) {
      tbl_s[i] = tables[static_cast<long long>(s) * table_stride + i];
    }
    __syncthreads();
  }

  const long long q_row = static_cast<long long>(bh) * D;
  const float4 q4 = active ? azt::load_group(q + q_row, d0, D, vec)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kMasked;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  // The loop runs while the warp's first group has a key, so the lanes of
  // a warp take the same trip count (the shuffles need the whole warp);
  // a key past `n` changes no state.
  const int warp_first = (tid & ~31) / group;
  for (int it = 0; it * kUnroll * n_groups + warp_first < n; ++it) {
    float4 kk[kUnroll];
    float4 vv[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int pos = (it * kUnroll + j) * n_groups + g;
      valid[j] = pos < n;
      kk[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      vv[j] = kk[j];
      if (valid[j] && active) {
        long long row;
        if (kPaged) {
          const int blk = tbl_s[pos / rows];
          row = ((static_cast<long long>(blk) * H + h) * rows + pos % rows) *
                D;
        } else {
          row = (static_cast<long long>(bh) * rows + pos) * D;
        }
        kk[j] = azt::load_group(k + row, d0, D, vec);
        vv[j] = azt::load_group(v + row, d0, D, vec);
      }
    }
    float sc[kUnroll];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      float part = azt::dot4(q4, kk[j], 0.f);
      for (int off = group >> 1; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      sc[j] = part * scale;
      if (valid[j]) {
        mx = fmaxf(mx, sc[j]);
      }
    }
    const float alpha = expf(m - mx);
    l *= alpha;
    acc = azt::scale4(acc, alpha);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (valid[j]) {
        const float p = expf(sc[j] - mx);
        l += p;
        azt::axpy4(round_to<T>(p), vv[j], acc);
      }
    }
    m = mx;
  }

  // fixed-order combine of the groups' (m, l, acc)
  if (lane == 0) {
    m_s[g] = m;
    l_s[g] = l;
  }
  const float a4[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (d0 + e < D) {
      acc_s[g * D + d0 + e] = a4[e];
    }
  }
  __syncthreads();
  float big = kMasked;
  for (int i = 0; i < n_groups; ++i) {
    big = fmaxf(big, m_s[i]);
  }
  if (tid < n_groups) {
    w_s[tid] = expf(m_s[tid] - big);
  }
  __syncthreads();
  if (tid < D) {
    float total = 0.f;
    float o = 0.f;
    for (int i = 0; i < n_groups; ++i) {
      total = fmaf(l_s[i], w_s[i], total);
      o = fmaf(acc_s[i * D + tid], w_s[i], o);
    }
    azt::from_float(out + q_row + tid, o / total);
  }
}

int group_for(int D) {
  int g = 1;
  while (g * 4 < D) {
    g *= 2;
  }
  return g;
}

template <bool kPaged>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* lengths, void* out, int S, int H, int rows, int D,
           int table_stride, int kv_bucket, float scale, int dtype,
           int vec, size_t smem, cudaStream_t st) {
  const int group = group_for(D);
  const unsigned blocks = static_cast<unsigned>(S) * static_cast<unsigned>(H);
  const int* len = static_cast<const int*>(lengths);
  const int* tbl = static_cast<const int*>(tables);
  if (dtype == 0) {
    decode_attention_kernel<float, kPaged><<<blocks, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), len, tbl, static_cast<float*>(out), H,
        rows, D, table_stride, kv_bucket, scale, group, vec != 0);
  } else {
    decode_attention_kernel<__nv_bfloat16, kPaged>
        <<<blocks, kThreads, smem, st>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), len, tbl,
            static_cast<__nv_bfloat16*>(out), H, rows, D, table_stride,
            kv_bucket, scale, group, vec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_common(int S, int H, int D, int kv_bucket, int dtype) {
  return S <= 0 || H <= 0 || D <= 0 || D > kMaxDim || kv_bucket <= 0 ||
         dtype < 0 || dtype > 1;
}

}  // namespace

extern "C" {

// q [S, H, D]; k, v [S, H, L, D] (the whole pool; positions
// [0, kv_bucket) are read); lengths int32 [S]; out [S, H, D]. dtype 0 f32,
// 1 bf16 (q, pools and out alike). `vec`: D % 4 == 0 and every base
// pointer 16-byte aligned. Returns the cudaError_t of the launch.
int azt_decode_attention(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, int S, int H, int L,
                         int D, int kv_bucket, float scale, int dtype,
                         int vec, void* stream) {
  if (bad_common(S, H, D, kv_bucket, dtype) || kv_bucket > L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<false>(q, k, v, nullptr, lengths, out, S, H, L, D, 0,
                       kv_bucket, scale, dtype, vec, 0,
                       static_cast<cudaStream_t>(stream));
}

// q [S, H, D]; k, v [num_blocks, H, block_len, D]; tables int32
// [S, table_stride] with table_stride >= kv_bucket / block_len; lengths
// int32 [S]; out [S, H, D]. kv_bucket a positive multiple of block_len.
// Other arguments as above. Returns the cudaError_t of the launch.
int azt_paged_decode_attention(const void* q, const void* k, const void* v,
                               const void* tables, const void* lengths,
                               void* out, int S, int H, int block_len, int D,
                               int table_stride, int kv_bucket, float scale,
                               int dtype, int vec, void* stream) {
  if (bad_common(S, H, D, kv_bucket, dtype) || block_len <= 0 ||
      kv_bucket % block_len != 0 || table_stride < kv_bucket / block_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      static_cast<size_t>(kv_bucket / block_len) * sizeof(int);
  if (smem + kStaticSmem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<true>(q, k, v, tables, lengths, out, S, H, block_len, D,
                      table_stride, kv_bucket, scale, dtype, vec, smem,
                      static_cast<cudaStream_t>(stream));
}

const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
