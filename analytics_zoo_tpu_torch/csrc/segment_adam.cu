// Row-sparse (segment) Adam for Hopper (sm_90a), with a plain C interface.
//
// Replaces `_row_kernel` of analytics_zoo_tpu/pallas/segment_update.py
// (L77), launched there by `kernel_apply` (L120) through `pl.pallas_call`
// (L144) over a grid of B slots, with the table and its moments aliased to
// the outputs (in place). Also holds the segment sum that
// `segment_compact` (L50) leaves to XLA's scatter-add there.
//
// What it computes. The batch's embedding ids are sorted and merged into
// slots (`kernels/segment_update.py:segment_compact`): slot j holds the
// j-th distinct id `uids[j]` and the sum `g_slots[j]` of that id's
// per-example row gradients; `valid[j]` is 1 for the distinct slots and 0
// for the tail. Two kernels:
//
// - `segment_sum`: for each run of equal ids in sorted order, the sum of
//   the run's gradient rows, added left to right in sorted (stable) order
//   — the order in which the plain version's `index_add_` adds on the CPU —
//   so the result is the same on every call (no atomics) and equals the
//   plain version bit for bit;
// - `segment_adam` (the ported kernel): for each valid slot j, row
//   r = uids[j] of (p, m, v) takes the Adam update of `azt::adam_update`
//   (common.cuh, shared with the fused-Adam kernel) with gradient
//   g_slots[j], the bias correction folded into (a, b) and the weight decay
//   lrwd that the segment path sets to 0.
//   Nothing else is read or written: untouched rows stay the same bytes.
//
// Not carried over block by block: the TPU's grid needs a target block for
// every slot, so its invalid slots point at the last valid row and skip
// their writes. Here an invalid slot does nothing. Valid slots hold
// distinct rows, so no two threads write one element and no atomics are
// needed.
//
// What bounds it on an H100: per valid slot it reads the slot's gradient
// row and p, m, v of its table row and writes p, m, v back — 7 row passes
// (`segment_adam_cost`, L95), about 12 operations per element — so it is a
// memory gather/scatter: n_valid * dim * (4 + 2 * p_itemsize + 16) bytes at
// 3.35 TB/s, 4.4 us at B = 8192, dim 64, f32.
//
// What its design does about that: one thread takes one 4-wide group of
// one slot's row (16 threads for dim 64), so a warp reads two whole
// 256-byte rows of each array with 16-byte accesses (8-byte for a bf16
// table) and a row's bytes are read and written once. Rows of any width
// work, element by element where dim is not a multiple of 4. At this size
// the launch itself (host side) takes longer than the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ d_rows,
                   const int* __restrict__ sids,
                   const int* __restrict__ order, const int* __restrict__ seg,
                   float* __restrict__ g_slots, int n, int dim, int groups,
                   bool vec) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int k = static_cast<int>(t / groups);
  if (k >= n) {
    return;
  }
  const int id = sids[k];
  if (k > 0 && sids[k - 1] == id) {
    return;  // not the first entry of its run
  }
  const int d = static_cast<int>(t % groups) * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = k; e < n && sids[e] == id; ++e) {
    const float4 x = azt::load_group(
        d_rows + static_cast<long long>(order[e]) * dim, d, dim, vec);
    acc.x = __fadd_rn(acc.x, x.x);
    acc.y = __fadd_rn(acc.y, x.y);
    acc.z = __fadd_rn(acc.z, x.z);
    acc.w = __fadd_rn(acc.w, x.w);
  }
  azt::store_group(g_slots + static_cast<long long>(seg[k]) * dim, d, dim,
                   vec, acc);
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
segment_adam_kernel(P* __restrict__ p, float* __restrict__ m,
                    float* __restrict__ v, const int* __restrict__ uids,
                    const int* __restrict__ valid,
                    const float* __restrict__ g_slots, int n_slots, int dim,
                    long long n_rows, int groups, bool vec,
                    const float* __restrict__ folded,
                    azt::AdamScalars consts) {
  // the step's scalars first: their loads overlap the slot's
  const azt::AdamScalars s = azt::with_folded(consts, folded);
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int j = static_cast<int>(t / groups);
  if (j >= n_slots || valid[j] == 0) {
    return;
  }
  const long long r = uids[j];
  if (r < 0 || r >= n_rows) {
    return;  // the gather of the same ids upstream faults on such an id
  }
  const int d = static_cast<int>(t % groups) * 4;
  const long long off = r * dim;
  float4 pv = azt::load_group(p + off, d, dim, vec);
  float4 mv = azt::load_group(m + off, d, dim, vec);
  float4 vv = azt::load_group(v + off, d, dim, vec);
  const float4 gv = azt::load_group(
      g_slots + static_cast<long long>(j) * dim, d, dim, vec);
  azt::adam_update(pv.x, mv.x, vv.x, gv.x, s);
  azt::adam_update(pv.y, mv.y, vv.y, gv.y, s);
  azt::adam_update(pv.z, mv.z, vv.z, gv.z, s);
  azt::adam_update(pv.w, mv.w, vv.w, gv.w, s);
  azt::store_group(p + off, d, dim, vec, pv);
  azt::store_group(m + off, d, dim, vec, mv);
  azt::store_group(v + off, d, dim, vec, vv);
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// d_rows [n, dim] f32, gradient rows in batch order; sids [n] the ids
// sorted (stable), order [n] the batch position of each sorted entry, seg
// [n] the slot of each sorted entry (int32 each); g_slots [n, dim] f32,
// zero-filled by the caller (its tail past the last slot stays zero).
// `vec`: dim % 4 == 0 and every row 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success).
int azt_segment_sum(const void* d_rows, const void* sids, const void* order,
                    const void* seg, void* g_slots, int n, int dim, int vec,
                    void* stream) {
  if (n <= 0 || dim <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (dim + 3) / 4;
  segment_sum_kernel<<<blocks_for(static_cast<long long>(n) * groups),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_rows), static_cast<const int*>(sids),
      static_cast<const int*>(order), static_cast<const int*>(seg),
      static_cast<float*>(g_slots), n, dim, groups, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

// p [n_rows, dim] f32 (p_dtype 0) or bf16 (1), m and v [n_rows, dim] f32,
// updated in place; uids, valid [n_slots] int32; g_slots [n_slots, dim]
// f32. folded: the step's (a, b, lrwd) (`_fold_scalars`; lrwd is 0 on the
// segment path), three f32 in device memory; one_minus_b1 /
// one_minus_b2 formed in double and rounded to f32, as Python forms them.
// `vec`: dim % 4 == 0 and every row aligned for vector access. Returns the
// cudaError_t of the launch (0 on success).
int azt_segment_adam(void* p, void* m, void* v, const void* uids,
                     const void* valid, const void* g_slots, int n_slots,
                     int dim, long long n_rows, const float* folded,
                     float b1, float b2, float one_minus_b1,
                     float one_minus_b2, int p_dtype, int vec, void* stream) {
  if (n_slots <= 0 || dim <= 0 || n_rows <= 0 || p_dtype < 0 ||
      p_dtype > 1 || folded == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const azt::AdamScalars s{0.f, 0.f, 0.f, b1, b2, one_minus_b1, one_minus_b2};
  const int groups = (dim + 3) / 4;
  const unsigned blocks = blocks_for(static_cast<long long>(n_slots) * groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* u = static_cast<const int*>(uids);
  const int* ok = static_cast<const int*>(valid);
  const float* g = static_cast<const float*>(g_slots);
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  if (p_dtype == 0) {
    segment_adam_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<float*>(p), mm, vv, u, ok, g, n_slots, dim, n_rows,
        groups, vec != 0, folded, s);
  } else {
    segment_adam_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<__nv_bfloat16*>(p), mm, vv, u, ok, g, n_slots, dim,
        n_rows, groups, vec != 0, folded, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
