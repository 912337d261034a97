// Fused Adam / AdamW for Hopper (sm_90a), with a plain C interface: one
// launch steps every leaf of a sweep (a multi-tensor apply).
//
// Replaces `_fused_kernel` of analytics_zoo_tpu/pallas/fused_adam.py (L93),
// launched there per leaf by `_leaf_update` (L125) through `pl.pallas_call`
// (L150) with the params and moments aliased to the outputs (in place).
// There the per-leaf calls sit inside one compiled XLA program; an eager
// port that launched once a leaf paid a launch from Python for each of the
// 153-161 leaves of a step, and each launch's fixed start and tail on the
// device (a 64-element BatchNorm vector filled one block).
//
// What it computes, per element of every leaf, in place (`_adam_math`,
// L83):
//   m <- b1 * m + (1 - b1) * g
//   v <- b2 * v + (1 - b2) * g * g
//   p <- p - a * m / (sqrt(v) + b) - lrwd * p
// with the bias correction folded into the scalars on the host
// (`_fold_scalars`, L70): a = lr * sqrt(1 - b2^t) / (1 - b1^t),
// b = eps * sqrt(1 - b2^t), lrwd = lr * weight_decay, t the step number
// after the increment. p and g are f32 or bf16 (each read as f32, p written
// back rounded to nearest even in its dtype); m and v are f32. Every
// operation is an IEEE round-to-nearest intrinsic in the order `_adam_math`
// writes it, with no fused multiply-adds (`azt::adam_update` in
// common.cuh, shared with the segment-Adam kernel), so the kernel agrees
// with the plain PyTorch version (`kernels/fused_adam.py`, one rounding per
// operation) bit for bit.
//
// What bounds it on an H100: per element it reads g, p, m, v and writes p,
// m, v (the 7-pass floor of `leaf_cost`, L104) for about 12 operations, so
// a sweep is a memory stream: n * (g_itemsize + 2 * p_itemsize + 16)
// bytes at 3.35 TB/s, summed over the leaves (ResNet-50's 25.6 M f32
// elements: 0.21 ms).
//
// What the design does about that:
// - One launch covers up to kMaxLeaves leaves. The leaf table (the four
//   pointers, the element count, a prefix sum of chunk counts and a kind
//   byte a leaf) is passed by value as one `__grid_constant__` kernel
//   parameter: CUDA 12.1+ on sm_70+ takes 32,764 bytes of parameters, and
//   at 45 bytes a leaf 704 leaves fit beside the scalars (BERT-base's 153
//   and ResNet-50's 161 leaves in one launch). The parameter block is
//   copied at the launch, so the host may reuse its arrays at once. A
//   sweep over more leaves takes ceil(leaves / kMaxLeaves) launches.
// - The leaves are cut into chunks of kChunk elements (a leaf's last chunk
//   partial), one block a chunk: the hardware hands chunks to SMs as
//   blocks retire, so the sweep ends in a tail of at most one chunk an SM
//   slot, and a 64-element BatchNorm vector costs one short block, not a
//   launch. (A persistent grid of SMs x resident blocks walking the chunks
//   in a fixed stride ran 4-5% slower: its last round left most SMs idle.)
//   A block finds its chunk's leaf by a binary search over the prefix sum,
//   staged in shared memory.
// - Where the four pointers of a leaf are 16-byte aligned, a thread moves
//   two groups of 4 consecutive elements an iteration, kThreads groups
//   apart, all loads issued before the math: each load instruction of a
//   warp reads 32 neighbouring groups (512 contiguous bytes of an f32
//   array, 256 of a bf16 one). (Eight consecutive elements a thread, with
//   16-byte accesses of the bf16 arrays, ran 1-4% slower: each f32 access
//   instruction then touched every other 16 bytes.) A leaf's ragged tail
//   (past its last whole group of 4), and every element of a leaf whose
//   pointers are not 16-byte aligned (a view at an odd offset), take a
//   scalar path with the same arithmetic.
// - The (p, g) dtype pair is a template parameter, chosen per block from
//   the leaf's kind byte: a block never diverges on dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 2048;       // elements a block: 2 groups of 4
                                         // a thread
constexpr int kMaxLeaves = 704;          // leaves a launch

// kind byte: bit 0 p is bf16, bit 1 g is bf16, bit 2 all four pointers
// 16-byte aligned.
constexpr int kAligned = 4;

struct LeafTable {
  void* p[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  const void* g[kMaxLeaves];
  long long n[kMaxLeaves];
  int chunk_start[kMaxLeaves + 1];   // leaf i: chunks [start[i], start[i+1])
  unsigned char kind[kMaxLeaves];
  int count;
};

// The kernel parameter limit of CUDA 12.1+ on sm_70+.
static_assert(sizeof(LeafTable) + sizeof(azt::AdamScalars) <= 32764,
              "the leaf table must fit the 32,764-byte parameter space");

__device__ __forceinline__ void update4(float4& p, float4& m, float4& v,
                                        const float4& g,
                                        const azt::AdamScalars& s) {
  azt::adam_update(p.x, m.x, v.x, g.x, s);
  azt::adam_update(p.y, m.y, v.y, g.y, s);
  azt::adam_update(p.z, m.z, v.z, g.z, s);
  azt::adam_update(p.w, m.w, v.w, g.w, s);
}

// Elements [begin, end) of one leaf, by the block.
template <typename P, typename G>
__device__ __forceinline__ void run_chunk(P* __restrict__ p,
                                          float* __restrict__ m,
                                          float* __restrict__ v,
                                          const G* __restrict__ g,
                                          long long begin, long long end,
                                          bool aligned,
                                          const azt::AdamScalars& s) {
  long long rest = begin;
  if (aligned) {
    // begin is a multiple of kChunk, so every group is 16-byte aligned
    const long long groups = (end - begin) / 4;
    for (long long k = threadIdx.x; k < groups; k += 2 * kThreads) {
      const long long i0 = begin + 4 * k;
      const long long i1 = i0 + 4 * kThreads;
      const bool two = k + kThreads < groups;
      float4 p0 = azt::load4(p + i0), g0 = azt::load4(g + i0);
      float4 m0 = azt::load4(m + i0), v0 = azt::load4(v + i0);
      float4 p1 = p0, g1 = g0, m1 = m0, v1 = v0;
      if (two) {
        p1 = azt::load4(p + i1);
        g1 = azt::load4(g + i1);
        m1 = azt::load4(m + i1);
        v1 = azt::load4(v + i1);
      }
      update4(p0, m0, v0, g0, s);
      update4(p1, m1, v1, g1, s);
      azt::store4(m + i0, m0);
      azt::store4(v + i0, v0);
      azt::store4(p + i0, p0);
      if (two) {
        azt::store4(m + i1, m1);
        azt::store4(v + i1, v1);
        azt::store4(p + i1, p1);
      }
    }
    rest = begin + 4 * groups;
  }
  for (long long i = rest + threadIdx.x; i < end; i += kThreads) {
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
__device__ __forceinline__ void run_leaf_chunk(const LeafTable& t, int leaf,
                                               long long begin,
                                               long long end, bool aligned,
                                               const azt::AdamScalars& s) {
  run_chunk<P, G>(static_cast<P*>(t.p[leaf]), static_cast<float*>(t.m[leaf]),
                  static_cast<float*>(t.v[leaf]),
                  static_cast<const G*>(t.g[leaf]), begin, end, aligned, s);
}

// One block a chunk: block c steps chunk c of the table.
__global__ void __launch_bounds__(kThreads)
fused_adam_multi_kernel(const __grid_constant__ LeafTable t,
                        const float* __restrict__ folded,
                        const azt::AdamScalars consts) {
  const azt::AdamScalars s = azt::with_folded(consts, folded);
  __shared__ int start[kMaxLeaves + 1];
  const int count = t.count;
  for (int i = threadIdx.x; i <= count; i += kThreads) {
    start[i] = t.chunk_start[i];
  }
  __syncthreads();
  const int c = blockIdx.x;
  // the leaf owning chunk c: the last i with start[i] <= c (every thread
  // reads the same words: shared-memory broadcasts)
  int lo = 0;
  int hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long n = t.n[lo];
  const long long begin = static_cast<long long>(c - start[lo]) * kChunk;
  const long long end = begin + kChunk < n ? begin + kChunk : n;
  const int kind = t.kind[lo];
  const bool aligned = (kind & kAligned) != 0;
  switch (kind & 3) {
    case 0:
      run_leaf_chunk<float, float>(t, lo, begin, end, aligned, s);
      break;
    case 1:
      run_leaf_chunk<__nv_bfloat16, float>(t, lo, begin, end, aligned, s);
      break;
    case 2:
      run_leaf_chunk<float, __nv_bfloat16>(t, lo, begin, end, aligned, s);
      break;
    default:
      run_leaf_chunk<__nv_bfloat16, __nv_bfloat16>(t, lo, begin, end,
                                                   aligned, s);
      break;
  }
}

}  // namespace

extern "C" {

// The launch geometry: out[0] elements a chunk (a block), out[1] leaves a
// launch, out[2] threads a block, out[3] SMs and out[4] resident blocks an
// SM on the current device. Returns the cudaError_t of the queries.
int azt_fused_adam_config(long long* out) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_adam_multi_kernel, kThreads, 0);
  }
  out[0] = kChunk;
  out[1] = kMaxLeaves;
  out[2] = kThreads;
  out[3] = sms;
  out[4] = per_sm;
  return static_cast<int>(err);
}

// One launch over `count` leaves (1 <= count <= kMaxLeaves). ptrs: count
// rows of (p, m, v, g) addresses; numel: each leaf's element count (> 0);
// chunk_start: count + 1 prefix sums of ceil(numel / kChunk), from 0; kind:
// bit 0 p bf16, bit 1 g bf16, bit 2 the four pointers 16-byte aligned.
// Every leaf is contiguous in one memory format shared by its four tensors;
// m and v are float32; no two leaves overlap. folded: the step's (a, b,
// lrwd), three f32 in device memory. one_minus_b1 / one_minus_b2 are
// (1 - b1), (1 - b2) formed in double and rounded to f32, as Python forms
// them. Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a table that breaks these rules.
int azt_fused_adam_multi(const long long* ptrs, const long long* numel,
                         const int* chunk_start, const unsigned char* kind,
                         int count, const float* folded, float b1, float b2,
                         float one_minus_b1, float one_minus_b2,
                         void* stream) {
  if (count < 1 || count > kMaxLeaves || chunk_start[0] != 0 ||
      folded == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static thread_local LeafTable t;
  for (int i = 0; i < count; ++i) {
    const long long n = numel[i];
    const long long chunks = (n + kChunk - 1) / kChunk;
    if (n <= 0 || kind[i] > 7 ||
        chunk_start[i + 1] - chunk_start[i] != chunks) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    t.p[i] = reinterpret_cast<void*>(ptrs[4 * i]);
    t.m[i] = reinterpret_cast<void*>(ptrs[4 * i + 1]);
    t.v[i] = reinterpret_cast<void*>(ptrs[4 * i + 2]);
    t.g[i] = reinterpret_cast<const void*>(ptrs[4 * i + 3]);
    t.n[i] = n;
    t.chunk_start[i] = chunk_start[i];
    t.kind[i] = kind[i];
  }
  t.chunk_start[count] = chunk_start[count];
  t.count = count;
  const azt::AdamScalars s{0.f, 0.f, 0.f, b1, b2, one_minus_b1, one_minus_b2};
  fused_adam_multi_kernel<<<chunk_start[count], kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(t, folded,
                                                                 s);
  return static_cast<int>(cudaGetLastError());
}

const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
