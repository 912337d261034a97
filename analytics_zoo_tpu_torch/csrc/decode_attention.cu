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
// or past lengths[s] masked with -1e30 (not -inf) and never read, softmax
// across keys in f32, scores scaled by 1/sqrt(D), the weights rounded to
// the pool's dtype before the PV product (a no-op in f32), the sum in f32,
// the output cast to q's dtype. The TPU kernels walk the keys in blocks of
// 128 (contiguous) or block_len (paged) with an online softmax in VMEM
// scratch.
//
// One template serves both layouts: the address of logical position `pos`
// is the only difference,
//   contiguous: ((s*H + h)*L + pos)*D
//   paged:      ((tables[s, pos/block_len]*H + h)*block_len
//                + pos%block_len)*D,
// and every thread visits the same logical positions in the same order
// whatever the layout, so the paged kernel's output equals the contiguous
// kernel's bit for bit on the same logical bytes.
//
// What bounds it on an H100: every live key and value row is read once,
// 2*D*itemsize bytes a position, against 4*D flops a position, so it is
// memory-bound: 2*S*H*n*D*itemsize bytes at 3.35 TB/s, where n is the live
// length of each slot. At S=32, H=12, D=64 and lengths uniform in
// [1, 1024] that is 14 us in bf16 and 29 us in f32. Such a launch lasts a
// few tens of microseconds, so a block's fixed latencies (the length, the
// first copy, its barriers) and the instructions it spends a byte weigh
// as much as the bandwidth.
//
// What its design does about that:
// - One block per (s, h) and split, 128 threads. The block stages tiles of
//   up to 64 positions of K and of V in shared memory by 1-D bulk copies
//   (TMA, `cp.async.bulk`), one copy a run of consecutive rows: the whole
//   tile in the contiguous pool, one block of the table paged. A ring of
//   two stages keeps the next tile's copies in flight while one is used;
//   an mbarrier a stage and operand says when its bytes have landed. The
//   lanes of warp 0 issue the copies, one run a lane (K's and V's side by
//   side), so staging costs the other warps no instructions and a tile is
//   read 16 bytes a lane in both dtypes. Warp 0 issues the first copies
//   while the other warps load q, and refills a stage as soon as the
//   block's first barrier of the next tile shows every warp past it: two
//   block barriers a tile (the tile's maximum; its weights and V).
// - The per-key scalar work once per key: two lanes score one key from
//   shared memory (half the row's 16-byte pieces each, the pieces rotated
//   by the key so that the lanes of a warp read different banks, one
//   shuffle), the block takes the tile's maximum, and one lane of the two
//   does the key's exp2 (scores carry log2(e)) and its share of l. Then
//   lanes go per dimension for P.V: lane (slice j, group g) accumulates
//   dims [8g, 8g+8) (bf16; [4g, 4g+4) f32) over the keys of slice j, and
//   the slices are summed in order at the end.
// - Split-K inside a thread-block cluster, where one block would walk a
//   long chain of tiles. The wrapper's `_split_plan` picks n_split <= 8
//   (the portable cluster size) from the bucket, never from `lengths`
//   (they live on the device), so a launch needs no host read and is
//   capturable in a CUDA graph. On the card the cluster splits the slot's
//   live positions [0, n) evenly, in spans of a multiple of 16 (a block
//   of 16 never straddles two spans), so every block of the cluster has
//   work while any has. A block whose span is empty reads nothing and
//   leaves the empty state (m = -1e30, l = 0, acc = 0).
// - The combine stays in the launch, in a fixed order: each block leaves
//   (m, l, acc[D]) in its shared memory, the cluster syncs, rank 0 reads
//   ranks 0..n_split-1 through distributed shared memory, merges them in
//   rank order and writes O, and a second cluster sync keeps every block's
//   state alive until it has been read. No workspace, no atomics, the
//   same bits on every launch. A cluster of one launches as a plain block
//   and writes O from its own state.
// - Paged: the block reads only its span's table entries, into shared
//   memory; it never needs the whole table, so the launch has no
//   table-size limit.
// Rows whose bytes are not a whole number of 16-byte pieces (D % 4 != 0 in
// f32, D % 8 != 0 in bf16) are staged element by element, zero-padded to
// the piece, and their barriers complete on an arrival with no bytes.
//
// What bounds it now (H100 times in PERF.md, rows 8-9): at 32 slots x 12
// heads the SMs are full without a split, and a split's fixed cost and
// merge pay only at kv 1024, where it halves the longest slot's chain of
// tiles. f32 runs at about 70% of the bandwidth bound there and bf16 at
// about 55-60%: a bf16 tile's instructions and block barriers serve half
// the bytes. At kv 128 a block walks one or two tiles and its fixed
// start (the length, the first copy) sets the time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads / 2;  // positions a staged tile, at most
constexpr int kStages = 2;           // tiles in flight a block
constexpr int kMaxSplit = 8;     // the portable cluster size
constexpr int kChunkAlign = 16;
constexpr int kMaxDim = 128;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// Elements in one 16-byte piece.
template <typename T>
__host__ __device__ constexpr int piece() {
  return 16 / static_cast<int>(sizeof(T));
}

// One 16-byte piece of shared memory as f32.
__device__ __forceinline__ void load_piece(const float* p, float (&x)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x;
  x[1] = r.y;
  x[2] = r.z;
  x[3] = r.w;
}

__device__ __forceinline__ void load_piece(const __nv_bfloat16* p,
                                           float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// G elements of q (f32 in shared memory, 16-byte aligned).
template <int G>
__device__ __forceinline__ void load_q(const float* p, float (&x)[G]) {
#pragma unroll
  for (int i = 0; i < G; i += 4) {
    const float4 r = *reinterpret_cast<const float4*>(p + i);
    x[i] = r.x;
    x[i + 1] = r.y;
    x[i + 2] = r.z;
    x[i + 3] = r.w;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier: one arrival (thread 0's) plus the bytes of a tile's copies.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Where a block finds its slot's rows: the contiguous pool's row of (s, h)
// or the paged pool through the span's table entries in shared memory.
template <bool kPaged>
struct Rows {
  long long bh;     // s*H + h
  int h, H, rows;   // rows: L contiguous, block_len paged
  int D;
  const int* tbl;   // paged: table entries [e0, ...) of the span
  int e0;

  __device__ __forceinline__ long long offset(int pos) const {
    if (kPaged) {
      const int blk = tbl[pos / rows - e0];
      return ((static_cast<long long>(blk) * H + h) * rows + pos % rows) * D;
    }
    return (bh * rows + pos) * D;
  }
  // run i of consecutive rows of [t0, end): [lo, hi), empty past the
  // last (one run contiguous; paged, runs end where table blocks do)
  __device__ __forceinline__ void run(int t0, int end, int i, int& lo,
                                      int& hi) const {
    if (kPaged) {
      const int b = t0 / rows + i;
      lo = max(t0, b * rows);
      hi = min(end, (b + 1) * rows);
    } else {
      lo = i == 0 ? t0 : end;
      hi = end;
    }
  }
};

// Stage positions [t0, t0 + n) of K and of V into a stage's tiles (rows of
// Dp elements, unpadded). Called by warp 0. `vec`: lane 0 sets each
// barrier's expected bytes, and the lanes issue one bulk copy a run of
// consecutive rows (the whole tile contiguous, a block of the table
// paged), K's runs and V's side by side. Otherwise the warp copies
// elements (zero past D) and lane 0 arrives with no bytes.
template <typename T, bool kPaged>
__device__ __forceinline__ void stage(T* kdst, T* vdst,
                                      const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const Rows<kPaged>& at, int t0, int n,
                                      int Dp, bool vec, uint64_t* kbar,
                                      uint64_t* vbar) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    const uint32_t row_bytes = Dp * sizeof(T);
    if (lane == 0) {
      mbar_expect(kbar, n * row_bytes);
      mbar_expect(vbar, n * row_bytes);
    }
    __syncwarp();
    // lanes 0-15 copy K's runs, 16-31 V's, one run a lane at a time
    const bool is_v = lane >= 16;
    T* dst = is_v ? vdst : kdst;
    const T* src = is_v ? v : k;
    uint64_t* bar = is_v ? vbar : kbar;
    for (int i = lane & 15;; i += 16) {
      int lo, hi;
      at.run(t0, t0 + n, i, lo, hi);
      if (lo >= hi) {
        break;
      }
      bulk_copy(dst + (lo - t0) * Dp, src + at.offset(lo),
                (hi - lo) * row_bytes, bar);
    }
    return;
  }
  for (int i = lane; i < n * Dp; i += 32) {
    const int r = i / Dp;
    const int d = i - r * Dp;
    const long long off = at.offset(t0 + r) + d;
    const bool in = d < at.D;
    azt::from_float(kdst + i, in ? azt::to_float(k[off]) : 0.f);
    azt::from_float(vdst + i, in ? azt::to_float(v[off]) : 0.f);
  }
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();  // the warp's stores before the arrival
    mbar_expect(kbar, 0);
    mbar_expect(vbar, 0);
  }
}

// Bytes of the stage buffers, at least those of the slices' partial sums
// (at most G floats a lane).
__host__ __device__ __forceinline__ int region_bytes(int tile_bytes, int G) {
  const int bufs = 2 * kStages * tile_bytes;
  const int parts = kThreads * G * static_cast<int>(sizeof(float));
  return bufs > parts ? bufs : parts;
}

template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        const int* __restrict__ tables, T* __restrict__ out,
                        int H, int rows, int D, int table_stride,
                        int kv_bucket, int tile, float scale, bool vec) {
  constexpr int G = piece<T>();
  __shared__ __align__(16) float q_s[kMaxDim];
  __shared__ float p_s[kTile];
  __shared__ float red_s[kWarps];
  __shared__ __align__(8) uint64_t kbar[kStages];
  __shared__ __align__(8) uint64_t vbar[kStages];
  // the block's softmax state, read by rank 0 of the cluster
  __shared__ float st_m;
  __shared__ float st_l;
  __shared__ float st_acc[kMaxDim];
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / n_split;
  const int s = bh / H;
  const int h = bh - s * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int Dp = (D + G - 1) / G * G;
  const int tile_elems = tile * Dp;
  // stage j: K at 2j, V at 2j + 1; the slices' sums reuse the region
  T* bufs = reinterpret_cast<T*>(smem);
  int* tbl_s = reinterpret_cast<int*>(
      smem + region_bytes(tile_elems * static_cast<int>(sizeof(T)), G));

  // The slot's live keys [0, n) split evenly over the cluster, in spans
  // of a multiple of 16 positions: block `rank` takes [c0, hi). The
  // wrapper's contract is lengths[s] >= 1; a slot below it visits no key
  // and its row is undefined. The length is read first, so that its
  // latency overlaps the barriers' set-up.
  const int length = __ldg(lengths + s);
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      mbar_init(&kbar[j]);
      mbar_init(&vbar[j]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int n = min(length, kv_bucket);
  const int span = (n + n_split * kChunkAlign - 1) / (n_split * kChunkAlign) *
                   kChunkAlign;
  const int c0 = rank * span;
  const int hi = min(c0 + span, n);
  const int n_tiles = c0 < hi ? (hi - c0 + tile - 1) / tile : 0;
  const int e0 = kPaged ? c0 / rows : 0;
  const Rows<kPaged> at{bh, h, H, rows, D, tbl_s, e0};
  const long long q_row = static_cast<long long>(bh) * D;
  if (tid < 32) {
    // warp 0: the span's table entries (paged) and, by bulk copy, the
    // first tiles; meanwhile the other warps load q
    if (kPaged && c0 < hi) {
      const int n_e = (hi - 1) / rows + 1 - e0;
      for (int i = lane; i < n_e; i += 32) {
        tbl_s[i] = tables[static_cast<long long>(s) * table_stride + e0 + i];
      }
    }
    __syncwarp();
    for (int j = 0; j < kStages && j < n_tiles; ++j) {
      const int t0 = c0 + j * tile;
      stage(bufs + 2 * j * tile_elems, bufs + (2 * j + 1) * tile_elems, k, v,
            at, t0, min(tile, hi - t0), Dp, vec, &kbar[j], &vbar[j]);
    }
  } else {
    for (int d = tid - 32; d < Dp; d += kThreads - 32) {
      q_s[d] = d < D ? azt::to_float(q[q_row + d]) : 0.f;
    }
  }
  __syncthreads();

  // P.V lanes: dim group `dg` of the row, keys of slice `slice`
  const int n_dg = Dp / G;
  int n_dg2 = 1;
  while (n_dg2 < n_dg) {
    n_dg2 *= 2;
  }
  const int dg = tid & (n_dg2 - 1);
  const int slice = tid / n_dg2;
  const int n_slices = kThreads / n_dg2;
  const int per_slice = (tile + n_slices - 1) / n_slices;
  // score lanes: two a key, each every other piece of the row, the pieces
  // rotated by the key so that the lanes of a warp read different banks
  const int key = tid >> 1;
  const int row_half = tid & 1;
  const int first_piece = (row_half + 2 * key) % n_dg;
  // scores in base 2 (log2(e) folded into the scale), so that every
  // exponential is one exp2f
  const float scale2 = scale * kLog2e;

  float m = kMasked;
  float l = 0.f;  // this lane's keys' share of the sum of weights
  float acc[G];
#pragma unroll
  for (int e = 0; e < G; ++e) {
    acc[e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int j = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const T* ks = bufs + 2 * j * tile_elems;
    const T* vs = ks + tile_elems;
    const int t0 = c0 + it * tile;
    const int nv = min(tile, hi - t0);

    mbar_wait(&kbar[j], parity);
    float part = 0.f;
    if (key < nv) {
      const T* row = ks + key * Dp;
      int pc = first_piece;
      for (int g = row_half; g < n_dg; g += 2) {
        float x[G];
        float qv[G];
        load_piece(row + pc * G, x);
        load_q(q_s + pc * G, qv);
#pragma unroll
        for (int e = 0; e < G; ++e) {
          part = fmaf(qv[e], x[e], part);
        }
        pc = pc + 2 < n_dg ? pc + 2 : pc + 2 - n_dg;
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    const float sc = key < nv ? part * scale2 : kMasked;
    float mx = sc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      red_s[tid >> 5] = mx;
    }
    __syncthreads();
    // every thread is past the P.V of tile it - 1: its stage takes the
    // tile kStages on
    if (tid < 32 && it >= 1 && it - 1 + kStages < n_tiles) {
      const int jp = (it - 1) % kStages;
      const int t1 = c0 + (it - 1 + kStages) * tile;
      stage(bufs + 2 * jp * tile_elems, bufs + (2 * jp + 1) * tile_elems, k,
            v, at, t1, min(tile, hi - t1), Dp, vec, &kbar[jp], &vbar[jp]);
    }
    float m_new = m;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      m_new = fmaxf(m_new, red_s[w]);
    }
    const float alpha = exp2f(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < G; ++e) {
      acc[e] *= alpha;
    }
    if (row_half == 0) {
      const float p = key < nv ? exp2f(sc - m_new) : 0.f;
      l += p;
      p_s[key] = round_to<T>(p);
    }
    mbar_wait(&vbar[j], parity);
    __syncthreads();

    const int k_lo = slice * per_slice;
    const int k_hi = min(k_lo + per_slice, nv);
    if (dg < n_dg) {
      for (int kk = k_lo; kk < k_hi; ++kk) {
        const float w = p_s[kk];
        float x[G];
        load_piece(vs + kk * Dp + dg * G, x);
#pragma unroll
        for (int e = 0; e < G; ++e) {
          acc[e] = fmaf(w, x[e], acc[e]);
        }
      }
    }
  }
  __syncthreads();  // the stages are free for the slices' sums

  // The block's state: l summed over lanes by a fixed butterfly and warps
  // in order, acc summed over slices in order (the tiles are done, so
  // their buffers hold the slices' partial sums).
  float* part_s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
  }
  if (lane == 0) {
    red_s[tid >> 5] = l;
  }
  if (dg < n_dg) {
#pragma unroll
    for (int e = 0; e < G; ++e) {
      part_s[slice * Dp + dg * G + e] = acc[e];
    }
  }
  __syncthreads();
  float l_block = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    l_block += red_s[w];
  }
  if (n_split == 1) {
    // a block alone writes O from its own state (the merge below would
    // weigh it by exp2(0) = 1: the same bits)
    for (int d = tid; d < D; d += kThreads) {
      float o = 0.f;
      for (int j = 0; j < n_slices; ++j) {
        o += part_s[j * Dp + d];
      }
      azt::from_float(out + q_row + d, o / l_block);
    }
    return;
  }
  if (tid == 0) {
    st_m = m;
    st_l = l_block;
  }
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
    for (int j = 0; j < n_slices; ++j) {
      o += part_s[j * Dp + d];
    }
    st_acc[d] = o;
  }
  cluster.sync();

  // Rank 0 merges the cluster's states in rank order and writes O.
  if (rank == 0) {
    for (int d = tid; d < D; d += kThreads) {
      float big = kMasked;
      for (int r = 0; r < n_split; ++r) {
        big = fmaxf(big, *cluster.map_shared_rank(&st_m, r));
      }
      float total = 0.f;
      float o = 0.f;
      for (int r = 0; r < n_split; ++r) {
        const float w = exp2f(*cluster.map_shared_rank(&st_m, r) - big);
        total = fmaf(*cluster.map_shared_rank(&st_l, r), w, total);
        o = fmaf(cluster.map_shared_rank(st_acc, r)[d], w, o);
      }
      azt::from_float(out + q_row + d, o / total);
    }
  }
  cluster.sync();  // no block leaves while rank 0 may read its state
}

// A plan's launch configuration is checked once: the dynamic shared
// memory a kernel may take is raised where the plan needs more than the
// default, and the cluster must fit on the card.
struct Checked {
  const void* fn;
  unsigned n_split;
  size_t smem;
};
std::mutex plans_mu;
std::vector<Checked> plans;
std::vector<std::pair<const void*, size_t>> smem_set;

template <typename Kernel>
cudaError_t check_plan(Kernel kernel, const cudaLaunchConfig_t& cfg,
                       unsigned n_split) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(plans_mu);
  for (const Checked& c : plans) {
    if (c.fn == fn && c.n_split == n_split && c.smem == cfg.dynamicSmemBytes) {
      return cudaSuccess;
    }
  }
  {
    size_t* have = nullptr;
    for (auto& e : smem_set) {
      if (e.first == fn) {
        have = &e.second;
      }
    }
    if (have == nullptr || *have < cfg.dynamicSmemBytes) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(cfg.dynamicSmemBytes));
      if (err != cudaSuccess) {
        return err;
      }
      if (have == nullptr) {
        smem_set.emplace_back(fn, cfg.dynamicSmemBytes);
      } else {
        *have = cfg.dynamicSmemBytes;
      }
    }
  }
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel,
                                                         &cfg);
  if (err != cudaSuccess) {
    return err;
  }
  if (clusters < 1) {
    return cudaErrorInvalidConfiguration;
  }
  plans.push_back({fn, n_split, cfg.dynamicSmemBytes});
  return cudaSuccess;
}

struct Launch {
  const void *q, *k, *v, *tables, *lengths;
  void* out;
  int S, H, rows, D, table_stride, kv_bucket, n_split, tile;
  float scale;
  bool vec;
  size_t smem;
  cudaStream_t stream;
};

template <typename T, bool kPaged>
int launch_t(const Launch& a) {
  auto kernel = decode_attention_kernel<T, kPaged>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.n_split) *
                     static_cast<unsigned>(a.S) * static_cast<unsigned>(a.H));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.n_split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = check_plan(kernel, cfg, static_cast<unsigned>(a.n_split));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  // a block alone launches without the attribute (and its scheduling
  // constraint): it is a cluster of one all the same
  cfg.numAttrs = a.n_split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.lengths),
      static_cast<const int*>(a.tables), static_cast<T*>(a.out), a.H, a.rows,
      a.D, a.table_stride, a.kv_bucket, a.tile, a.scale, a.vec);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <bool kPaged>
int launch(Launch a, int dtype) {
  const size_t item = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const int G = static_cast<int>(16 / item);
  const int Dp = (a.D + G - 1) / G * G;
  // the longest span a block walks: that of a slot whose live length is
  // the whole bucket (a shorter one splits into shorter spans)
  const int span = (a.kv_bucket + a.n_split * kChunkAlign - 1) /
                   (a.n_split * kChunkAlign) * kChunkAlign;
  a.tile = span < kTile ? span : kTile;
  a.smem = region_bytes(a.tile * Dp * static_cast<int>(item), G);
  if (kPaged) {
    a.smem += sizeof(int) * static_cast<size_t>((span + a.rows - 1) / a.rows +
                                                1);
  }
  return dtype == 0 ? launch_t<float, kPaged>(a)
                    : launch_t<__nv_bfloat16, kPaged>(a);
}

bool bad_common(int S, int H, int D, int kv_bucket, int dtype, int n_split) {
  return S <= 0 || H <= 0 || D <= 0 || D > kMaxDim || kv_bucket <= 0 ||
         dtype < 0 || dtype > 1 || n_split < 1 || n_split > kMaxSplit;
}

}  // namespace

extern "C" {

// q [S, H, D]; k, v [S, H, L, D] (the whole pool; positions
// [0, kv_bucket) are read); lengths int32 [S]; out [S, H, D]. dtype 0 f32,
// 1 bf16 (q, pools and out alike). n_split in [1, 8]: the blocks of a
// (slot, head)'s cluster, which split its live positions evenly in spans
// of a multiple of 16. `vec`: a row of D elements is
// a whole number of 16-byte pieces and every base pointer 16-byte
// aligned. Returns the cudaError_t of the launch.
int azt_decode_attention(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, int S, int H, int L,
                         int D, int kv_bucket, int n_split, float scale,
                         int dtype, int vec, void* stream) {
  if (bad_common(S, H, D, kv_bucket, dtype, n_split) ||
      kv_bucket > L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch a{q, k, v, nullptr, lengths, out, S, H, L, D, 0, kv_bucket,
           n_split, 0, scale, vec != 0, 0,
           static_cast<cudaStream_t>(stream)};
  return launch<false>(a, dtype);
}

// q [S, H, D]; k, v [num_blocks, H, block_len, D]; tables int32
// [S, table_stride] with table_stride >= kv_bucket / block_len; lengths
// int32 [S]; out [S, H, D]. kv_bucket a positive multiple of block_len.
// Other arguments as above. Returns the cudaError_t of the launch.
int azt_paged_decode_attention(const void* q, const void* k, const void* v,
                               const void* tables, const void* lengths,
                               void* out, int S, int H, int block_len, int D,
                               int table_stride, int kv_bucket, int n_split,
                               float scale, int dtype, int vec,
                               void* stream) {
  if (bad_common(S, H, D, kv_bucket, dtype, n_split) ||
      block_len <= 0 || kv_bucket % block_len != 0 ||
      table_stride < kv_bucket / block_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch a{q, k, v, tables, lengths, out, S, H, block_len, D, table_stride,
           kv_bucket, n_split, 0, scale, vec != 0, 0,
           static_cast<cudaStream_t>(stream)};
  return launch<true>(a, dtype);
}

const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
