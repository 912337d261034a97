// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): cp.async staging of bf16 tiles
// into padded shared memory, ldmatrix fragment loads, the warp-level
// m16n8k16 bf16 product with f32 accumulation, the two tile products the
// three kernels are written in, and the attention dropout's keep bits laid
// out for the product's accumulator fragments.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (PTX
// ISA, "Matrix fragments for mma.m16n8k16"), for lane = 4*g + t; a pair of
// bf16 holds the lower column in its low 16 bits:
//   A 16x16 (row-major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                        a3 (g+8, 2t+8..)
//   B 16x8  (k x n)      b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C 16x8  (f32)        c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)
//                        c3 (g+8, 2t+1)
// So the accumulators of two neighbouring n-blocks, rounded to bf16, are
// the A fragment of the next product with no data movement (`acc_to_a`).
//
// A block is 4 warps; each warp owns 16 rows of a 64-row tile. Tiles are
// [64, DP] bf16 with a row stride of DP + 8 elements: the 16 bytes of pad
// put the 8 rows one ldmatrix reads in 8 different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace azt {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // rows of a staged tile; 16 per warp

template <int DP>
__host__ __device__ constexpr int ld() {
  return DP + 8;
}

template <int DP>
__host__ __device__ constexpr int tile_elems() {
  return kTile * ld<DP>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes past src_bytes (0 or 16)
// are zero-filled and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a * b on the tensor cores: bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a [seq, dim] bf16 head into a [64, DP] tile.
// Rows past seq and columns past dim are zeros: a NaN left in a pad would
// survive a zero weight in the next product. Rows of a head with
// dim % 8 == 0 are 16-byte aligned and go by cp.async (the caller commits
// the group); other widths go element by element.
template <int DP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int seq, int dim,
                                           bool vec, int tid) {
  constexpr int LD = ld<DP>();
  if (vec) {
    constexpr int kChunks = DP / 8;  // 16-byte chunks a row
#pragma unroll
    for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kChunks;
      const int d = (e % kChunks) * 8;
      const int row = row0 + r;
      const bool ok = row < seq && d < dim;
      cp_async16(dst + r * LD + d, ok ? src + (size_t)row * dim + d : src,
                 ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < kTile * DP; e += kThreads) {
      const int r = e / DP;
      const int d = e % DP;
      const int row = row0 + r;
      dst[r * LD + d] =
          (row < seq && d < dim) ? src[(size_t)row * dim + d] : zero;
    }
  }
}

// Entry i0 + j of a length-seq f32 row into dst[j] (0 past seq); one
// thread per j in [0, 64).
__device__ __forceinline__ void stage_float(float* dst, const float* src,
                                            int i0, int seq, int j) {
  const bool ok = i0 + j < seq;
  cp_async4(dst + j, ok ? src + i0 + j : src, ok ? 4 : 0);
}

// A fragment of k-step kk: rows [row0, row0 + 16) of a tile, columns
// [16kk, 16kk + 16).
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int kk, int lane) {
  ldsm_x4(a, tile + (row0 + (lane & 15)) * ld<DP>() + kk * 16 +
                 (lane >> 4) * 8);
}

// B fragments of n-blocks n0 and n0 + 8 at k-step kk, from a tile stored
// [n][k] (a row per n): b[0], b[1] for n0; b[2], b[3] for n0 + 8.
template <int DP>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int kk, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld<DP>() +
                 kk * 16 + ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (a row per k), transposed on the way
// by ldmatrix.trans.
template <int DP>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const bf16* tile, int kk,
                                             int n0, int lane) {
  ldsm_x4_trans(b, tile + (kk * 16 + (lane & 15)) * ld<DP>() + n0 +
                       (lane >> 4) * 8);
}

// The A fragment of columns [16kk, 16kk + 16) from the f32 accumulators of
// n-blocks 2kk (lo) and 2kk + 1 (hi), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// acc (16 x 64) += A (16 x DP) * B^T, B a [64, DP] tile stored a row per
// output column: the scores Q.K^T and dO.V^T (and K.Q^T, V.dO^T in the
// transposed orientation). A comes from registers ...
template <int DP>
__device__ __forceinline__ void gemm_nt(float (&acc)[8][4],
                                        const uint32_t (&a)[DP / 16][4],
                                        const bf16* b_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b<DP>(b, b_tile, np * 16, kk, lane);
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// ... or from rows [a_row0, a_row0 + 16) of a staged tile, one k-step at a
// time (4 registers live instead of DP / 4).
template <int DP>
__device__ __forceinline__ void gemm_nt(float (&acc)[8][4],
                                        const bf16* a_tile, int a_row0,
                                        const bf16* b_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    load_a<DP>(a, a_tile, a_row0, kk, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b<DP>(b, b_tile, np * 16, kk, lane);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DP) += W (16 x 64, f32 accumulators rounded to bf16) * B, B a
// [64, DP] tile stored a row per k: P.V, dS.K, and (P.keep)^T.dO, dS^T.Q
// in the transposed orientation. The TPU kernels round W to the input
// dtype before these products too (flash_attention.py L247, L354, L396).
template <int DP>
__device__ __forceinline__ void gemm_wb(float (&acc)[DP / 8][4],
                                        const float (&w)[8][4],
                                        const bf16* b_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(a, w[2 * kk], w[2 * kk + 1]);
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t b[4];
      load_b_trans<DP>(b, b_tile, kk, np * 16, lane);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Bit b set iff byte b of the draw keeps its key (byte < t).
__device__ __forceinline__ uint32_t keep_mask16(const Philox4& r,
                                                uint32_t t) {
  uint32_t m = 0;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    m |= static_cast<uint32_t>(keep_byte(r, b) < t) << b;
  }
  return m;
}

// Attention dropout on a warp's 16 x 64 accumulators whose rows are query
// rows `row` (c0, c1) and `row + 8` (c2, c3) and whose columns are the 64
// keys from key0 (a multiple of 64): each kept value times keep_scale,
// each dropped one 0. Each (row, 16-key chunk) is drawn once per quad
// (the four lanes that share its rows): lane t draws chunk t for both
// rows, packs the two 16-bit keep masks into one word, and the quad trades
// words by shuffle. Two Philox calls a lane per tile.
__device__ __forceinline__ void keep_rows(float (&x)[8][4],
                                          const AttnDropout& drop, int bh,
                                          int row, int key0, int lane) {
  const int t = lane & 3;
  const uint32_t c16 = key0 / 16 + t;
  const uint32_t mine =
      keep_mask16(attn_keep_bits(drop.k0, drop.k1, bh, row, c16), drop.t) |
      keep_mask16(attn_keep_bits(drop.k0, drop.k1, bh, row + 8, c16),
                  drop.t)
          << 16;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t bits = __shfl_sync(0xffffffffu, mine, (lane & ~3) | c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bit = 16 * (e >> 1) + 8 * h + 2 * t + (e & 1);
        float& xv = x[2 * c + h][e];
        xv = (bits >> bit) & 1u ? xv * drop.keep_scale : 0.f;
      }
    }
  }
}

}  // namespace mma
}  // namespace azt
