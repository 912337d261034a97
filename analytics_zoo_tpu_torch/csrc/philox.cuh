// The port's random bits: Philox-4x32-10 (Salmon et al., "Parallel Random
// Numbers: As Easy as 1, 2, 3", SC 2011; the generator of Random123 and
// cuRAND), and the two keep rules built on it. One place for both, so the
// flash-attention forward, its two backward kernels and the mask-export
// kernel draw the same bits, and `kernels/philox.py` (the plain PyTorch
// version, bit for bit the same function) can reproduce every mask.
//
// The TPU kernels draw from the TPU's own PRNG (`pltpu.prng_seed` +
// `prng_random_bits`), reseeded per tile; those bits cannot be reproduced
// here. A counter-based generator needs no state and no reseeding: every
// element's bits are a pure function of (seed, its coordinates).
//
// Counters:
//   attention dropout  (col/16, query row, b*h, 0) -> 16 bytes, byte b for
//                      key column 16*(col/16) + b; keep iff byte < t,
//                      t = round((1 - rate) * 256) clamped to [1, 255],
//                      scaled by 256 / t (`_byte_threshold`, `_keep_scale`)
//   element dropout    (i/4 low word, i/4 high word, 0, 1) -> 4 words,
//                      word i%4 for element i; keep iff word >= threshold,
//                      threshold = min(floor(rate * 2^32), 2^32 - 1),
//                      scaled by 1 / (1 - rate) (`_dropout_threshold`)
// The key is the 64-bit seed (low word, high word). The last counter word
// keeps the two rules' streams apart for one seed.
//
// Seeds lie in device memory. A training step's seed is one int64 in the
// step's row of the scalar table, which the host writes before each step,
// so a captured CUDA graph reads a new seed at every replay. A dropout site
// names it by `SeedPath`: the address of the step seed and the static path
// of site indices under it. The kernel derives the site's seed with
// `site_seed` along the path, bit for bit as `kernels/philox.py`
// `site_seed` derives it on the host.

#pragma once

#include <stdint.h>

namespace azt {

struct Philox4 {
  uint32_t w[4];
};

constexpr int kMaxSeedDepth = 8;

// Where a dropout site's seed comes from: the 64-bit seed at `base` (device
// memory), then `site_seed` once for each of the first `depth` sites.
struct SeedPath {
  const unsigned long long* base;
  unsigned long long sites[kMaxSeedDepth];
  int depth;
};

// splitmix64 of (seed, site), as a non-negative 63-bit value: the rule of
// `kernels/philox.py` `site_seed`.
__host__ __device__ __forceinline__ unsigned long long site_seed(
    unsigned long long seed, unsigned long long site) {
  unsigned long long z = seed * 0x9E3779B97F4A7C15ull + site + 1ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return (z ^ (z >> 31)) >> 1;
}

// The seed a path names, read from device memory. The sites are indexed
// with compile-time indices (the loop is unrolled to kMaxSeedDepth and the
// path's depth, the same in every thread, predicates it), so the path is
// read where it lies, in the kernel's parameters, and no thread copies it.
__device__ __forceinline__ unsigned long long path_seed(const SeedPath& s) {
  unsigned long long z = __ldg(s.base);
#pragma unroll
  for (int i = 0; i < kMaxSeedDepth; ++i) {
    if (i < s.depth) {
      z = site_seed(z, s.sites[i]);
    }
  }
  return z;
}

// The attention dropout inside a kernel: the seed's two words and the byte
// rule's threshold t (0: no dropout) and keep scale 256 / t.
struct AttnDropout {
  uint32_t k0, k1;
  uint32_t t;
  float keep_scale;
};

// The attention dropout as a kernel takes it: t, the keep scale and the
// seed's path; `resolve` reads the seed on the device.
struct AttnDropoutArg {
  uint32_t t;
  float keep_scale;
  SeedPath seed;
};

// A kernel instantiated without dropout (kDrop false) compiles no seed
// read at all.
template <bool kDrop>
__device__ __forceinline__ AttnDropout resolve(const AttnDropoutArg& a) {
  AttnDropout d = {0u, 0u, a.t, a.keep_scale};
  if constexpr (kDrop) {
    const unsigned long long z = path_seed(a.seed);
    d.k0 = static_cast<uint32_t>(z);
    d.k1 = static_cast<uint32_t>(z >> 32);
  }
  return d;
}

// A path from the C entry points' arguments: `base` a device address,
// `sites` a host array of `depth` (<= kMaxSeedDepth) site indices.
inline SeedPath make_seed_path(const void* base, int depth,
                               const long long* sites) {
  SeedPath p;
  p.base = static_cast<const unsigned long long*>(base);
  p.depth = depth;
  for (int i = 0; i < kMaxSeedDepth; ++i) {
    p.sites[i] = i < depth ? static_cast<unsigned long long>(sites[i]) : 0ull;
  }
  return p;
}

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  Philox4 out;
  out.w[0] = c0;
  out.w[1] = c1;
  out.w[2] = c2;
  out.w[3] = c3;
  return out;
}

// Attention dropout: the 16 keep bytes of query row `row` of head `bh` for
// key columns [16*col16, 16*col16 + 16).
__device__ __forceinline__ Philox4 attn_keep_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t bh, uint32_t row,
                                                  uint32_t col16) {
  return philox4x32_10(col16, row, bh, 0u, k0, k1);
}

// Byte b (0..15) of a 16-byte draw; call with a compile-time b (inside an
// unrolled loop) so the word index folds away.
__device__ __forceinline__ uint32_t keep_byte(const Philox4& r, int b) {
  return (r.w[b >> 2] >> (8 * (b & 3))) & 0xFFu;
}

// Element dropout: the four words of elements [4*group, 4*group + 4).
__device__ __forceinline__ Philox4 dropout_bits(uint32_t k0, uint32_t k1,
                                                unsigned long long group) {
  return philox4x32_10(static_cast<uint32_t>(group),
                       static_cast<uint32_t>(group >> 32), 0u, 1u, k0, k1);
}

}  // namespace azt
