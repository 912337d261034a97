"""The port's random bits in plain PyTorch: Philox-4x32-10 and the two
keep rules of `csrc/philox.cuh`, bit for bit.

The CUDA kernels draw their dropout bits from Philox inside the kernel
(`csrc/philox.cuh`); these functions compute the same bits with integer
tensor ops on any device, so the plain versions of the kernels (the CPU
route, and the card checks) drop exactly the elements the kernels drop.
The bits differ from the JAX package's, which come from the TPU's PRNG or
`jax.random`; the rules and the keep probabilities are the same.

Also here: `site_seed`, the fixed rule that derives each dropout site's
seed from one step seed, so a training step is reproducible from one
integer (the port's stand-in for splitting a `jax.random` key), and
`DeviceSeed`, a step seed that lies on the device. A training step reads
its seed from the step's row of the scalar table, which the host writes
before the step, so a captured CUDA graph draws new masks at each replay.
`site_seed` of a `DeviceSeed` appends the site to its static path; the
kernels apply the rule along the path in `csrc/philox.cuh`, and the plain
versions here in integer tensor ops (`seed_words`), bit for bit as the
rule on integers.

32-bit words are held in int64 tensors; the 32x32 -> 64-bit products of
Philox are split into 16-bit halves so no intermediate leaves int64.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # Philox-4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
_CHUNK = 16                            # keep bytes per attention draw


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) 32-bit words of the 64-bit product a * b, for a constant
    a < 2^32 and an int64 tensor b of 32-bit values."""
    x = a * (b >> 16)                                    # < 2^48
    s = a * (b & 0xFFFF) + ((x & 0xFFFF) << 16)          # < 2^49
    return s & _MASK32, (x >> 16) + (s >> 32)


MAX_SEED_DEPTH = 8     # sites a path may hold: kMaxSeedDepth of philox.cuh


class DeviceSeed:
    """A seed that lies on the device: `base`, an int64 tensor of one
    element holding a non-negative 63-bit step seed, and `path`, the static
    site indices under it. `site_seed(dev_seed, i)` appends `i`; the seed
    it names is the int rule applied along the path, which the kernels
    compute on the card from the address of `base`."""

    __slots__ = ("base", "path")

    def __init__(self, base: torch.Tensor, path: Tuple[int, ...] = ()):
        if base.dtype != torch.int64 or base.numel() != 1:
            raise ValueError(f"DeviceSeed needs an int64 tensor of one "
                             f"element, got {base.dtype} {tuple(base.shape)}")
        if len(path) > MAX_SEED_DEPTH:
            raise ValueError(f"a seed path holds at most {MAX_SEED_DEPTH} "
                             f"sites, got {len(path)}")
        self.base = base
        self.path = tuple(int(i) for i in path)

    @property
    def device(self) -> torch.device:
        return self.base.device

    def site(self, site: int) -> "DeviceSeed":
        return DeviceSeed(self.base, self.path + (int(site),))

    def __repr__(self) -> str:
        return f"DeviceSeed({self.base.device}, path={self.path})"


Seed = Union[int, DeviceSeed]


def as_device_seed(seed: Seed, device) -> DeviceSeed:
    """`seed` as a `DeviceSeed` on `device`: an int is written there by a
    fill (a direct call of a kernel wrapper, which a CUDA graph may capture
    with the int as a constant; a training step passes its table's seed,
    which is there already)."""
    if isinstance(seed, DeviceSeed):
        return seed
    seed = int(seed) & _MASK64
    if seed >= 1 << 63:
        seed -= 1 << 64
    return DeviceSeed(torch.full((1,), seed, dtype=torch.int64,
                                 device=device))


def _mul64(lo, hi, c: int):
    """(lo, hi) words of the 64-bit product (lo, hi) * c mod 2^64."""
    c_lo, c_hi = c & _MASK32, c >> 32
    p_lo, p_hi = _mulhilo(c_lo, lo)
    r_hi = (p_hi + _mulhilo(c_hi, lo)[0] + _mulhilo(c_lo, hi)[0]) & _MASK32
    return p_lo, r_hi


def _xor_shift(lo, hi, r: int):
    """(lo, hi) of z ^ (z >> r), 0 < r < 32."""
    return (lo ^ (((lo >> r) | (hi << (32 - r))) & _MASK32),
            hi ^ (hi >> r))


def _site_words(lo, hi, site: int):
    """`site_seed` on a seed held as its two 32-bit words (ints or int64
    tensors), 64-bit products split so no value leaves int64."""
    lo, hi = _mul64(lo, hi, 0x9E3779B97F4A7C15)
    s = lo + ((site + 1) & _MASK32)
    lo, hi = s & _MASK32, (hi + ((site + 1) >> 32) + (s >> 32)) & _MASK32
    lo, hi = _mul64(*_xor_shift(lo, hi, 30), 0xBF58476D1CE4E5B9)
    lo, hi = _mul64(*_xor_shift(lo, hi, 27), 0x94D049BB133111EB)
    lo, hi = _xor_shift(lo, hi, 31)
    return ((lo >> 1) | ((hi & 1) << 31)), hi >> 1


def seed_words(seed: Seed):
    """The Philox key of `seed` (low word, high word): ints for an int,
    int64 tensors of shape [1] on the seed's device for a `DeviceSeed`
    (its path applied in tensor ops, with no host read)."""
    if not isinstance(seed, DeviceSeed):
        return seed & _MASK32, (seed >> 32) & _MASK32
    base = seed.base.reshape(1)
    lo, hi = base & _MASK32, (base >> 32) & _MASK32
    for site in seed.path:
        lo, hi = _site_words(lo, hi, site)
    return lo, hi


def philox4x32(c0, c1, c2, c3, seed: Seed) -> Tuple[torch.Tensor, ...]:
    """Philox-4x32-10 of the counter (c0, c1, c2, c3) — int64 tensors of
    32-bit values (or ints), broadcast together — under the 64-bit `seed`
    (an int or a `DeviceSeed`) as its key (low word, high word). Returns
    the four output words."""
    k0, k1 = seed_words(seed)
    for _ in range(10):
        lo0, hi0 = _mulhilo(_M0, c0)
        lo1, hi1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def attention_keep_bytes(bh: int, seq: int, seed: Seed,
                         device=None) -> torch.Tensor:
    """The attention dropout's bytes, int64 `[bh, seq, seq]`: byte
    (h, i, j) is byte j % 16 of Philox at counter (j // 16, i, h, 0)."""
    n16 = -(-seq // _CHUNK)
    kw = dict(dtype=torch.int64, device=device)
    col16 = torch.arange(n16, **kw).view(1, 1, n16).expand(bh, seq, n16)
    row = torch.arange(seq, **kw).view(1, seq, 1)
    head = torch.arange(bh, **kw).view(bh, 1, 1).expand(bh, seq, n16)
    words = torch.stack(philox4x32(col16, row, head, 0, seed), dim=-1)
    shifts = torch.arange(0, 32, 8, **kw)
    keep = (words.unsqueeze(-1) >> shifts) & 0xFF     # [bh, seq, n16, 4, 4]
    return keep.reshape(bh, seq, n16 * _CHUNK)[:, :, :seq]


def attention_keep_scale(bh: int, seq: int, seed: Seed, threshold: int,
                         device=None) -> torch.Tensor:
    """float32 `[bh, seq, seq]`: 256 / t where the byte is below t (kept),
    else 0 — the matrix the flash kernels apply, and what the mask-export
    kernel writes."""
    keep = attention_keep_bytes(bh, seq, seed, device) < threshold
    return keep.to(torch.float32) * (256.0 / threshold)


def dropout_bits(n: int, seed: Seed, device=None) -> torch.Tensor:
    """The element dropout's 32-bit words, int64 `[n]`: element i takes
    word i % 4 of Philox at counter (i // 4 low word, high word, 0, 1)."""
    groups = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    words = philox4x32(groups & _MASK32, groups >> 32, 0, 1, seed)
    return torch.stack(words, dim=-1).reshape(-1)[:n]


def site_seed(seed: Seed, site: int) -> Seed:
    """The seed of dropout site `site` under step (or parent) seed `seed`:
    splitmix64 of the pair, as a non-negative 63-bit int. For a
    `DeviceSeed`, the same seed named by its path."""
    if isinstance(seed, DeviceSeed):
        return seed.site(site)
    z = (seed * 0x9E3779B97F4A7C15 + site + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1
