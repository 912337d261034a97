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
integer (the port's stand-in for splitting a `jax.random` key).

32-bit words are held in int64 tensors; the 32x32 -> 64-bit products of
Philox are split into 16-bit halves so no intermediate leaves int64.
"""

from __future__ import annotations

from typing import Tuple

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


def philox4x32(c0, c1, c2, c3, seed: int) -> Tuple[torch.Tensor, ...]:
    """Philox-4x32-10 of the counter (c0, c1, c2, c3) — int64 tensors of
    32-bit values (or ints), broadcast together — under the 64-bit `seed`
    as its key (low word, high word). Returns the four output words."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        lo0, hi0 = _mulhilo(_M0, c0)
        lo1, hi1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def attention_keep_bytes(bh: int, seq: int, seed: int,
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


def attention_keep_scale(bh: int, seq: int, seed: int, threshold: int,
                         device=None) -> torch.Tensor:
    """float32 `[bh, seq, seq]`: 256 / t where the byte is below t (kept),
    else 0 — the matrix the flash kernels apply, and what the mask-export
    kernel writes."""
    keep = attention_keep_bytes(bh, seq, seed, device) < threshold
    return keep.to(torch.float32) * (256.0 / threshold)


def dropout_bits(n: int, seed: int, device=None) -> torch.Tensor:
    """The element dropout's 32-bit words, int64 `[n]`: element i takes
    word i % 4 of Philox at counter (i // 4 low word, high word, 0, 1)."""
    groups = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    words = philox4x32(groups & _MASK32, groups >> 32, 0, 1, seed)
    return torch.stack(words, dim=-1).reshape(-1)[:n]


def site_seed(seed: int, site: int) -> int:
    """The seed of dropout site `site` under step (or parent) seed `seed`:
    splitmix64 of the pair, as a non-negative 63-bit int."""
    z = (seed * 0x9E3779B97F4A7C15 + site + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1
