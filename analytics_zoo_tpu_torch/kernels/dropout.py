"""Inverted dropout — the CUDA kernel and its plain version.

Port of `analytics_zoo_tpu/pallas/dropout.py`: `_dropout_threshold` (L58),
`_byte_threshold` (L64), the kernel `_kernel` (L110), which becomes
`csrc/dropout.cu`, its custom VJP `_fused` (L152-167) and `fused_dropout`
(L183). Semantics kept: rate <= 0 returns x; rate >= 1 returns zeros;
otherwise a seed is required. The backward reruns the same kernel on dout
with the same seed and stores no mask.

The JAX package chooses among three implementations (`ZOO_DROPOUT_IMPL`:
uint8 bytes, uint32 bernoulli, the Pallas kernel); the port has one rule,
the kernel's uint32 rule (keep iff bits >= `_dropout_threshold(rate)`,
scale 1/(1-rate)), on bits from Philox (`kernels/philox.py`). Routing is
static: a CPU tensor takes the plain version (`_reference_dropout`, with the
same Philox bits, so it drops the same elements), a CUDA tensor launches
the kernel or raises. The seed is an int or a `philox.DeviceSeed`; the
kernel reads it from device memory (an int is written there first), so a
training step captured as a CUDA graph takes each replay's seed from the
step's row of the scalar table. Its declared cost
(`kernels.kernel_region`) is the JAX kernel's (L143): one read and one
write of x, 3 FLOPs an element.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build, kernel_region
from analytics_zoo_tpu_torch.kernels.philox import (MAX_SEED_DEPTH,
                                                    DeviceSeed, Seed,
                                                    as_device_seed,
                                                    dropout_bits)

KERNEL_NAME = "dropout"
SOURCE = "dropout.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _dropout_threshold(rate: float) -> int:
    """keep iff bits >= threshold (uint32 compare) — the kernel's rule."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _byte_threshold(rate: float) -> int:
    """keep iff byte < t — the byte rule of the attention dropout:
    t = round(keep*256), clamped to [1, 255]; scale by the exact keep
    probability 256/t (the rate is quantized to 1/256)."""
    return max(1, min(255, int(round((1.0 - rate) * 256))))


def _scale(rate: float, dtype: torch.dtype) -> torch.Tensor:
    """1/(1-rate) in `dtype`, as the kernel applies it."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=dtype)


SEED_ARGTYPES = [ctypes.c_void_p, ctypes.c_int,
                 ctypes.POINTER(ctypes.c_longlong)]
"""How a kernel's C entry takes a seed: the address of the int64 step seed
on the card, the path's depth and a host array of its sites."""


def seed_args(seed: Seed, device) -> tuple:
    """The three `SEED_ARGTYPES` arguments of `seed` for a launch on
    `device`."""
    dev = as_device_seed(seed, device)
    if dev.base.device.type != torch.device(device).type:
        raise ValueError(f"dropout seed on {dev.base.device}, tensor on "
                         f"{device}")
    sites = (ctypes.c_longlong * MAX_SEED_DEPTH)(*dev.path)
    return dev.base.data_ptr(), len(dev.path), sites


def dropout_keep(shape, seed: Seed, rate: float, device=None) -> torch.Tensor:
    """The kernel's keep mask (bool, `shape`) for `seed` at `rate`."""
    n = 1
    for s in shape:
        n *= s
    bits = dropout_bits(n, seed, device)
    return (bits >= _dropout_threshold(rate)).reshape(shape)


def _reference_dropout(x: torch.Tensor, rate: float,
                       keep: torch.Tensor) -> torch.Tensor:
    """The plain version, with the keep mask injected: x * scale where
    kept, else 0 (JAX `_kernel` L116-120)."""
    # made on the device (a fill, no host copy), so a step captured as a
    # CUDA graph can run the plain version too
    scale = torch.full((), 1.0 / (1.0 - rate), dtype=x.dtype,
                       device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def _check_kernel_input(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"dropout kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dropout kernel needs a contiguous tensor")


def _launch(x: torch.Tensor, rate: float, seed: Seed) -> torch.Tensor:
    _check_kernel_input(x)
    fn = _build.bind(SOURCE, "azt_dropout", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + SEED_ARGTYPES
        + [ctypes.c_uint32, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    vec = n % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), n, *seed_args(seed, x.device),
                _dropout_threshold(rate), float(_scale(rate, x.dtype)),
                _DTYPE_CODES[x.dtype], int(vec), stream)
    _build.check_launch(SOURCE, rc, "dropout")
    LAUNCHES.add(KERNEL_NAME)
    return out


def dropout_cost(x: torch.Tensor):
    """(flops, bytes) of one pass (JAX L143): threshold, scale and select
    an element; x read once and written once, the bits never in HBM."""
    n = x.numel()
    return 3.0 * n, float(2 * n * x.element_size())


def dropout_apply(x: torch.Tensor, rate: float, seed: Seed) -> torch.Tensor:
    """One pass of the rule over `x` (0 < rate < 1): CPU tensors take the
    plain version, CUDA tensors launch the kernel."""
    with kernel_region(dropout_cost, x):
        if x.device.type == "cpu":
            return _reference_dropout(x, rate,
                                      dropout_keep(x.shape, seed, rate))
        if x.device.type != "cuda":
            raise ValueError(f"dropout: unsupported device {x.device}")
        return _launch(x, rate, seed)


class _Dropout(torch.autograd.Function):
    """d/dx [keep * scale * x] = keep * scale: the backward is the same
    pass over dout with the same seed (JAX `_fused_bwd`, L162)."""

    @staticmethod
    def forward(ctx, x, rate: float, seed: Seed):
        ctx.rate, ctx.seed = rate, seed
        return dropout_apply(x, rate, seed)

    @staticmethod
    def backward(ctx, dout):
        return dropout_apply(dout.contiguous(), ctx.rate, ctx.seed), None, None


def fused_dropout(x: torch.Tensor, rate: float, *,
                  seed: Optional[Seed] = None) -> torch.Tensor:
    """Inverted dropout over `x` at `rate`, reproducible from `seed` (an
    integer or a `DeviceSeed`). Differentiable. rate >= 1 zeroes the
    tensor."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if seed is None:
        raise ValueError("fused_dropout needs a `seed`")
    seed = _as_seed(seed)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Dropout.apply(x, float(rate), seed)
    return dropout_apply(x, float(rate), seed)


def _as_seed(seed) -> Seed:
    """An int (numpy's too) as an int; a `DeviceSeed` as it is."""
    return seed if isinstance(seed, DeviceSeed) else int(seed)
