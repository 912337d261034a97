"""Fused Adam — the optimizer sweep as one CUDA pass per leaf, in place.

Port of `analytics_zoo_tpu/pallas/fused_adam.py`: `_fold_scalars` (L70),
`_adam_math` (L83), the kernel `_fused_kernel` (L93), which becomes
`csrc/fused_adam.cu`, `leaf_cost` / `update_cost` (L104 / L114) and
`fused_adam_step` (L170).

Numerics as there: the bias correction is folded into three f32 scalars on
the host, `(a, b, lr·wd)` with `a = lr·√c2/c1`, `b = eps·√c2`,
`c_i = 1 - βᵢᵗ`, so the per-element math is
`p ← p − a·m/(√v + b) − lr·wd·p` on the uncorrected new moments; moments
are f32, params f32 or bf16. The update is in place: the params and
moments tensors are written, never reallocated (the JAX kernel aliases
them to its outputs). A leaf is walked as one flat array, so a
channels_last conv kernel runs as it lies, its moments and gradient in
the same layout.

Routing is static: CPU tensors take the plain version (`_adam_math`, one
rounding per operation, which the kernel repeats operation for operation),
CUDA tensors launch the kernel or raise. The JAX package's availability
probe (`fused_available`, which catches every error and degrades to
optax) is not carried over: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build

KERNEL_NAME = "fused_adam"
SOURCE = "fused_adam.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _fold_scalars(count: int, lr: float, b1: float, b2: float, eps: float,
                  weight_decay: float) -> Tuple[float, float, float]:
    """(a, b, lr·wd), each an f32 value: the bias correction folded into
    scalars. `count` is the NEW step number t (post-increment). Computed in
    float32 as the JAX package computes it."""
    f32 = np.float32
    t = f32(count)
    c1 = f32(1.0) - f32(b1) ** t
    c2 = f32(1.0) - f32(b2) ** t
    sq2 = np.sqrt(c2)
    lr = f32(lr)
    return (float(lr * sq2 / c1), float(f32(eps) * sq2),
            float(lr * f32(weight_decay)))


def _adam_math(p, m, v, g, a: float, b: float, lrwd: float, b1: float,
               b2: float):
    """The shared update on f32 tensors — the kernel's arithmetic, one
    rounding per operation, in the same order."""
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * (g * g)
    p_new = p - a * m_new / (torch.sqrt(v_new) + b) - lrwd * p
    return p_new, m_new, v_new


def leaf_cost(shape, dtype: torch.dtype) -> Tuple[float, float]:
    """(flops, bytes) of one fused update of one leaf: read g, read and
    write p (param dtype), m and v (f32) — the 7-pass floor — with g taken
    in the param dtype. ~12 elementwise flops per element."""
    n = 1
    for s in shape:
        n *= int(s)
    pbytes = torch.finfo(dtype).bits // 8
    return 12.0 * n, float(n * (4 + 2 * pbytes + 4 * 4))


def update_cost(params: Mapping[str, torch.Tensor]) -> Tuple[float, float]:
    """(flops, bytes) of one fused sweep over every leaf."""
    flops = bytes_ = 0.0
    for p in params.values():
        f, b = leaf_cost(tuple(p.shape), p.dtype)
        flops += f
        bytes_ += b
    return flops, bytes_


def _check_kernel_inputs(p, m, v, g) -> None:
    if p.dtype not in _DTYPE_CODES or g.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_adam kernel takes float32 or bfloat16 params "
                        f"and grads, got {p.dtype} / {g.dtype}")
    for name, t in (("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_adam kernel keeps {name} in float32, got "
                            f"{t.dtype}")
    if not _dense(p):
        raise ValueError("fused_adam kernel needs p contiguous (or a "
                         "channels_last 4-d tensor)")
    for name, t in (("m", m), ("v", v), ("g", g)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"fused_adam: {name} {tuple(t.shape)} on "
                             f"{t.device} must match p {tuple(p.shape)} on "
                             f"{p.device}")
        if not _same_layout(t, p):
            raise ValueError(f"fused_adam kernel needs {name} contiguous in "
                             f"p's layout (strides {t.stride()} vs "
                             f"{p.stride()})")


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal strides on every axis longer than 1 (the axes that place
    elements): the two walk their elements in the same order."""
    return all(sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape)
               if n > 1)


def _dense(t: torch.Tensor) -> bool:
    """Contiguous in the default or the channels_last format: the kernel
    walks the leaf as one flat array of `numel` elements."""
    return t.is_contiguous() or (
        t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))


def _launch(p, m, v, g, a, b, lrwd, b1, b2) -> None:
    _check_kernel_inputs(p, m, v, g)
    n = p.numel()
    if n == 0:
        return
    fn = _build.bind(SOURCE, "azt_fused_adam", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong] + [ctypes.c_float] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), n,
                a, b, lrwd, b1, b2, 1.0 - b1, 1.0 - b2,
                _DTYPE_CODES[p.dtype], _DTYPE_CODES[g.dtype], stream)
    _build.check_launch(SOURCE, rc, "fused_adam")
    LAUNCHES.add(KERNEL_NAME)


def leaf_update(p, m, v, g, scalars: Tuple[float, float, float], b1: float,
                b2: float) -> None:
    """One leaf, in place: CPU tensors through `_adam_math`, CUDA tensors
    through the kernel."""
    a, b, lrwd = scalars
    if p.device.type == "cpu":
        p_new, m_new, v_new = _adam_math(p.float(), m, v, g.float(), a, b,
                                         lrwd, b1, b2)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
        return
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam: unsupported device {p.device}")
    if not _same_layout(g, p):
        # a gradient in another memory format than its leaf (autograd
        # picks the format): one copy into the leaf's layout
        g = torch.empty_like(p, dtype=g.dtype).copy_(g)
    _launch(p, m, v, g, a, b, lrwd, float(b1), float(b2))


@torch.no_grad()
def fused_adam_step(params: Dict[str, torch.Tensor],
                    mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
                    grads: Mapping[str, torch.Tensor], count: int, *,
                    lr: float, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, weight_decay: float = 0.0):
    """One fused Adam step over every leaf, in place: returns the same
    (params, mu, nu) dicts. `count` is the new step number (1 on the first
    call); `lr` the resolved learning rate of this step."""
    scalars = _fold_scalars(count, lr, b1, b2, eps, weight_decay)
    for name, p in params.items():
        leaf_update(p, mu[name], nu[name], grads[name], scalars, b1, b2)
    return params, mu, nu
