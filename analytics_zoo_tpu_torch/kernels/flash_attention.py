"""Flash attention, forward — the CUDA kernel and its plain version.

Port of `analytics_zoo_tpu/pallas/flash_attention.py`: `_reference_attention`
(L42), `flash_attention` (L83) and the forward kernel `_fwd_kernel` (L217),
which becomes `csrc/flash_attn_fwd.cu` (its source note says what bounds it
on an H100 and how its design answers that).

Routing is static, as in the JAX package:
- a CPU tensor takes the plain version (`_reference_attention`, and
  `_reference_lse` for the log-sum-exp);
- a CUDA tensor launches the kernel; a build or launch failure raises, and
  nothing falls back to the plain version;
- a full `[B,1,T,T]` mask takes the plain version on any device, as the JAX
  package rules at L107-113;
- `dropout_rate > 0` raises NotImplementedError: in-kernel dropout and the
  backward kernels come with the training slice of the port.

Layouts are the JAX package's: q, k, v are `[B, H, T, Dh]`; the padding mask
is additive `[B, 1, 1, T]` float32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build

KERNEL_NAME = "flash_attention_fwd"
SOURCE = "flash_attn_fwd.cu"
DROPOUT_NOT_PORTED = ("attention dropout is not ported yet: in-kernel "
                      "dropout comes with the training slice of the port "
                      "(the backward kernels)")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 128
_MAX_BH = 65535          # gridDim.y


def _reference_attention(q, k, v, mask=None, dropout_rate: float = 0.0,
                         dropout_key=None):
    """Exact O(T²) attention: the plain version of the kernel, and what
    `keras.transformer.dot_product_attention` runs without `use_flash`.
    Scores are formed in the input dtype, divided by √D, then softmaxed in
    f32; the weights are cast back to the input dtype before the PV
    product (JAX L47-56)."""
    if dropout_rate > 0.0 and dropout_key is not None:
        raise NotImplementedError(DROPOUT_NOT_PORTED)
    depth = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(depth)
    scores = scores.float()
    if mask is not None:
        scores = scores + mask
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def _reference_lse(q, k, mask=None) -> torch.Tensor:
    """Per-row log-sum-exp of the f32 scores, `[B, H, T]` — what the kernel
    returns beside O (the TPU kernel's `lse`, L255)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask
    return torch.logsumexp(scores, dim=-1)


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.azt_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.azt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.azt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(q, k, v, mask):
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B, H, T, D], got "
                         f"{tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash_attention: {name} {tuple(t.shape)} {t.dtype} "
                f"{t.device} must match q {tuple(q.shape)} {q.dtype} "
                f"{q.device}")
    B, H, T, D = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if D > _MAX_DIM:
        raise ValueError(f"flash_attention kernel takes a head dim up to "
                         f"{_MAX_DIM}, got {D}")
    if B * H > _MAX_BH:
        raise ValueError(f"flash_attention kernel takes B*H <= {_MAX_BH}, "
                         f"got {B * H}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs {name} contiguous "
                             "and 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "flash_attention on CUDA has no backward yet: the backward "
                "kernels come with the training slice of the port")
    if mask is not None:
        if (tuple(mask.shape) != (B, 1, 1, T) or mask.dtype != torch.float32
                or mask.device != q.device or not mask.is_contiguous()):
            raise ValueError(
                f"flash_attention kernel takes a contiguous float32 padding "
                f"mask [B,1,1,T] = {(B, 1, 1, T)} on {q.device}, got "
                f"{tuple(mask.shape)} {mask.dtype} {mask.device}")


def _launch(q, k, v, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_kernel_inputs(q, k, v, mask)
    B, H, T, D = q.shape
    lib = _library()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.azt_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            out.data_ptr(), lse.data_ptr(), B * H, H, T, D,
            1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: "
            f"{lib.azt_cuda_error_string(rc).decode()} (cudaError {rc})")
    LAUNCHES.add(KERNEL_NAME)
    return out, lse


def flash_attention_fwd(q, k, v, mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O `[B,H,T,D]` in the input dtype, lse `[B,H,T]` float32) for a
    padding mask `[B,1,1,T]` or none. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, mask), _reference_lse(q, k, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, mask)


def flash_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None):
    """q, k, v: `[B, H, T, Dh]`. mask: additive `[B,1,1,T]` (padding) or
    `[B,1,T,T]` (full; plain version only). Returns `[B, H, T, Dh]`."""
    if dropout_rate > 0.0:
        raise NotImplementedError(DROPOUT_NOT_PORTED)
    if mask is not None and mask.dim() == 4 and mask.shape[2] != 1:
        return _reference_attention(q, k, v, mask)   # full [B,1,T,T] mask
    return flash_attention_fwd(q, k, v, mask)[0]
