"""Flash attention, forward and backward — the CUDA kernels and their plain
versions.

Port of `analytics_zoo_tpu/pallas/flash_attention.py`: `_reference_attention`
(L42), `flash_attention` (L83), the custom VJP `_flash` (L181-186,
L599-605), the forward kernel `_fwd_kernel` (L217), which becomes
`csrc/flash_attn_fwd.cu`, and the backward `_flash_bwd` (L462) with its
three kernels (`_dq_kernel` L323, `_dkv_kernel` L362, `_bwd_fused_kernel`
L407), which become the two kernels of `csrc/flash_attn_bwd.cu`. bf16
inputs run tensor-core kernels (`mma.sync`, `csrc/mma.cuh`), f32 inputs
SIMT kernels on the CUDA cores. Each source's note says what bounds it
on an H100 and how its design answers that.

Attention dropout runs inside the kernels, as on the TPU: the keep rule is
the byte rule of `_keep_scale` (L189; keep iff byte < t, scale 256/t) on
Philox bits keyed on (seed, b·h, query row, key column) (`csrc/philox.cuh`).
The backward regenerates the same bits; nothing is stored. The seed (an
int or a `philox.DeviceSeed`) reaches the kernels as the address of the
step seed on the card and the site path under it, so a captured training
step draws each replay's masks from that replay's seed. The plain
versions take the same bits from `kernels/philox.py`, so the CPU route and
the card drop the same weights.

Routing is static, as in the JAX package:
- a CPU tensor takes the plain version (`_reference_attention` and
  `_reference_lse` forward, `_reference_attention_bwd` backward, the
  kernels' own formula);
- a CUDA tensor launches the kernels; a build or launch failure raises, and
  nothing falls back to the plain version;
- a full `[B,1,T,T]` mask takes the plain version on any device, as the JAX
  package rules at L107-113;
- with autograd off (serving runs under `torch.inference_mode`) only the
  forward runs: no autograd node, no saved tensors.

Layouts are the JAX package's: q, k, v are `[B, H, T, Dh]`; the padding mask
is additive `[B, 1, 1, T]` float32; lse and delta are `[B, H, T]` float32.

Declared costs (`kernels.kernel_region`) are the JAX kernels' `_attn_cost`
(L258): 2 products for the forward (L315), and for the backward the dQ
and dK/dV pair the port launches, 3 + 4 products (L559, L589).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build, kernel_region
from analytics_zoo_tpu_torch.kernels.dropout import (SEED_ARGTYPES,
                                                     _as_seed,
                                                     _byte_threshold,
                                                     seed_args)
from analytics_zoo_tpu_torch.kernels.philox import (MAX_SEED_DEPTH, Seed,
                                                    attention_keep_scale)

KERNEL_NAME = "flash_attention_fwd"
BWD_DKV_NAME = "flash_attention_bwd_dkv"
BWD_DQ_NAME = "flash_attention_bwd_dq"
KEEP_SCALE_NAME = "flash_attention_keep_scale"
SOURCE = "flash_attn_fwd.cu"
BWD_SOURCE = "flash_attn_bwd.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 128
_MAX_BH = 65535          # gridDim.y


def _reference_attention(q, k, v, mask=None,
                         keep_scale: Optional[torch.Tensor] = None):
    """Exact O(T²) attention: the plain version of the forward kernel, and
    what `keras.transformer.dot_product_attention` runs without
    `use_flash`. Scores are formed in the input dtype, divided by √D, then
    softmaxed in f32; the weights are cast back to the input dtype before
    the PV product (JAX L47-56). `keep_scale` (`[B,H,T,T]` or
    broadcastable: 0 where dropped, the keep scale where kept) is the
    injected dropout mask."""
    depth = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(depth)
    scores = scores.float()
    if mask is not None:
        scores = scores + mask
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    if keep_scale is not None:
        weights = weights * keep_scale.to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def _reference_lse(q, k, mask=None) -> torch.Tensor:
    """Per-row log-sum-exp of the f32 scores, `[B, H, T]` — what the kernel
    returns beside O (the TPU kernel's `lse`, L255)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask
    return torch.logsumexp(scores, dim=-1)


def _reference_attention_bwd(q, k, v, mask, o, lse, do,
                             keep_scale: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) by the backward kernels' formula, in f32 from the
    inputs, returned in the input dtype: P from the forward's lse, delta =
    rowsum(dO·O), dS = P∘(dO·vᵀ∘keep − delta) (JAX L346-359, L384-404)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if mask is not None:
        scores = scores + mask
    p = torch.exp(scores - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    p_v = p
    if keep_scale is not None:
        dp = dp * keep_scale
        p_v = p * keep_scale
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p_v, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _attn_cost(n_matmuls: int, q, extra_f32_out_elems: int = 0):
    """(flops, bytes) of one attention kernel over `[B,H,T,D]` (JAX L258):
    `n_matmuls` T×T×D products a head at 2 FLOPs each; bytes are the
    O(T·D) streams, never the O(T²) scores."""
    B, H, T, D = q.shape
    bh = B * H
    item = q.element_size()
    return (2.0 * n_matmuls * bh * T * T * D,
            float(bh * T * D * item * (4 + n_matmuls)
                  + extra_f32_out_elems * 4))


def _fwd_cost(q):
    B, H, T, _ = q.shape
    return _attn_cost(2, q, extra_f32_out_elems=B * H * T)   # QKᵀ + PV


def _bwd_cost(q):
    dq = _attn_cost(3, q)       # scores, dP/dS, dQ
    dkv = _attn_cost(4, q)      # scores, dV, dS, dK
    return dq[0] + dkv[0], dq[1] + dkv[1]


def _dropout_args(dropout_rate: float, dropout_seed: Optional[Seed],
                  device):
    """(the three seed arguments, t, keep scale) for the kernels; t = 0
    means no dropout, and the seed is then not read."""
    if dropout_rate <= 0.0:
        return None, 0, (ctypes.c_longlong * MAX_SEED_DEPTH)(), 0, 1.0
    t = _byte_threshold(dropout_rate)
    return (*seed_args(dropout_seed, device), t, 256.0 / t)


def _keep_scale(q, dropout_rate: float, dropout_seed: Optional[Seed]):
    """The plain versions' keep-scale matrix `[B,H,T,T]`, or None."""
    if dropout_rate <= 0.0:
        return None
    B, H, T, _ = q.shape
    return attention_keep_scale(B * H, T, dropout_seed,
                                _byte_threshold(dropout_rate),
                                q.device).view(B, H, T, T)


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
    if mask is not None:
        if (tuple(mask.shape) != (B, 1, 1, T) or mask.dtype != torch.float32
                or mask.device != q.device or not mask.is_contiguous()):
            raise ValueError(
                f"flash_attention kernel takes a contiguous float32 padding "
                f"mask [B,1,1,T] = {(B, 1, 1, T)} on {q.device}, got "
                f"{tuple(mask.shape)} {mask.dtype} {mask.device}")


def _check_bwd_inputs(q, o, lse, do):
    B, H, T, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash_attention backward needs {name} "
                             f"contiguous, 16-byte aligned and shaped like q")
    if (tuple(lse.shape) != (B, H, T) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash_attention backward needs lse contiguous "
                         f"float32 {(B, H, T)}")


_TAIL_ARGS = [ctypes.c_float, ctypes.c_int] + SEED_ARGTYPES + [
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + _TAIL_ARGS
_BWD_DKV_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + _TAIL_ARGS
_BWD_DQ_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + _TAIL_ARGS


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(q, k, v, mask, dropout_rate=0.0, dropout_seed=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_kernel_inputs(q, k, v, mask)
    B, H, T, D = q.shape
    fn = _build.bind(SOURCE, "azt_flash_attn_fwd", _FWD_ARGS)
    drop = _dropout_args(dropout_rate, dropout_seed, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                mask.data_ptr() if mask is not None else None,
                out.data_ptr(), lse.data_ptr(), B * H, H, T, D,
                1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype], *drop, _stream(q))
    _build.check_launch(SOURCE, rc, "flash_attention")
    LAUNCHES.add(KERNEL_NAME)
    return out, lse


def _bwd_tail(q, dropout_rate, dropout_seed):
    B, H, T, D = q.shape
    return (B * H, H, T, D, 1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype],
            *_dropout_args(dropout_rate, dropout_seed, q.device))


def _bwd_ptrs(q, k, v, mask, do, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None, do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def _launch_bwd_dkv(q, k, v, mask, do, lse, delta, dropout_rate=0.0,
                    dropout_seed=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the dK/dV kernel; inputs checked by the caller."""
    fn = _build.bind(BWD_SOURCE, "azt_flash_attn_bwd_dkv", _BWD_DKV_ARGS)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = fn(*_bwd_ptrs(q, k, v, mask, do, lse, delta), dk.data_ptr(),
                dv.data_ptr(), *_bwd_tail(q, dropout_rate, dropout_seed),
                _stream(q))
    _build.check_launch(BWD_SOURCE, rc, "flash_attention_bwd_dkv")
    LAUNCHES.add(BWD_DKV_NAME)
    return dk, dv


def _launch_bwd_dq(q, k, v, mask, do, lse, delta, dropout_rate=0.0,
                   dropout_seed=None) -> torch.Tensor:
    """dq from the dQ kernel; inputs checked by the caller."""
    fn = _build.bind(BWD_SOURCE, "azt_flash_attn_bwd_dq", _BWD_DQ_ARGS)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = fn(*_bwd_ptrs(q, k, v, mask, do, lse, delta), dq.data_ptr(),
                *_bwd_tail(q, dropout_rate, dropout_seed), _stream(q))
    _build.check_launch(BWD_SOURCE, rc, "flash_attention_bwd_dq")
    LAUNCHES.add(BWD_DQ_NAME)
    return dq


def _delta(o, do) -> torch.Tensor:
    """rowsum(dO·O) `[B,H,T]` f32: computed outside the kernels, as the
    JAX package does (L480)."""
    return (do.float() * o.float()).sum(-1).contiguous()


def _launch_bwd(q, k, v, mask, o, lse, do, dropout_rate=0.0,
                dropout_seed=None) -> Tuple[torch.Tensor, ...]:
    _check_kernel_inputs(q, k, v, mask)
    _check_bwd_inputs(q, o, lse, do)
    delta = _delta(o, do)
    dk, dv = _launch_bwd_dkv(q, k, v, mask, do, lse, delta, dropout_rate,
                             dropout_seed)
    dq = _launch_bwd_dq(q, k, v, mask, do, lse, delta, dropout_rate,
                        dropout_seed)
    return dq, dk, dv


def keep_scale_matrix(q_shape, dropout_rate: float, dropout_seed: Seed,
                      device) -> torch.Tensor:
    """The kernels' keep-scale matrix `[B,H,T,T]` for a seed, written by the
    mask-export kernel (a test aid: the card checks inject it into the
    plain versions). CUDA devices only; on the CPU use
    `kernels.philox.attention_keep_scale`."""
    B, H, T, _ = q_shape
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("keep_scale_matrix runs the export kernel: CUDA "
                         "devices only")
    fn = _build.bind(BWD_SOURCE, "azt_attn_keep_scale", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + SEED_ARGTYPES + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    if dropout_rate <= 0.0:
        raise ValueError("keep_scale_matrix needs dropout_rate > 0")
    drop = _dropout_args(dropout_rate, dropout_seed, device)
    out = torch.empty((B, H, T, T), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = fn(out.data_ptr(), B * H, T, *drop, _stream(out))
    _build.check_launch(BWD_SOURCE, rc, "flash_attention_keep_scale")
    LAUNCHES.add(KEEP_SCALE_NAME)
    return out


def flash_attention_fwd(q, k, v, mask: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[Seed] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O `[B,H,T,D]` in the input dtype, lse `[B,H,T]` float32) for a
    padding mask `[B,1,1,T]` or none. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    with kernel_region(_fwd_cost, q):
        if q.device.type == "cpu":
            keep = _keep_scale(q, dropout_rate, dropout_seed)
            return (_reference_attention(q, k, v, mask, keep),
                    _reference_lse(q, k, mask))
        if q.device.type != "cuda":
            raise ValueError(
                f"flash_attention: unsupported device {q.device}")
        return _launch(q, k, v, mask, dropout_rate, dropout_seed)


def flash_attention_bwd(q, k, v, mask, o, lse, do,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[Seed] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the input dtype from the forward's inputs, O, lse
    and the output gradient. CPU tensors take the plain version; CUDA
    tensors launch the dK/dV and dQ kernels."""
    with kernel_region(_bwd_cost, q):
        if q.device.type == "cpu":
            keep = _keep_scale(q, dropout_rate, dropout_seed)
            return _reference_attention_bwd(q, k, v, mask, o, lse, do, keep)
        if q.device.type != "cuda":
            raise ValueError(
                f"flash_attention: unsupported device {q.device}")
        return _launch_bwd(q, k, v, mask, o, lse, do, dropout_rate,
                           dropout_seed)


class _FlashAttention(torch.autograd.Function):
    """The JAX `_flash` custom VJP: the forward saves (q, k, v, mask, O,
    lse), the backward runs the backward kernels; the padding mask gets no
    gradient (zero in the JAX package, L594-596)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, dropout_rate: float, dropout_seed):
        out, lse = flash_attention_fwd(q, k, v, mask, dropout_rate,
                                       dropout_seed)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.dropout = (dropout_rate, dropout_seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse,
                                         dout.contiguous(), *ctx.dropout)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[Seed] = None):
    """q, k, v: `[B, H, T, Dh]`. mask: additive `[B,1,1,T]` (padding) or
    `[B,1,T,T]` (full; plain version only). `dropout_rate > 0` needs a
    `dropout_seed` (an integer or a `DeviceSeed`). Differentiable. Returns
    `[B, H, T, Dh]`."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("flash_attention: dropout_rate > 0 needs a "
                         "dropout_seed (deterministic in-kernel masks)")
    rate = float(dropout_rate) if dropout_rate > 0.0 else 0.0
    seed = _as_seed(dropout_seed) if rate > 0.0 else None
    if mask is not None and mask.dim() == 4 and mask.shape[2] != 1:
        # full [B,1,T,T] mask: the kernels take padding masks only
        return _reference_attention(q, k, v, mask,
                                    _keep_scale(q, rate, seed))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, mask, rate, seed)
    return flash_attention_fwd(q, k, v, mask, rate, seed)[0]
