"""Ring attention: exact attention over a sequence-sharded context.

Port of `analytics_zoo_tpu/parallel/ring_attention.py` (L1-114):
`ring_attention` (L83) with the same layouts (`[B, H, T, D]`, additive key
mask `[B, T]`) and the same math. A torch rank holds its own block, so the
arguments are this rank's blocks along the `sequence` axis (the JAX
`shard_map` body's view, `_ring_attention_shard` L29): q, k, v `[B, H,
T/n, D]` and the mask `[B, T/n]`; the result is this rank's block of the
output.

- The plain path (CPU tensors) is the JAX body's einsum online softmax
  (L34-80): the local block first, then n - 1 rotations of K, V and the
  mask through the mesh's `permute`, each block merged into (o, l, m).
  It is differentiable: `_Permute`'s backward is the reverse hop.
- The kernel path (CUDA tensors) runs each block through the port's flash
  forward kernel (`kernels/flash_attention.flash_attention_fwd`, row 1 of
  the kernel table), which returns the block's O and lse; the blocks merge
  by lse (`_merge`). The backward (`_RingFlash`) calls the flash backward
  kernels (`flash_attention_bwd`, rows 2-4) once a block with the ring's
  final O and lse, so each block's P and delta are the global ones; dQ
  accumulates at home, and each block's dK / dV accumulate in buffers
  that travel with it and take one more hop home at the end.
- Departure: at a sequence axis of 1 the JAX function calls
  `_reference_attention` (L100-104); the port calls the flash wrapper,
  which launches row 1 (and rows 2-4 in a backward) on a CUDA tensor and
  takes the plain version on the CPU.
- A head axis (`tensor`) larger than 1 raises NotImplementedError: heads
  over the tensor axis wait for ROADMAP item 7b.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_fwd)

NEG_INF = -1e30


class _Permute(torch.autograd.Function):
    """`mesh.permute` with the reverse hop as its backward (the transpose
    of `lax.ppermute`)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, shift):
        ctx.hop = (mesh, axis, shift)
        return mesh.permute(t, axis, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.hop
        return mesh.permute(g.contiguous(), axis, -shift), None, None, None


def permute(t, mesh, axis: str, shift: int = 1):
    """A differentiable ring hop (`lax.ppermute` with pairs (i, i +
    shift))."""
    if t is None:
        return None
    if torch.is_grad_enabled() and t.requires_grad:
        return _Permute.apply(t, mesh, axis, shift)
    return mesh.permute(t, axis, shift)


def _ring_plain(q, k, v, kmask, mesh, axis: str):
    """The JAX shard body (L29-80) on this rank's blocks."""
    n = mesh.size(axis)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float() * scale

    def block_update(o, l, m, k, v, kmask):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k.float())
        if kmask is not None:
            s = s + kmask[:, None, None, :]
        m_blk = s.amax(-1)
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + p.sum(-1)
        o_new = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                    v.float())
        return o_new, l_new, m_new

    o = torch.zeros_like(qf)
    l = torch.zeros_like(qf[..., 0])
    m = torch.full_like(qf[..., 0], NEG_INF)
    o, l, m = block_update(o, l, m, k, v, kmask)
    for _ in range(n - 1):
        k, v = permute(k, mesh, axis), permute(v, mesh, axis)
        kmask = permute(kmask, mesh, axis)
        o, l, m = block_update(o, l, m, k, v, kmask)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l[..., None]).to(q.dtype)


def _merge(o, lse, o_blk, lse_blk):
    """Two partial attentions merged by their log-sum-exps (f32)."""
    lse_new = torch.logaddexp(lse, lse_blk)
    o = o * torch.exp(lse - lse_new)[..., None] \
        + o_blk.float() * torch.exp(lse_blk - lse_new)[..., None]
    return o, lse_new


def _ring_flash_fwd(q, k, v, m4, mesh, axis: str):
    """(O in q's dtype, lse f32) of the ring over the flash forward."""
    n = mesh.size(axis)
    o_blk, lse = flash_attention_fwd(q, k, v, m4)
    o = o_blk.float()
    for _ in range(n - 1):
        k, v = mesh.permute(k, axis), mesh.permute(v, axis)
        m4 = mesh.permute(m4, axis) if m4 is not None else None
        o_blk, lse_blk = flash_attention_fwd(q, k, v, m4)
        o, lse = _merge(o, lse, o_blk, lse_blk)
    return o.to(q.dtype).contiguous(), lse.contiguous()


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, m4, mesh, axis):
        out, lse = _ring_flash_fwd(q, k, v, m4, mesh, axis)
        ctx.save_for_backward(q, k, v, m4, out, lse)
        ctx.ring = (mesh, axis)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, m4, out, lse = ctx.saved_tensors
        mesh, axis = ctx.ring
        n = mesh.size(axis)
        do = dout.contiguous()
        dq = torch.zeros_like(q, dtype=torch.float32)
        dk = torch.zeros_like(k, dtype=torch.float32)
        dv = torch.zeros_like(v, dtype=torch.float32)
        for s in range(n):
            if s:
                k, v = mesh.permute(k, axis), mesh.permute(v, axis)
                m4 = mesh.permute(m4, axis) if m4 is not None else None
                dk, dv = mesh.permute(dk, axis), mesh.permute(dv, axis)
            dq_s, dk_s, dv_s = flash_attention_bwd(q, k, v, m4, out, lse, do)
            dq += dq_s.float()
            dk += dk_s.float()
            dv += dv_s.float()
        # each block's accumulators sit one hop behind its home
        dk, dv = mesh.permute(dk, axis), mesh.permute(dv, axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def _ring_flash(q, k, v, m4, mesh, axis: str):
    """The kernel path on any device (the flash wrappers take their plain
    versions on CPU tensors): differentiable through `_RingFlash`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingFlash.apply(q, k, v, m4, mesh, axis)
    return _ring_flash_fwd(q, k, v, m4, mesh, axis)[0]


def ring_attention(q, k, v, mask: Optional[torch.Tensor] = None, *,
                   mesh, axis: str = "sequence",
                   head_axis: Optional[str] = "tensor"):
    """Exact attention with Q/K/V sequence-sharded over `axis`.

    q, k, v: this rank's `[B, H, T/n, D]` blocks; mask: optional additive
    key mask `[B, T/n]` for this rank's keys (0 for keep, large-negative
    for drop — the BERT convention). Returns this rank's `[B, H, T/n, D]`
    block of the output. CPU tensors take the JAX body's plain path, CUDA
    tensors the flash kernels.
    """
    if head_axis and mesh.size(head_axis) > 1:
        raise NotImplementedError(
            f"ring_attention with heads over '{head_axis}' (size "
            f"{mesh.size(head_axis)}): tensor parallelism waits for "
            "ROADMAP item 7b")
    n = mesh.size(axis)
    m4 = None if mask is None else \
        mask[:, None, None, :].to(torch.float32).contiguous()
    if n == 1:
        return flash_attention(q, k, v, m4)
    if q.device.type == "cpu":
        kmask = None if mask is None else mask.to(torch.float32)
        return _ring_plain(q, k, v, kmask, mesh, axis)
    if q.device.type != "cuda":
        raise ValueError(f"ring_attention: unsupported device {q.device}")
    return _ring_flash(q.contiguous(), k.contiguous(), v.contiguous(), m4,
                       mesh, axis)
