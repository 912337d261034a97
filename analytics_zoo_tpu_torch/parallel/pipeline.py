"""Pipeline parallelism: GPipe-style microbatch schedule over the mesh's
"pipeline" axis.

Port of `analytics_zoo_tpu/parallel/pipeline.py` (L1-125):
`pipeline_apply` (L61), `to_microbatches` and `from_microbatches`
(L109-125), with the same schedule: T = n_micro + S - 1 ticks (fill +
drain). At tick t, stage 0 eats microbatch t (ticks >= n_micro recompute
the last microbatch; their outputs are discarded), stage p processes
what stage p-1 produced at t-1 (the activations hop through the mesh's
`permute`), and the last stage's outputs from ticks S-1..T-1 are the
results, broadcast with a masked sum over the axis. A single-stage axis
runs the stages in turn on every microbatch (the JAX fallback, L85-90).

A torch rank is one stage: it takes its slice of `stacked_params` (the
leaves' leading dim S, index its coordinate on the axis) and its own
block of the microbatches (the batch dim split over the data axes, as
the JAX `mb_spec` splits it). The schedule is differentiable: each rank
runs the same ops in the same order (a stage's choices are
`torch.where` on its coordinate, never a Python branch), so the hops'
backward (the reverse hop) pair up across ranks; the final sum's backward
passes the output gradient through unchanged, since the output is one
replicated value (every rank's loss is the same function of it). A
stage's parameter gradients land on its own rank, in its slice of the
stack.
"""

from __future__ import annotations

from typing import Callable

import torch

from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_map
from analytics_zoo_tpu_torch.parallel.ring_attention import permute


class _ReplicatedSum(torch.autograd.Function):
    """`lax.psum` of a masked value into a replicated one: the sum over
    `axis` forward, the output gradient as it is backward."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t.clone(), (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def pipeline_apply(stage_fn: Callable, stacked_params, microbatches,
                   mesh, axis: str = "pipeline", seq_axis: str = None):
    """Run `stage_fn(params_s, x) -> y` (same x/y shape) for stages
    s = 0..S-1 as a pipeline.

    stacked_params: tree whose leaves have leading dim S (one slice per
    stage). microbatches: this rank's `[n_micro, mb, ...]`. Returns
    `[n_micro, mb, ...]` outputs (identical on every pipeline rank).
    `seq_axis` is the JAX signature's; a torch rank's microbatches are
    already its own block of a sequence-sharded input."""
    S = mesh.size(axis)
    n_stacked = {leaf.shape[0] for leaf in tree_leaves(stacked_params)}
    if n_stacked != {S} and S != 1:
        raise ValueError(
            f"stacked_params leading dims {sorted(n_stacked)} must all equal "
            f"the pipeline axis size ({S})")
    if S == 1:
        n_stage = next(iter(n_stacked))

        def apply_all(x):
            for s in range(n_stage):
                x = stage_fn(tree_map(lambda p: p[s], stacked_params), x)
            return x
        return torch.stack([apply_all(mb) for mb in microbatches])

    idx = mesh.coordinate(axis)
    params = tree_map(lambda p: p[idx], stacked_params)
    M = microbatches.shape[0]
    T = M + S - 1
    dev = microbatches.device
    first = torch.tensor(idx == 0, device=dev)
    last = torch.tensor(idx == S - 1, device=dev)
    act = torch.zeros_like(microbatches[0])
    ys = []
    for t in range(T):
        recv = permute(act, mesh, axis)
        inp = torch.where(first, microbatches[min(t, M - 1)], recv)
        act = stage_fn(params, inp)
        ys.append(act)
    valid = torch.stack(ys[S - 1:])                 # [M, mb, ...]
    out = torch.where(last, valid, torch.zeros_like(valid))
    return _ReplicatedSum.apply(out, mesh, axis)


def to_microbatches(x, n_micro: int):
    """[B, ...] -> [n_micro, B/n_micro, ...] by INTERLEAVING (microbatch i
    takes rows i::n_micro), as the JAX package splits, so a rank's block
    of the batch gives its block of every microbatch."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro {n_micro}")
    return x.reshape((B // n_micro, n_micro) + tuple(x.shape[1:])) \
        .transpose(0, 1)


def from_microbatches(y):
    """Inverse of `to_microbatches` (restores original row order)."""
    n_micro, mb = y.shape[0], y.shape[1]
    return y.transpose(0, 1).reshape((n_micro * mb,) + tuple(y.shape[2:]))
