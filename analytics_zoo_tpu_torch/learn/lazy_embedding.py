"""Lazy (row-sparse) embedding updates: only the rows a batch touches take an
optimizer step, the rest are untouched bytes.

Port of `analytics_zoo_tpu/learn/lazy_embedding.py`: `LazyEmbeddingSpec`
(L41), `_get` / `_set` / `_key` (L66-79), `split_rest` (L82), `init_state`
(L91), `_dedup` (L102), `row_adam_update` (L110), `make_lazy_one_step`
(L128) and `resolve_specs` (L188).

This is the unfused path: the forward and backward are the ordinary dense
ones (each table gets a vocabulary-sized gradient), then each table's
touched rows take a SparseAdam step in torch ops and the other parameters
the compiled optimizer. `kernels/segment_update.make_fused_one_step` is the
kernel path of the same step; this one is the plain path it is held
against.

Differences from the JAX package, none of them in the numbers:

- parameters are the model's state dict, a flat dict keyed
  `"layer.leaf"`; a spec's `path` names one key (`_name` joins it with
  "."), and `split_rest` drops the table keys where the JAX package sets
  its leaves to None;
- `opt_state["t"]` is a host integer (the JAX package keeps a jnp int32),
  so the bias correction is computed on the host without a device sync
  (`table_scalars`) and read by the step from its row of the trainer's
  scalar table on the device;
- updates are in place: `index_copy_` writes the new rows into the table
  and its moments. A duplicate id gathers the same row and gradient as its
  first occurrence, so it computes and writes the same bytes; the JAX
  package instead sends duplicates to an out-of-bounds row that its
  scatter drops, which torch has no form of.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from analytics_zoo_tpu_torch.common.tree import tree_map
from analytics_zoo_tpu_torch.ops.optimizers import (scalar_row, step_scalars,
                                                    takes_scalars)


class LazyEmbeddingSpec(NamedTuple):
    """One table: its path in the parameters and how to read its batch ids
    from the model input. `lr=None` means "the model was compiled with the
    stock 'adam' string": `resolve_specs` checks that and fills Adam's
    defaults; with any other compiled optimizer, set the row-Adam
    hyperparameters here (the row updates are SparseAdam, whatever the rest
    of the model takes).

    `set_ids_fn(xb, new_ids) -> xb` is the write twin of `ids_fn`: it
    returns a copy of the batch input whose id column reads `new_ids`.
    Declaring it lets the fused path gather the touched rows outside the
    differentiated function, so no vocabulary-sized gradient is formed."""
    path: Tuple[str, ...]                 # e.g. ("embedding_1", "embeddings")
    ids_fn: Callable                      # xb -> [B] int ids
    lr: float = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    set_ids_fn: Callable = None           # (xb, [B] ids) -> xb


def _name(spec: LazyEmbeddingSpec) -> str:
    """The table's state-dict key."""
    return ".".join(spec.path)


def _get(params: Dict[str, torch.Tensor], path) -> torch.Tensor:
    return params[".".join(path)]


def _set(params: Dict[str, torch.Tensor], path, value
         ) -> Dict[str, torch.Tensor]:
    return {**params, ".".join(path): value}


def _key(spec: LazyEmbeddingSpec) -> str:
    """The table's key in `opt_state["tables"]`, the JAX package's."""
    return "/".join(spec.path)


def split_rest(params: Dict[str, torch.Tensor],
               specs: Sequence[LazyEmbeddingSpec]) -> Dict[str, torch.Tensor]:
    """The parameters without the tables: what the rest optimizer steps."""
    names = {_name(s) for s in specs}
    return {k: v for k, v in params.items() if k not in names}


def init_state(params: Dict[str, torch.Tensor],
               specs: Sequence[LazyEmbeddingSpec], optimizer) -> Dict:
    """`{"rest": the rest optimizer's state, "tables": {key: (mu, nu)},
    "t": 0}`; table moments are float32, on the table's device."""
    tables = {}
    for s in specs:
        table = _get(params, s.path)
        tables[_key(s)] = tuple(torch.zeros(table.shape, dtype=torch.float32,
                                            device=table.device)
                                for _ in range(2))
    return {"rest": optimizer.init(split_rest(params, specs)),
            "tables": tables, "t": 0}


def _dedup(ids: torch.Tensor) -> torch.Tensor:
    """The batch's ids sorted. Duplicates stay: each gathers the same row
    and gradient as its first occurrence and writes back the same bytes."""
    return torch.sort(ids.reshape(-1).long()).values


def _corrections(spec: LazyEmbeddingSpec, t: int) -> Tuple[float, float]:
    """(1 − β1ᵗ, 1 − β2ᵗ) in f32: the bias corrections at step `t`."""
    f32 = np.float32
    return (float(f32(1.0) - f32(spec.b1) ** f32(t)),
            float(f32(1.0) - f32(spec.b2) ** f32(t)))


@torch.no_grad()
def row_adam_update(spec: LazyEmbeddingSpec, table, mu, nu, g_table, ids,
                    t: int, corrections=None):
    """SparseAdam step over the rows `ids` touches, in place, in the JAX
    package's arithmetic (bias-corrected moments, then the step); every
    other row is untouched bytes. Returns (table, mu, nu).
    `corrections`: the step's (1 − β1ᵗ, 1 − β2ᵗ) as an f32 tensor of two on
    the table's device (a row of the scalar table); computed from `t` when
    not given."""
    c1, c2 = corrections if corrections is not None else scalar_row(
        _corrections(spec, t), table.device)
    rows = _dedup(ids)
    g = g_table.index_select(0, rows).float()
    m = spec.b1 * mu.index_select(0, rows) + (1.0 - spec.b1) * g
    v = spec.b2 * nu.index_select(0, rows) + (1.0 - spec.b2) * g * g
    mhat = m / c1
    vhat = v / c2
    p = (table.index_select(0, rows).float()
         - spec.lr * mhat / (torch.sqrt(vhat) + spec.eps))
    table.index_copy_(0, rows, p.to(table.dtype))
    mu.index_copy_(0, rows, m.to(mu.dtype))
    nu.index_copy_(0, rows, v.to(nu.dtype))
    return table, mu, nu


def make_lazy_one_step(model, loss_fn, optimizer,
                       specs: Sequence[LazyEmbeddingSpec],
                       mixed_precision: bool = False) -> Callable:
    """The trainer's one-step when lazy tables are declared and the fit is
    not fused: `one_step(params, opt_state, xb, yb, seed, scalars) ->
    (params, opt_state, loss)` with opt_state from `init_state`, params
    updated in place; `one_step.scalars(opt_state)` is its row of per-step
    scalars (each table's bias corrections, then the rest optimizer's),
    which `scalars` holds on the device. It holds `model` weakly
    (`trainer.build_train_step` says why)."""
    from analytics_zoo_tpu_torch.learn.trainer import _cast_tree

    model = weakref.ref(model)

    def row_fn(opt_state) -> List[float]:
        t = opt_state["t"] + 1
        row = [c for s in specs for c in _corrections(s, t)]
        return row + step_scalars(optimizer, opt_state["rest"])

    def one_step(params, opt_state, xb, yb, seed, scalars=None):
        if scalars is None:
            scalars = scalar_row(row_fn(opt_state),
                                 next(iter(params.values())).device)
        with torch.enable_grad():
            # inputs stay uncast: ids above 256 are not exact in bf16
            p = _cast_tree(params, torch.bfloat16) if mixed_precision \
                else params
            pred = functional_call(model(), p, (xb,),
                                   {"training": True, "seed": seed})
            if mixed_precision:
                pred = tree_map(lambda a: a.float(), pred)
            loss = loss_fn(yb, pred)
            got = torch.autograd.grad(loss, list(params.values()),
                                      allow_unused=True)
        grads = {n: torch.zeros_like(t) if g is None else g
                 for (n, t), g in zip(params.items(), got)}

        t = opt_state["t"] + 1
        tables = dict(opt_state["tables"])
        for i, s in enumerate(specs):
            row_adam_update(s, _get(params, s.path), *tables[_key(s)],
                            _get(grads, s.path), s.ids_fn(xb), t,
                            scalars[2 * i:2 * i + 2])
        with torch.no_grad():
            rest_params = split_rest(params, specs)
            updates, rest_state = rest_update(
                optimizer, split_rest(grads, specs), opt_state["rest"],
                rest_params, scalars[2 * len(specs):])
            for name, value in rest_params.items():
                value.add_(updates[name])
        return params, {"rest": rest_state, "tables": tables, "t": t}, \
            loss.detach()

    one_step.scalars = row_fn
    return one_step


def rest_update(optimizer, grads, state, params, scalars):
    """`optimizer.update` with its part of the step's row, when it
    declares per-step scalars (a transformation without them is called
    as optax calls it)."""
    if not takes_scalars(optimizer):
        return optimizer.update(grads, state, params)
    return optimizer.update(grads, state, params, scalars=scalars)


def resolve_specs(model) -> Sequence[LazyEmbeddingSpec]:
    """Read `lazy_embedding_specs` off a model (attribute or zero-argument
    method); raises when absent, so `lazy_embeddings=True` never falls back
    to the dense sweep unnoticed. Specs with `lr=None` need the model
    compiled with the stock "adam" string, whose defaults they take."""
    specs = getattr(model, "lazy_embedding_specs", None)
    if callable(specs):
        specs = specs()
    if not specs:
        raise ValueError(
            "lazy_embeddings=True but the model declares no "
            "lazy_embedding_specs (path + ids_fn per table)")
    out = []
    okey = getattr(model, "_optimizer_spec", None)
    for s in specs:
        if s.lr is None:
            if str(okey).lower() != "adam":
                raise ValueError(
                    "lazy_embeddings: spec for " + "/".join(s.path) +
                    " inherits adam defaults but the model was compiled "
                    f"with {okey!r}; set lr/b1/b2/eps on the "
                    "LazyEmbeddingSpec to match the compiled optimizer")
            s = s._replace(lr=1e-3)
        out.append(s)
    return out
