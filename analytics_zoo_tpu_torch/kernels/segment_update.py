"""Row-sparse embedding updates: segment sum + row-wise Adam on the touched
rows, and the fused one-step that trains the declared tables with them.

Port of `analytics_zoo_tpu/pallas/segment_update.py`: `segment_compact`
(L50), the kernel `_row_kernel` (L77), which becomes `csrc/segment_adam.cu`,
`segment_adam_cost` (L95), `segment_adam_update` (L105), `kernel_apply`
(L120), `make_fused_one_step` (L164) and `_dedup_rows` (L277).

- **Segment sum.** The batch's ids are sorted (stable) and merged by
  neighbour compare and `cumsum`, all static shapes: slot j holds the j-th
  distinct id and the sum of its entries' gradient rows; `valid` marks the
  distinct slots, and the tail's ids point at the last distinct one, as in
  the JAX package. The sum adds each run of equal ids left to right in
  sorted order: `index_add_` on the CPU, the `segment_sum` kernel on the
  card (no atomics, so two calls give the same bits).
- **Row Adam** (`kernel_apply`): each valid slot's row of (table, mu, nu)
  takes the Adam update with the bias correction folded into `(a, b)`
  (`kernels/fused_adam._fold_scalars`, weight decay 0), in place; nothing
  else is read or written. The kernel reads `(a, b, lr·wd)` from device
  memory, as the fused-Adam kernel does: a training step passes its row of
  the scalar table, so a captured CUDA graph reads each replay's values. The
  kernel repeats `_adam_math`'s arithmetic operation for operation, so it
  agrees with the plain version bit for bit. Semantics are torch
  `SparseAdam`'s: moments decay only on touched rows, bias correction by the
  global step.
- **The fused one-step** gathers each table's batch rows outside the
  differentiated function, rewrites the id column to `arange(B)`
  (`LazyEmbeddingSpec.set_ids_fn`) and runs the model with the rows in
  place of the table, so the backward gives a [B, dim] gradient per table
  and no vocabulary-sized gradient exists. The rest of the parameters take
  the compiled optimizer (the fused-Adam kernel when the fit engaged it).

Routing is static: CPU tensors take the plain versions, CUDA tensors launch
the kernels or raise. Nothing on the step path reads a device value on the
host (no `.item()`, `unique`, `nonzero` or boolean-mask indexing), so a
step never waits for the card.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Tuple

import torch
from torch.func import functional_call

from analytics_zoo_tpu_torch.common.tree import tree_map
from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build, kernel_region
from analytics_zoo_tpu_torch.kernels.fused_adam import (_adam_math,
                                                        _fold_scalars,
                                                        folded_on)

KERNEL_NAME = "segment_adam"
SUM_NAME = "segment_sum"
SOURCE = "segment_adam.cu"

_P_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# segment sum
# ---------------------------------------------------------------------------
def sort_ids(ids: torch.Tensor):
    """(sids, order, first, seg): the ids sorted (stable), the batch
    position of each sorted entry, whether an entry starts a run of equal
    ids, and the slot of each entry (int32 each, `first` bool)."""
    ids = ids.reshape(-1).to(torch.int32)
    sids, order = torch.sort(ids, stable=True)
    first = torch.ones_like(sids, dtype=torch.bool)
    first[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
    return sids, order.to(torch.int32), first, seg


def _reference_segment_sum(d_rows, order, seg) -> torch.Tensor:
    """The plain version: `index_add_` of the rows in sorted order, which
    the CPU adds one entry after another."""
    return torch.zeros_like(d_rows).index_add_(
        0, seg.long(), d_rows.index_select(0, order.long()))


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


def _launch_segment_sum(d_rows, sids, order, seg) -> torch.Tensor:
    if d_rows.dtype != torch.float32:
        raise TypeError(f"segment_sum kernel takes float32 gradient rows, "
                        f"got {d_rows.dtype}")
    if d_rows.dim() != 2 or not d_rows.is_contiguous():
        raise ValueError("segment_sum kernel needs contiguous [n, dim] rows")
    n, dim = d_rows.shape
    for name, t in (("sids", sids), ("order", order), ("seg", seg)):
        if (t.dtype != torch.int32 or t.shape != (n,) or t.device !=
                d_rows.device or not t.is_contiguous()):
            raise ValueError(f"segment_sum: {name} must be contiguous int32 "
                             f"[{n}] on {d_rows.device}")
    g_slots = torch.zeros_like(d_rows)
    if n == 0 or dim == 0:
        return g_slots
    vec = dim % 4 == 0 and _aligned(d_rows, 16) and _aligned(g_slots, 16)
    fn = _build.bind(SOURCE, "azt_segment_sum", [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(d_rows.device):
        stream = torch.cuda.current_stream(d_rows.device).cuda_stream
        rc = fn(d_rows.data_ptr(), sids.data_ptr(), order.data_ptr(),
                seg.data_ptr(), g_slots.data_ptr(), n, dim, int(vec), stream)
    _build.check_launch(SOURCE, rc, SUM_NAME)
    LAUNCHES.add(SUM_NAME)
    return g_slots


def segment_sum_cost(d_rows):
    """(flops, bytes) of the segment sum: one add an element, the rows
    read once and as many slots written (XLA's scatter-add in the JAX
    package, counted there by cost analysis)."""
    n = d_rows.numel()
    return float(n), float(2 * n * d_rows.element_size())


def segment_sum(d_rows, sids, order, seg) -> torch.Tensor:
    """g_slots [n, dim]: slot `seg[k]` holds the sum of the rows of its run
    of equal ids, added in sorted order; slots past the last are zero."""
    with kernel_region(segment_sum_cost, d_rows):
        if d_rows.device.type == "cpu":
            return _reference_segment_sum(d_rows, order, seg)
        if d_rows.device.type != "cuda":
            raise ValueError(
                f"segment_sum: unsupported device {d_rows.device}")
        return _launch_segment_sum(d_rows, sids, order, seg)


def segment_compact(ids: torch.Tensor, d_rows: torch.Tensor):
    """Sort-dedup-sum the batch's per-example row gradients into compacted
    slots. Returns (uids, valid, g_slots):

    - uids[j] — the j-th distinct id for j < n_valid; every later slot
      points at the last valid slot's id;
    - valid[j] — 1 for the distinct slots, 0 for the tail (int32);
    - g_slots[j] — the summed gradient of uids[j] (0 on the tail).

    Static shapes throughout (B slots for a B-row batch), no host sync."""
    B = ids.shape[0]
    sids, order, first, seg = sort_ids(ids)
    g_slots = segment_sum(d_rows, sids, order, seg)
    n_valid = first.sum()
    uids = torch.zeros(B, dtype=torch.int32, device=ids.device).scatter_(
        0, seg.long(), sids)
    valid = torch.arange(B, device=ids.device) < n_valid
    last = uids.gather(0, (n_valid - 1).clamp(min=0).view(1))
    uids = torch.where(valid, uids, last)
    return uids, valid.to(torch.int32), g_slots


# ---------------------------------------------------------------------------
# row Adam
# ---------------------------------------------------------------------------
def segment_adam_cost(n_slots: int, dim: int,
                      p_dtype: torch.dtype = torch.float32
                      ) -> Tuple[float, float]:
    """(flops, bytes): 7 row passes over the touched rows only — read the
    slot's gradient and p, m, v, write p, m, v — ~12 flops an element."""
    n = n_slots * dim
    pbytes = torch.finfo(p_dtype).bits // 8
    return 12.0 * n, float(n * (4 + 2 * pbytes + 4 * 4))


@torch.no_grad()
def _reference_kernel_apply(table, mu, nu, uids, valid, g_slots, scal,
                            b1: float, b2: float) -> None:
    """The plain version, in place: the valid slots' rows through
    `_adam_math`, written back with `index_copy_`. Each invalid slot takes
    the last valid slot's row and new values, so every row written twice is
    written the same bytes; no value is read on the host."""
    a, b, lrwd = scal
    B = uids.shape[0]
    ok = valid.to(torch.bool)
    pos = torch.arange(B, device=uids.device)
    src = torch.where(ok, pos, torch.where(ok, pos, 0).amax())
    rows = uids.long().index_select(0, src)
    p = table.index_select(0, rows).float()
    m = mu.index_select(0, rows)
    v = nu.index_select(0, rows)
    p_new, m_new, v_new = _adam_math(p, m, v, g_slots.index_select(0, src),
                                     a, b, lrwd, b1, b2)
    any_valid = ok.any()   # no valid slot: write the rows back unchanged
    table.index_copy_(0, rows, torch.where(any_valid, p_new, p).to(
        table.dtype))
    mu.index_copy_(0, rows, torch.where(any_valid, m_new, m))
    nu.index_copy_(0, rows, torch.where(any_valid, v_new, v))


def _check_kernel_inputs(table, mu, nu, uids, valid, g_slots) -> None:
    if table.dtype not in _P_DTYPE_CODES or table.dim() != 2:
        raise TypeError(f"segment_adam kernel takes a [rows, dim] float32 or "
                        f"bfloat16 table, got {table.dtype} "
                        f"{tuple(table.shape)}")
    B, dim = uids.shape[0], table.shape[1]
    want = {"mu": (mu, torch.float32, table.shape),
            "nu": (nu, torch.float32, table.shape),
            "uids": (uids, torch.int32, (B,)),
            "valid": (valid, torch.int32, (B,)),
            "g_slots": (g_slots, torch.float32, (B, dim))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise TypeError(f"segment_adam: {name} must be {dtype} "
                            f"{tuple(shape)}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    for name, t in (("table", table), ("mu", mu), ("nu", nu),
                    ("uids", uids), ("valid", valid), ("g_slots", g_slots)):
        if t.device != table.device:
            raise ValueError(f"segment_adam: {name} on {t.device}, table on "
                             f"{table.device}")
        if not t.is_contiguous():
            raise ValueError(f"segment_adam kernel needs {name} contiguous")


def _launch(table, mu, nu, uids, valid, g_slots, scal, b1, b2) -> None:
    _check_kernel_inputs(table, mu, nu, uids, valid, g_slots)
    B, dim = g_slots.shape
    if B == 0 or dim == 0 or table.shape[0] == 0:
        return
    folded = folded_on(scal, table.device)
    vec = (dim % 4 == 0 and _aligned(table, 16 if table.dtype ==
                                     torch.float32 else 8)
           and all(_aligned(t, 16) for t in (mu, nu, g_slots)))
    fn = _build.bind(SOURCE, "azt_segment_adam", [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p])
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(table.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                uids.data_ptr(), valid.data_ptr(), g_slots.data_ptr(), B, dim,
                table.shape[0], folded.data_ptr(), b1, b2, 1.0 - b1, 1.0 - b2,
                _P_DTYPE_CODES[table.dtype], int(vec), stream)
    _build.check_launch(SOURCE, rc, KERNEL_NAME)
    LAUNCHES.add(KERNEL_NAME)


def kernel_apply(table, mu, nu, uids, valid, g_slots, scal, *,
                 b1: float = 0.9, b2: float = 0.999):
    """Row Adam over pre-compacted slots, in place; returns (table, mu,
    nu), the same tensors. `scal` is `(a, b, lr·wd)` (`_fold_scalars`):
    host floats, or an f32 tensor of three on the table's device (a row of
    the scalar table). CPU tensors take the plain version, CUDA tensors the
    kernel. Its declared cost is `segment_adam_cost` over the slots (JAX
    L155)."""
    with kernel_region(segment_adam_cost, uids.shape[0], table.shape[1],
                       table.dtype):
        if table.device.type == "cpu":
            _reference_kernel_apply(table, mu, nu, uids, valid, g_slots,
                                    scal, b1, b2)
        elif table.device.type == "cuda":
            _launch(table, mu, nu, uids, valid, g_slots, scal, float(b1),
                    float(b2))
        else:
            raise ValueError(
                f"segment_adam: unsupported device {table.device}")
    return table, mu, nu


@torch.no_grad()
def segment_adam_update(table, mu, nu, ids, d_rows, count: int, *,
                        lr: float, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8, folded=None):
    """Row-sparse Adam over the rows `ids` touches, the gradient given as
    per-example [B, dim] rows (duplicates summed here), in place. `count`
    is the global step after the increment (SparseAdam bias correction), a
    host integer. `folded`, when given, is the step's `(a, b, 0)` already
    on the device (a row of the scalar table), and `count` and `lr` are
    then not read."""
    uids, valid, g_slots = segment_compact(ids, d_rows)
    scal = folded if folded is not None else _fold_scalars(
        count, lr, b1, b2, eps, 0.0)
    return kernel_apply(table, mu, nu, uids, valid, g_slots, scal, b1=b1,
                        b2=b2)


# ---------------------------------------------------------------------------
# fused one-step: rows-reindexed backward + fused dense rest
# ---------------------------------------------------------------------------
def make_fused_one_step(model, loss_fn, optimizer, specs,
                        mixed_precision: bool = False):
    """The fused twin of `learn.lazy_embedding.make_lazy_one_step`: the same
    `(params, opt_state, xb, yb, seed, scalars)` signature and opt_state
    layout (`lazy_embedding.init_state`), with the declared tables on the
    segment kernels and every other parameter on `optimizer` (`fused_apply`
    when it has one, else `update`). Its row of per-step scalars
    (`one_step.scalars(opt_state)`): each table's folded `(a, b, 0)`, in
    spec order, then the rest optimizer's.

    Tables whose spec has `set_ids_fn` take the rows-reindexed backward; a
    spec without it takes the dense gradient, its touched rows picked out
    once per distinct id (`_dedup_rows`) — still the in-place row update,
    without the gradient saving. It holds `model` weakly
    (`trainer.build_train_step` says why)."""
    from analytics_zoo_tpu_torch.learn.lazy_embedding import (_get, _key,
                                                              _name,
                                                              rest_update,
                                                              split_rest)
    from analytics_zoo_tpu_torch.learn.trainer import _cast_tree
    from analytics_zoo_tpu_torch.ops.optimizers import (scalar_row,
                                                        step_scalars,
                                                        takes_scalars)

    model = weakref.ref(model)
    reindexed = [s for s in specs if s.set_ids_fn is not None]
    dense = [s for s in specs if s.set_ids_fn is None]
    fused_rest = getattr(optimizer, "fused_apply", None)
    at = {_key(s): 3 * i for i, s in enumerate(specs)}
    rest_at = 3 * len(specs)

    def row_fn(opt_state):
        t = opt_state["t"] + 1
        row = [v for s in specs
               for v in _fold_scalars(t, s.lr, s.b1, s.b2, s.eps, 0.0)]
        return row + step_scalars(optimizer, opt_state["rest"])

    def one_step(params, opt_state, xb, yb, seed, scalars=None):
        if scalars is None:
            scalars = scalar_row(row_fn(opt_state),
                                 next(iter(params.values())).device)
        ids_by_key = {_key(s): s.ids_fn(xb).long() for s in specs}
        # gather the touched rows outside the differentiated function and
        # point the model at them through rewritten position ids
        rows_in = {_key(s): _get(params, s.path).detach().index_select(
            0, ids_by_key[_key(s)]).requires_grad_() for s in reindexed}
        xb_sub = xb
        for s in reindexed:
            ids = ids_by_key[_key(s)]
            xb_sub = s.set_ids_fn(xb_sub, torch.arange(
                ids.shape[0], dtype=torch.int32, device=ids.device))
        # differentiate with respect to the rest and the rows only: the
        # reindexed tables are not inputs of the graph, so no
        # vocabulary-sized gradient is formed
        head = split_rest(params, reindexed)
        with torch.enable_grad():
            p = dict(head)
            for s in reindexed:
                p[_name(s)] = rows_in[_key(s)]
            if mixed_precision:
                # inputs stay uncast: ids above 256 are not exact in bf16
                p = _cast_tree(p, torch.bfloat16)
            pred = functional_call(model(), p, (xb_sub,),
                                   {"training": True, "seed": seed})
            if mixed_precision:
                pred = tree_map(lambda a: a.float(), pred)
            loss = loss_fn(yb, pred)
            leaves = list(head.values()) + [rows_in[_key(s)]
                                            for s in reindexed]
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(t) if g is None else g
                 for (n, t), g in zip(head.items(), got)}
        row_grads = {_key(s): g for s, g in zip(reindexed, got[len(head):])}

        t = opt_state["t"] + 1
        tables = dict(opt_state["tables"])
        with torch.no_grad():
            for s in reindexed:
                k = _key(s)
                segment_adam_update(_get(params, s.path), *tables[k],
                                    ids_by_key[k], row_grads[k], t, lr=s.lr,
                                    b1=s.b1, b2=s.b2, eps=s.eps,
                                    folded=scalars[at[k]:at[k] + 3])
            for s in dense:
                k = _key(s)
                ids = ids_by_key[k]
                segment_adam_update(_get(params, s.path), *tables[k], ids,
                                    _dedup_rows(_get(grads, s.path), ids), t,
                                    lr=s.lr, b1=s.b1, b2=s.b2, eps=s.eps,
                                    folded=scalars[at[k]:at[k] + 3])
            rest_grads = split_rest(grads, specs)
            rest_params = split_rest(params, specs)
            rest_row = scalars[rest_at:]
            if fused_rest is not None:
                _, rest_state = fused_rest(rest_grads, opt_state["rest"],
                                           rest_params, scalars=rest_row) \
                    if takes_scalars(optimizer) else fused_rest(
                        rest_grads, opt_state["rest"], rest_params)
            else:
                updates, rest_state = rest_update(
                    optimizer, rest_grads, opt_state["rest"], rest_params,
                    rest_row)
                for name, value in rest_params.items():
                    value.add_(updates[name])
        return params, {"rest": rest_state, "tables": tables, "t": t}, \
            loss.detach()

    one_step.scalars = row_fn
    return one_step


def _dedup_rows(g_table, ids) -> torch.Tensor:
    """Per-example rows of an already-accumulated dense table gradient, in
    the batch's order: the first entry of each distinct id carries its
    gradient row, every later duplicate zeros, so `segment_compact`'s sum
    gives each row its dense gradient once."""
    _, order, first, _ = sort_ids(ids)
    dup = torch.zeros_like(first).scatter_(0, order.long(), ~first)
    rows = g_table.index_select(0, ids.reshape(-1).long())
    return torch.where(dup[:, None], torch.zeros_like(rows), rows)
