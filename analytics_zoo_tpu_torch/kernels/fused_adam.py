"""Fused Adam — the optimizer sweep as one CUDA launch over every leaf, in
place.

Port of `analytics_zoo_tpu/pallas/fused_adam.py`: `_fold_scalars` (L70),
`_adam_math` (L83), the kernel `_fused_kernel` (L93), which becomes
`csrc/fused_adam.cu`, `leaf_cost` / `update_cost` (L104 / L114) and
`fused_adam_step` (L170).

Numerics as there: the bias correction is folded into three f32 scalars on
the host, `(a, b, lr·wd)` with `a = lr·√c2/c1`, `b = eps·√c2`,
`c_i = 1 - βᵢᵗ` (`_fold_scalars`). They change every step, so the kernel
reads them from device memory: a training step passes its row of the
scalar table (an f32 tensor of three on the card), which the host writes
before the step, and a captured CUDA graph reads each replay's values; a
direct call with host floats copies them there first. The per-element
math is
`p ← p − a·m/(√v + b) − lr·wd·p` on the uncorrected new moments; moments
are f32, params f32 or bf16. The update is in place: the params and
moments tensors are written, never reallocated (the JAX kernel aliases
them to its outputs). A leaf is walked as one flat array, so a
channels_last conv kernel runs as it lies, its moments and gradient in
the same layout.

The JAX package launches its kernel once a leaf inside one compiled
program. Here a sweep is one launch (a multi-tensor apply): the wrapper
builds a table of the leaves with numpy (each leaf's p, m, v and g
addresses, its element count, its (p, g) dtypes and whether all four are
16-byte aligned) and the kernel walks every leaf's chunks of `CHUNK`
elements; a sweep over more than `MAX_LEAVES` leaves takes
⌈leaves / MAX_LEAVES⌉ launches. A leaf with no elements is skipped; a 0-d
leaf is a leaf of one element. The (p, m, v) leaves of a sweep are checked
once and remembered by identity (a weak reference to each, so a freed
tensor is never mistaken for a new one) and by address, shape, strides,
dtype and device, any change of which checks them again; the gradients
are checked on every call, and a gradient in another memory format than
its leaf is copied into the leaf's layout first (counted in
`GRAD_COPIES`).

Routing is static: CPU tensors take the plain version (`_adam_math` per
leaf, one rounding per operation, which the kernel repeats operation for
operation), CUDA tensors launch the kernel or raise; leaves on several
devices raise. The JAX package's availability probe (`fused_available`,
which catches every error and degrades to optax) is not carried over: a
failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import operator
import threading
import weakref
from collections import OrderedDict
from typing import (Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from analytics_zoo_tpu_torch.kernels import (LAUNCHES, LaunchCounter, _build,
                                            kernel_region)

KERNEL_NAME = "fused_adam"
SOURCE = "fused_adam.cu"

CHUNK = 2048        # elements a chunk (a block): kChunk of the source
MAX_LEAVES = 704    # leaves a launch: kMaxLeaves, what fits the 32,764-byte
                    # kernel parameter space at 45 bytes a leaf
ALIGN = 16          # bytes: the kernel's 16-byte accesses need it

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bits of a leaf's kind byte in the table (as the source reads them)
P_BF16, G_BF16, ALIGNED = 1, 2, 4

GRAD_COPIES = LaunchCounter()
"""Gradients copied into their leaf's memory format before a launch
(autograd picks a gradient's format), under `KERNEL_NAME`."""


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


def leaf_cost(shape, dtype: torch.dtype,
              grad_dtype: torch.dtype = torch.float32
              ) -> Tuple[float, float]:
    """(flops, bytes) of one fused update of one leaf: read g (grad dtype),
    read and write p (param dtype), m and v (f32) — the 7-pass floor.
    ~12 elementwise flops per element. The JAX package's count, whose
    gradients are f32, is the default."""
    n = 1
    for s in shape:
        n *= int(s)
    pbytes = torch.finfo(dtype).bits // 8
    gbytes = torch.finfo(grad_dtype).bits // 8
    return 12.0 * n, float(n * (gbytes + 2 * pbytes + 4 * 4))


def update_cost(params: Mapping[str, torch.Tensor],
                grads: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tuple[float, float]:
    """(flops, bytes) of one fused sweep over every leaf; the gradients
    counted in their own dtype where `grads` is given, else as f32."""
    flops = bytes_ = 0.0
    for k, p in params.items():
        gdt = torch.float32 if grads is None else grads[k].dtype
        f, b = leaf_cost(tuple(p.shape), p.dtype, gdt)
        flops += f
        bytes_ += b
    return flops, bytes_


def sweep_launches(leaves) -> int:
    """Kernel launches of one sweep over `leaves` (tensors): one for every
    `MAX_LEAVES` leaves that hold elements."""
    n = sum(1 for t in leaves if t.numel() > 0)
    return -(-n // MAX_LEAVES)


def _check_state(p, m, v) -> None:
    """A leaf and its moments as the kernel takes them."""
    if p.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_adam kernel takes float32 or bfloat16 params "
                        f"and grads, got {p.dtype}")
    for name, t in (("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_adam kernel keeps {name} in float32, got "
                            f"{t.dtype}")
    if not _dense(p):
        raise ValueError("fused_adam kernel needs p contiguous (or a "
                         "channels_last 4-d tensor)")
    for name, t in (("m", m), ("v", v)):
        _check_like(name, t, p)


def _check_grad(p, g) -> None:
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_adam kernel takes float32 or bfloat16 params "
                        f"and grads, got {p.dtype} / {g.dtype}")
    _check_like("g", g, p)


def _check_like(name, t, p) -> None:
    if t.shape != p.shape or t.device != p.device:
        raise ValueError(f"fused_adam: {name} {tuple(t.shape)} on "
                         f"{t.device} must match p {tuple(p.shape)} on "
                         f"{p.device}")
    if not _same_layout(t, p):
        raise ValueError(f"fused_adam kernel needs {name} contiguous in "
                         f"p's layout (strides {t.stride()} vs "
                         f"{p.stride()})")


def _check_kernel_inputs(p, m, v, g) -> None:
    _check_state(p, m, v)
    _check_grad(p, g)


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


def _one_device(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"fused_adam: the leaves of one sweep must lie on "
                         f"one device, got {sorted(map(str, devices))}")
    return devices.pop()


def _launch_plan(numel: np.ndarray, max_leaves: int = MAX_LEAVES,
                 chunk: int = CHUNK):
    """[(lo, hi, chunk_start)]: the table rows [lo, hi) of each launch of
    at most `max_leaves` leaves and the prefix sum (int32, from 0) of their
    counts of `chunk`-element chunks."""
    if not 1 <= max_leaves <= MAX_LEAVES:
        raise ValueError(f"fused_adam: max_leaves must be in [1, "
                         f"{MAX_LEAVES}], got {max_leaves}")
    chunks = -(-numel // chunk)
    plan = []
    for lo in range(0, len(numel), max_leaves):
        hi = min(lo + max_leaves, len(numel))
        start = np.zeros(hi - lo + 1, np.int32)
        start[1:] = np.cumsum(chunks[lo:hi])
        plan.append((lo, hi, start))
    return plan


class _State:
    """The checked (p, m, v) leaves of a sweep: what the table needs of
    them, computed once."""

    def __init__(self, ps, ms, vs):
        self.device = _one_device(list(ps) + list(ms) + list(vs))
        for p, m, v in zip(ps, ms, vs):
            _check_state(p, m, v)
        tensors = list(ps) + list(ms) + list(vs)
        self.refs = [weakref.ref(t) for t in tensors]
        self.meta = _meta(tensors)
        self.shapes = [p.shape for p in ps]
        self.strides = [p.stride() for p in ps]
        numel = np.array([p.numel() for p in ps], np.int64)
        self.rows = np.flatnonzero(numel > 0)     # the leaves in the table
        k = len(ps)
        addr = np.array([m[0] for m in self.meta],
                        np.int64).reshape(3, k).T
        self.ptrs = np.zeros((len(self.rows), 4), np.int64)
        self.ptrs[:, :3] = addr[self.rows]
        self.numel = numel[self.rows]
        pbf16 = np.array([p.dtype == torch.bfloat16 for p in ps])[self.rows]
        self.kind = np.where(pbf16, P_BF16, 0).astype(np.uint8)
        self.aligned = (self.ptrs[:, :3] % ALIGN == 0).all(axis=1)
        item = np.where(pbf16, 2, 4)
        _check_disjoint(np.concatenate([self.ptrs[:, 0], self.ptrs[:, 1],
                                        self.ptrs[:, 2]]),
                        np.concatenate([self.numel * item, self.numel * 4,
                                        self.numel * 4]))
        self.launches = _launch_plan(self.numel)

    def matches(self, tensors) -> bool:
        return (all(map(operator.is_, (r() for r in self.refs), tensors))
                and _meta(tensors) == self.meta)


def _meta(tensors) -> list:
    """What the table and the checks read of each tensor: a tensor may
    keep its identity and change any of these in place (`set_`,
    `.data =`)."""
    return [(t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)
            for t in tensors]


def _check_disjoint(starts: np.ndarray, nbytes: np.ndarray) -> None:
    """The arrays the kernel writes (every leaf's p, m and v) must not
    overlap: its blocks write them in no order."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], starts[order] + nbytes[order]
    if np.any(s[1:] < e[:-1]):
        raise ValueError("fused_adam: two leaves (or a leaf and a moment) "
                         "share memory; the kernel writes every leaf at "
                         "once")


_STATES: "OrderedDict[tuple, _State]" = OrderedDict()
_STATES_KEPT = 8
_states_lock = threading.Lock()


def _state_for(ps, ms, vs) -> _State:
    tensors = list(ps) + list(ms) + list(vs)
    key = tuple(map(id, tensors))
    with _states_lock:
        state = _STATES.get(key)
        if state is not None and state.matches(tensors):
            _STATES.move_to_end(key)
            return state
    state = _State(ps, ms, vs)
    with _states_lock:
        _STATES[key] = state
        while len(_STATES) > _STATES_KEPT:
            _STATES.popitem(last=False)
    return state


class Table(NamedTuple):
    """One sweep's leaf table, as the kernel reads it."""
    ptrs: np.ndarray       # int64 [k, 4]: p, m, v, g addresses
    numel: np.ndarray      # int64 [k]: elements a leaf (> 0)
    kind: np.ndarray       # uint8 [k]: P_BF16 | G_BF16 | ALIGNED bits
    launches: list         # [(lo, hi, chunk_start int32 [hi - lo + 1])]
    device: torch.device
    keep: list             # gradient copies, alive until launched


def _build_table(ps: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor], gs: Sequence[torch.Tensor]
                 ) -> Table:
    """Check a sweep's leaves and build its table. Raises on what the
    kernel does not take; copies a gradient in another memory format into
    its leaf's layout."""
    state = _state_for(ps, ms, vs)
    device = state.device
    gcode, gptr, keep = [], [], []
    codes = _DTYPE_CODES
    for i, (p, g) in enumerate(zip(ps, gs)):
        code = codes.get(g.dtype)
        if code is None or g.shape != state.shapes[i] or g.device != device:
            _check_grad(p, g)
            raise ValueError(f"fused_adam: gradient {i} does not fit its "
                             f"leaf")
        if g.stride() != state.strides[i] and not _same_layout(g, p):
            g = torch.empty_like(p, dtype=g.dtype).copy_(g)
            GRAD_COPIES.add(KERNEL_NAME)
            keep.append(g)
        gcode.append(code)
        gptr.append(g.data_ptr())
    rows = state.rows
    ptrs = state.ptrs.copy()
    ptrs[:, 3] = np.array(gptr, np.int64)[rows]
    gbf16 = np.array(gcode, np.uint8)[rows] == 1
    aligned = state.aligned & (ptrs[:, 3] % ALIGN == 0)
    kind = (state.kind | np.where(gbf16, G_BF16, 0)
            | np.where(aligned, ALIGNED, 0)).astype(np.uint8)
    return Table(ptrs, state.numel, kind, state.launches, device, keep)


_config_checked = False


def launch_config() -> Dict[str, int]:
    """The built kernel's geometry on the current device: elements a
    chunk, leaves a launch, threads a block, SMs, resident blocks an SM.
    Raises if the source and this module disagree on the first two."""
    global _config_checked
    fn = _build.bind(SOURCE, "azt_fused_adam_config",
                     [ctypes.POINTER(ctypes.c_longlong)])
    out = (ctypes.c_longlong * 5)()
    _build.check_launch(SOURCE, fn(out), "fused_adam config")
    cfg = dict(zip(("chunk", "max_leaves", "threads", "sms",
                    "blocks_per_sm"), list(out)))
    if (cfg["chunk"], cfg["max_leaves"]) != (CHUNK, MAX_LEAVES):
        raise RuntimeError(f"fused_adam: {SOURCE} was built with chunk "
                           f"{cfg['chunk']} and {cfg['max_leaves']} leaves a "
                           f"launch, the wrapper expects {CHUNK} and "
                           f"{MAX_LEAVES}")
    _config_checked = True
    return cfg


MULTI_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                  + [ctypes.c_float] * 4 + [ctypes.c_void_p])
"""`azt_fused_adam_multi`'s C signature: the table's rows of one launch
(`launch_args`), the address of the folded scalars on the card, b1, b2,
1 - b1, 1 - b2, the stream."""


def folded_on(scalars, device) -> torch.Tensor:
    """The folded `(a, b, lr·wd)` as a contiguous f32 tensor of three on
    `device`: a tensor there already (a row of the scalar table) as it
    is, host floats copied there."""
    if isinstance(scalars, torch.Tensor):
        if (scalars.dtype != torch.float32 or scalars.numel() != 3
                or scalars.device != torch.device(device)
                or not scalars.is_contiguous()):
            raise ValueError(f"folded scalars must be a contiguous f32 "
                             f"tensor of 3 on {device}, got {scalars.dtype} "
                             f"{tuple(scalars.shape)} on {scalars.device}")
        return scalars
    return torch.tensor([float(v) for v in scalars], dtype=torch.float32,
                        device=device)


def launch_args(table: Table):
    """For each launch of `table`: the addresses of its rows of the
    pointer, count, prefix-sum and kind arrays, and its count of leaves —
    the first five arguments of `azt_fused_adam_multi`."""
    ptrs, numel, kind = table.ptrs, table.numel, table.kind
    for lo, hi, start in table.launches:
        yield (ptrs.ctypes.data + lo * ptrs.strides[0],
               numel.ctypes.data + lo * numel.strides[0],
               start.ctypes.data, kind.ctypes.data + lo * kind.strides[0],
               hi - lo)


def _launch(table: Table, scalars, b1: float, b2: float) -> None:
    fn = _build.bind(SOURCE, "azt_fused_adam_multi", MULTI_ARGTYPES)
    folded = folded_on(scalars, table.device)
    with torch.cuda.device(table.device):
        if not _config_checked:
            launch_config()
        stream = torch.cuda.current_stream(table.device).cuda_stream
        for args in launch_args(table):
            rc = fn(*args, folded.data_ptr(), b1, b2, 1.0 - b1, 1.0 - b2,
                    stream)
            _build.check_launch(SOURCE, rc, "fused_adam")
            LAUNCHES.add(KERNEL_NAME)


def _sweep_cost(ps, gs):
    """(flops, bytes) of a sweep: `leaf_cost` (JAX L104, declared at L162)
    of every leaf, the gradient read in its own dtype."""
    flops = bytes_ = 0.0
    for p, g in zip(ps, gs):
        f, b = leaf_cost(tuple(p.shape), p.dtype, g.dtype)
        flops += f
        bytes_ += b
    return flops, bytes_


def _sweep(ps: List[torch.Tensor], ms: List[torch.Tensor],
           vs: List[torch.Tensor], gs: List[torch.Tensor],
           scalars, b1: float, b2: float) -> None:
    """Every leaf, in place: CPU tensors through `_adam_math` leaf by
    leaf, CUDA tensors through the kernel, one launch for every
    `MAX_LEAVES` leaves. `scalars`: the folded `(a, b, lr·wd)`, host
    floats or an f32 tensor of three on the leaves' device."""
    if not ps:
        return
    with kernel_region(_sweep_cost, ps, gs):
        _sweep_routes(ps, ms, vs, gs, scalars, b1, b2)


def _sweep_routes(ps, ms, vs, gs, scalars, b1: float, b2: float) -> None:
    if ps[0].device.type == "cpu":
        _one_device(ps + ms + vs + gs)
        a, b, lrwd = scalars
        for p, m, v, g in zip(ps, ms, vs, gs):
            p_new, m_new, v_new = _adam_math(p.float(), m, v, g.float(), a,
                                             b, lrwd, b1, b2)
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
        return
    if ps[0].device.type != "cuda":
        raise ValueError(f"fused_adam: unsupported device {ps[0].device}")
    table = _build_table(ps, ms, vs, gs)
    if len(table.numel):
        _launch(table, scalars, float(b1), float(b2))


def leaf_update(p, m, v, g, scalars, b1: float, b2: float) -> None:
    """One leaf, in place: a sweep of one leaf."""
    _sweep([p], [m], [v], [g], scalars, b1, b2)


@torch.no_grad()
def fused_adam_step(params: Dict[str, torch.Tensor],
                    mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
                    grads: Mapping[str, torch.Tensor], count: int, *,
                    lr: float, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, weight_decay: float = 0.0,
                    folded: Optional[torch.Tensor] = None):
    """One fused Adam step over every leaf, in place: returns the same
    (params, mu, nu) dicts. `count` is the new step number (1 on the first
    call); `lr` the resolved learning rate of this step. `folded`, when
    given, is this step's `(a, b, lr·wd)` already on the device (a row of
    the scalar table), and `count` and `lr` are then not read."""
    scalars = folded if folded is not None else _fold_scalars(
        count, lr, b1, b2, eps, weight_decay)
    names = list(params)
    _sweep(list(params.values()), [mu[k] for k in names],
           [nu[k] for k in names], [grads[k] for k in names], scalars, b1,
           b2)
    return params, mu, nu
