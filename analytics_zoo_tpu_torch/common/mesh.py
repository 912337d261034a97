"""The mesh of ranks: the single communication substrate.

Port of `analytics_zoo_tpu/common/mesh.py` (L1-155): `AXIS_NAMES`,
`BATCH_AXES` and `_infer_axis_sizes` (L30-56) as they are, and
`DeviceMesh` (L59).

The JAX mesh spans the devices of one program, and XLA emits the
collectives. In torch each rank is one process on one device, so the mesh
is a named layout of the process group's ranks (row-major over
`AXIS_NAMES`, `tensor` innermost, as the JAX mesh reshapes its devices),
built on `torch.distributed.device_mesh.init_device_mesh` over the axes
larger than 1, and it owns the collectives that the JAX package gets from
GSPMD: `all_reduce`, `all_gather`, `reduce_scatter` and the ring
`permute` (`lax.ppermute`). Without a process group it is the trivial
one-rank mesh and every collective is the identity. With one, every
collective over a group of more than one rank is issued, and so is one
over the whole world of one rank (a one-rank NCCL fit runs its all-reduce
through NCCL); a group of one rank inside a larger world is the identity.

Which call carries a collective is decided by `COLLECTIVE_ROUTES`, keyed
by the backend and the tensor's device type: NCCL carries every collective
on CUDA tensors and gloo every one on CPU tensors. On CUDA tensors torch
2.11's gloo carries the all-reduce, the all-gather and the reduce-scatter
(each held on an H100 in a two-rank group of its own), but its send and
receive hand the card's address to the socket layer, which aborts the
process, so the mesh copies a CUDA tensor to the host and back for the
permute ("host"), counting each such call in `HOST_STAGED`. There is no
fallback: a route is read from the table and run. `route_table()` prints
it. Each collective's calls and host seconds are counted in
`COLLECTIVE_STATS`.

The backend is chosen by the context (`common/context.py`): NCCL for one
rank per CUDA device, gloo on the CPU and where ranks share a card.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from analytics_zoo_tpu_torch.common.config import MeshConfig

# Outermost → innermost. Single source of truth for axis names/order.
AXIS_NAMES: Tuple[str, ...] = (
    "pipeline", "data", "fsdp", "sequence", "expert", "tensor")
# Axes over which the input batch is split.
BATCH_AXES: Tuple[str, ...] = ("data", "fsdp")

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "permute")

# (backend, tensor device type) → {collective: route}
COLLECTIVE_ROUTES: Dict[Tuple[str, str], Dict[str, str]] = {
    ("nccl", "cuda"): {"all_reduce": "native", "all_gather": "native",
                       "reduce_scatter": "native", "permute": "native"},
    ("gloo", "cpu"): {"all_reduce": "native", "all_gather": "native",
                      "reduce_scatter": "native", "permute": "native"},
    ("gloo", "cuda"): {"all_reduce": "native", "all_gather": "native",
                       "reduce_scatter": "native", "permute": "host"},
}

_STATS_LOCK = threading.Lock()
# collective → calls that copied a CUDA tensor to the host and back
HOST_STAGED: Dict[str, int] = {}
# collective → [calls, host seconds]
COLLECTIVE_STATS: Dict[str, List[float]] = {}


def reset_collective_stats() -> None:
    with _STATS_LOCK:
        HOST_STAGED.clear()
        COLLECTIVE_STATS.clear()


def collective_stats() -> Dict[str, Dict[str, float]]:
    """{collective: {"calls", "seconds", "host_staged"}} since the last
    `reset_collective_stats()`."""
    with _STATS_LOCK:
        return {name: {"calls": int(v[0]), "seconds": v[1],
                       "host_staged": HOST_STAGED.get(name, 0)}
                for name, v in COLLECTIVE_STATS.items()}


def _count(name: str, seconds: float, staged: bool) -> None:
    with _STATS_LOCK:
        rec = COLLECTIVE_STATS.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += seconds
        if staged:
            HOST_STAGED[name] = HOST_STAGED.get(name, 0) + 1


def route_table(backend: Optional[str] = None) -> Dict[str, Dict[str, str]]:
    """The routes of `backend` (every backend's when None), keyed
    `"<backend>/<device type>"`."""
    return {f"{b}/{d}": dict(r) for (b, d), r in COLLECTIVE_ROUTES.items()
            if backend is None or b == backend}


def _infer_axis_sizes(n_devices: int, cfg: MeshConfig) -> Dict[str, int]:
    sizes = {name: getattr(cfg, name) for name in AXIS_NAMES}
    for name, v in sizes.items():
        if v != -1 and v < 1:
            raise ValueError(
                f"Mesh axis {name}={v} invalid: must be >=1, or -1 to infer")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    free = [k for k, v in sizes.items() if v == -1]
    if len(free) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {free}")
    if free:
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product {fixed}")
        sizes[free[0]] = n_devices // fixed
    if math.prod(sizes.values()) != n_devices:
        raise ValueError(
            f"Mesh {sizes} does not cover {n_devices} devices")
    return sizes


_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


class DeviceMesh:
    """A named logical mesh over the process group's ranks (one device a
    rank).

    >>> mesh = DeviceMesh()                       # all-data-parallel
    >>> mesh = DeviceMesh(MeshConfig(data=1, fsdp=-1), device="cuda:0")
    >>> mesh.all_reduce(grads_flat)               # over data x fsdp
    """

    def __init__(self, config: Optional[MeshConfig] = None,
                 device=None):
        self.config = config or MeshConfig()
        self.distributed = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if self.distributed else 1
        self.rank = dist.get_rank() if self.distributed else 0
        self.backend = dist.get_backend() if self.distributed else None
        self.device = torch.device(device if device is not None else "cpu")
        self.axis_sizes = _infer_axis_sizes(self.world, self.config)
        self.shape = tuple(self.axis_sizes[a] for a in AXIS_NAMES)
        self.coords = dict(zip(AXIS_NAMES, (int(c) for c in np.unravel_index(
            self.rank, self.shape))))
        self.live_axes = tuple(a for a in AXIS_NAMES
                               if self.axis_sizes[a] > 1)
        self.torch_mesh = None
        self._batch_group = None
        if self.distributed:
            from torch.distributed.device_mesh import init_device_mesh
            dims = self.live_axes or ("data",)
            self.torch_mesh = init_device_mesh(
                self.device.type, tuple(self.axis_sizes[a] for a in dims),
                mesh_dim_names=dims)
            live_batch = [a for a in BATCH_AXES if self.axis_sizes[a] > 1]
            if len(live_batch) == 2 and \
                    self.data_parallel_size < self.world:
                # every rank makes every group, in the same order
                self._batch_group, _ = dist.new_subgroups_by_enumeration(
                    self._groups_of(BATCH_AXES))

    # -- layout ---------------------------------------------------------------
    @property
    def n_devices(self) -> int:
        return self.world

    @property
    def data_parallel_size(self) -> int:
        return math.prod(self.axis_sizes[a] for a in BATCH_AXES)

    def size(self, axis) -> int:
        axes = axis if isinstance(axis, tuple) else (axis,)
        return math.prod(self.axis_sizes[a] for a in axes)

    def coordinate(self, axis) -> int:
        """This rank's index along `axis` (a tuple: row-major over it)."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        idx = 0
        for a in axes:
            idx = idx * self.axis_sizes[a] + self.coords[a]
        return idx

    @property
    def batch_index(self) -> int:
        """This rank's share of the global batch (over `BATCH_AXES`)."""
        return self.coordinate(BATCH_AXES)

    def rank_at(self, **coords) -> int:
        """The global rank at this rank's coordinates with `coords`
        replaced."""
        c = dict(self.coords, **coords)
        return int(np.ravel_multi_index(tuple(c[a] for a in AXIS_NAMES),
                                        self.shape))

    def _groups_of(self, axes: Sequence[str]) -> List[List[int]]:
        """Every group of ranks that differ only along `axes`."""
        grid = np.arange(self.world).reshape(self.shape)
        keep = [AXIS_NAMES.index(a) for a in axes]
        rest = [i for i in range(len(AXIS_NAMES)) if i not in keep]
        moved = np.transpose(grid, rest + keep).reshape(
            -1, math.prod(self.shape[i] for i in keep))
        return [sorted(int(r) for r in row) for row in moved]

    def _group(self, axes):
        """(process group, its size) for a collective over `axes`; None
        for the identity."""
        axes = axes if isinstance(axes, tuple) else (axes,)
        if not self.distributed:
            return None, 1
        live = tuple(a for a in axes if self.axis_sizes[a] > 1)
        n = self.size(live) if live else 1
        if n == self.world:
            return dist.group.WORLD, n
        if n == 1:
            return None, 1
        if len(live) == 1:
            return self.torch_mesh.get_group(live[0]), n
        if set(live) == set(BATCH_AXES):
            return self._batch_group, n
        raise NotImplementedError(
            f"a collective over {live} is not one of the mesh's groups")

    def _route(self, name: str, t: torch.Tensor) -> str:
        try:
            return COLLECTIVE_ROUTES[(self.backend, t.device.type)][name]
        except KeyError:
            raise NotImplementedError(
                f"no route for {name} over {self.backend} on "
                f"{t.device.type} tensors") from None

    # -- collectives ----------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, axes=BATCH_AXES,
                   op: str = "sum") -> torch.Tensor:
        """`t` reduced over `axes`, in place (`lax.psum`)."""
        group, _ = self._group(axes)
        if group is None:
            return t
        t0 = time.perf_counter()
        route = self._route("all_reduce", t)
        rop = getattr(dist.ReduceOp, _REDUCE_OPS[op])
        if route == "host":
            h = t.cpu()
            dist.all_reduce(h, op=rop, group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, op=rop, group=group)
        _count("all_reduce", time.perf_counter() - t0, route == "host")
        return t

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The blocks of every rank along `axis`, concatenated along `dim`
        in coordinate order (a new tensor)."""
        group, n = self._group((axis,))
        if group is None:
            return t
        t0 = time.perf_counter()
        route = self._route("all_gather", t)
        src = t.movedim(dim, 0).contiguous()
        if route == "host":
            src = src.cpu()
        if route == "native" and self.backend == "nccl":
            out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
            dist.all_gather_into_tensor(out, src, group=group)
        else:
            parts = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(parts, src, group=group)
            out = torch.cat(parts, 0)
        if route == "host":
            out = out.to(t.device)
        _count("all_gather", time.perf_counter() - t0, route == "host")
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, axis: str,
                       dim: int = 0) -> torch.Tensor:
        """`t` summed over `axis`; this rank's block of `dim` (which the
        axis size must divide), a new tensor."""
        group, n = self._group((axis,))
        if group is None:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(t.shape)} does not divide by {n}")
        t0 = time.perf_counter()
        route = self._route("reduce_scatter", t)
        src = t.movedim(dim, 0).contiguous()
        if route == "host":
            src = src.cpu()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        if route == "host":
            out = out.to(t.device)
        _count("reduce_scatter", time.perf_counter() - t0, route == "host")
        return out.movedim(0, dim)

    def permute(self, t: torch.Tensor, axis: str,
                shift: int = 1) -> torch.Tensor:
        """The ring hop along `axis` (`lax.ppermute` with pairs (i, i +
        shift)): sends `t` to the rank `shift` ahead and returns the block
        of the rank `shift` behind (a new tensor)."""
        group, n = self._group((axis,))
        if n == 1:
            return t
        t0 = time.perf_counter()
        route = self._route("permute", t)
        c = self.coords[axis]
        dst = self.rank_at(**{axis: (c + shift) % n})
        src = self.rank_at(**{axis: (c - shift) % n})
        send = t.contiguous()
        if route == "host":
            send = send.cpu()
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst),
                                       dist.P2POp(dist.irecv, recv, src)])
        for r in reqs:
            r.wait()
        if route == "host":
            recv = recv.to(t.device)
        _count("permute", time.perf_counter() - t0, route == "host")
        return recv

    def all_gather_ints(self, values: Sequence[int]) -> np.ndarray:
        """`[world, len(values)]` int64: every rank's values (a host
        exchange for counts and checks)."""
        v = torch.tensor(list(values), dtype=torch.int64)
        if not self.distributed:
            return v.numpy()[None]
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        v = v.to(dev)
        parts = [torch.empty_like(v) for _ in range(self.world)]
        dist.all_gather(parts, v)
        return torch.stack(parts).cpu().numpy()

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()

    def routes(self) -> Dict[str, str]:
        """This mesh's route of each collective on its device."""
        if not self.distributed:
            return {c: "identity" for c in COLLECTIVES}
        return dict(COLLECTIVE_ROUTES[(self.backend, self.device.type)])

    def __repr__(self):
        axes = ", ".join(f"{a}={self.axis_sizes[a]}"
                         for a in AXIS_NAMES if self.axis_sizes[a] != 1)
        return f"DeviceMesh({axes or 'single-device'})"

