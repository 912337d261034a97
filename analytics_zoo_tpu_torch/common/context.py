"""Context initialization — the `init_orca_context` / `init_nncontext` analogue.

Port of `analytics_zoo_tpu/common/context.py` (L1-212): `_ContextMeta`
(L27) with `ZooContext` and `OrcaContext`, `Context` (L88),
`init_zoo_context` (L104), `init_orca_context` (L174), `get_context`
(L202) and `stop_orca_context` (L209).

- `cluster_mode="multi-host"` (and its yarn / k8s / standalone spellings)
  runs `torch.distributed.init_process_group` from the coordinator that
  the JAX package hands `jax.distributed.initialize` (L134): the config's
  `coordinator_address` or `COORDINATOR_ADDRESS` (`host:port`, a TCP
  store; or a `file://` path, a `FileStore`), `num_processes`
  (`ZOO_NUM_PROCESSES`) and `process_id` (`ZOO_PROCESS_ID`). One process
  is one rank on one device: the card `local rank % cards` (the local
  rank is the process id modulo `ZOO_LOCAL_PROCESSES`, the launchers'
  ranks per host), or the CPU when the config's `device` (env
  `ZOO_DEVICE`) is `"cpu"`. The backend is NCCL for one rank per card
  and gloo on the CPU or where ranks share a card (NCCL refuses two ranks
  on one device).
- `"local"` is one process: on the card, or on the CPU when the caller
  asks for it (`device="cpu"` or the config's `device`). After a
  multi-host initialisation it spans every rank, as a JAX local context
  then spans every process's devices.
- The mesh (`common/mesh.DeviceMesh`) lays the process group's ranks out
  over the axes; `get_context()` makes a local context on first use, as
  the JAX package does.
- `Context.next_rng()` draws an integer seed from a `torch.Generator`
  seeded with the config's seed, where the JAX context splits a
  `jax.random` key; the TPU-only PRNG switch (L149-155) has no
  counterpart.
- `stop_orca_context()` also destroys the process group the context
  created, so a process can initialise again.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
from analytics_zoo_tpu_torch.common.device import resolve_device
from analytics_zoo_tpu_torch.common.mesh import DeviceMesh

log = logging.getLogger("analytics_zoo_tpu_torch")

_GLOBAL = {"context": None, "distributed_initialized": False,
           "device": None}


class _ContextMeta(type):
    """Class-property global flags, mirroring `ZooContextMeta`
    (`nncontext.py:269`) / `OrcaContextMeta` (`orca/common.py:21`)."""

    _log_output = False
    _pandas_read_backend = "pandas"
    _serialize_data_creator = False
    _train_data_store = "DRAM"

    @property
    def log_output(cls) -> bool:
        return _ContextMeta._log_output

    @log_output.setter
    def log_output(cls, value: bool):
        # Only toggles output capture, never the configured verbosity
        # (matches the reference, where log_output redirects executor stdout,
        # `nncontext.py:274`).
        _ContextMeta._log_output = value

    @property
    def pandas_read_backend(cls) -> str:
        return _ContextMeta._pandas_read_backend

    @pandas_read_backend.setter
    def pandas_read_backend(cls, value: str):
        value = value.lower()
        if value not in ("pandas", "spark", "arrow"):
            raise ValueError(f"Unsupported pandas_read_backend: {value}")
        _ContextMeta._pandas_read_backend = value

    @property
    def train_data_store(cls) -> str:
        return _ContextMeta._train_data_store

    @train_data_store.setter
    def train_data_store(cls, value: str):
        value = value.upper()
        if value not in ("DRAM", "DISK", "DISK_AND_DRAM"):
            raise ValueError(f"Unsupported train_data_store: {value}")
        _ContextMeta._train_data_store = value


class ZooContext(metaclass=_ContextMeta):
    pass


class OrcaContext(metaclass=_ContextMeta):
    pass


def _configure_logging(level: str):
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log.setLevel(getattr(logging, level.upper(), logging.INFO))


class Context:
    """The live runtime context: config + mesh of ranks (+ this rank's
    device)."""

    def __init__(self, config: ZooConfig, mesh: DeviceMesh):
        self.config = config
        self.mesh = mesh
        self.device = mesh.device
        self.gen = torch.Generator().manual_seed(int(config.seed))

    def next_rng(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.gen))

    def __repr__(self):
        return f"Context(mesh={self.mesh}, processes={self.mesh.world})"


def _rank_device(config: ZooConfig, local_rank: int) -> torch.device:
    """The device of this process's rank: the config's, with a CUDA device
    without an index taking card `local_rank % cards`."""
    dev = resolve_device(config.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def _backend(device: torch.device, local_processes: int) -> str:
    """NCCL for one rank per card, gloo on the CPU and for ranks that
    share a card."""
    if device.type == "cuda" and \
            local_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _init_process_group(config: ZooConfig) -> torch.device:
    coordinator = (config.coordinator_address
                   or os.environ.get("COORDINATOR_ADDRESS"))
    if coordinator is None:
        raise ValueError(
            "cluster_mode=multi-host needs a coordinator: set "
            "ZooConfig.coordinator_address or COORDINATOR_ADDRESS "
            "(host:port, or file:///path for a shared file store)")
    if config.num_processes is None or config.process_id is None:
        raise ValueError(
            "cluster_mode=multi-host needs the world size and this "
            "process's rank: set ZooConfig.num_processes / process_id or "
            "ZOO_NUM_PROCESSES / ZOO_PROCESS_ID")
    world, rank = int(config.num_processes), int(config.process_id)
    local = int(os.environ.get("ZOO_LOCAL_PROCESSES", world))
    device = _rank_device(config, rank % local)
    backend = _backend(device, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return device


def init_zoo_context(config: Optional[ZooConfig] = None,
                     cluster_mode: str = "local", device=None,
                     **mesh_axes) -> Context:
    """Initialise the runtime. Equivalent of `init_nncontext`
    (`nncontext.py:319`) + `NNContext.initNNContext` (`NNContext.scala:134`).

    cluster_mode:
      "local"      — this process (one rank; every rank of a process group
                     this process already joined).
      "multi-host" — `torch.distributed.init_process_group` with the
                     coordinator settings from config or env.
    `device` (the port's own): where a local context's rank runs (None:
    the config's `device`, then the card).
    """
    config = ZooConfig.from_env(config)  # copies; caller's object untouched
    if device is not None:
        config.device = str(device)
    _configure_logging(config.log_level)
    ZooContext.log_output = config.log_output
    ZooContext.pandas_read_backend = config.pandas_read_backend

    if cluster_mode in ("multi-host", "yarn", "k8s", "standalone"):
        if not _GLOBAL["distributed_initialized"]:
            _GLOBAL["device"] = _init_process_group(config)
            _GLOBAL["distributed_initialized"] = True
    elif cluster_mode != "local":
        raise ValueError(f"Unknown cluster_mode: {cluster_mode}")

    if mesh_axes:
        valid = set(MeshConfig.__dataclass_fields__)
        unknown = set(mesh_axes) - valid
        if unknown:
            raise TypeError(
                f"Unknown mesh axis kwarg(s) {sorted(unknown)}; "
                f"valid axes: {sorted(valid)}")
        for k, v in mesh_axes.items():
            setattr(config.mesh, k, v)
    rank_device = _GLOBAL["device"] if _GLOBAL["distributed_initialized"] \
        else _rank_device(config, 0)
    mesh = DeviceMesh(config.mesh, device=rank_device)
    ctx = Context(config, mesh)
    _GLOBAL["context"] = ctx
    log.info("Initialized %s on %d rank(s) (%s, %s)", mesh, mesh.world,
             rank_device, mesh.backend or "no process group")
    return ctx


def init_orca_context(cluster_mode: str = "local",
                      cores: Optional[int] = None,
                      memory: Optional[str] = None,
                      num_nodes: int = 1,
                      init_ray_on_spark: bool = False,
                      config: Optional[ZooConfig] = None,
                      device=None,
                      **kwargs) -> Context:
    """Drop-in analogue of `init_orca_context` (`orca/common.py:89`). The
    Spark-centric kwargs (cores/memory/num_nodes) are accepted for source
    compatibility; they are informational — the mesh is defined by the
    ranks, not by executor sizing."""
    known_spark = {"driver_cores", "driver_memory", "num_executors",
                   "executor_cores", "executor_memory", "extra_python_lib",
                   "conf", "init_ray_on_spark"}
    mesh_axes = {}
    for k, v in kwargs.items():
        if k in MeshConfig.__dataclass_fields__:
            mesh_axes[k] = v
        elif k not in known_spark:
            raise TypeError(
                f"init_orca_context got unknown kwarg {k!r}; mesh axes are "
                f"{sorted(MeshConfig.__dataclass_fields__)}")
    if cluster_mode in ("yarn", "yarn-client", "yarn-cluster", "k8s",
                        "standalone"):
        cluster_mode = "multi-host"
    return init_zoo_context(config, cluster_mode=cluster_mode,
                            device=device, **mesh_axes)


def current_context() -> Optional[Context]:
    """The initialised context, or None (no local one is made)."""
    return _GLOBAL["context"]


def get_context() -> Context:
    ctx = _GLOBAL["context"]
    if ctx is None:
        ctx = init_zoo_context()
    return ctx


def stop_orca_context() -> None:
    """Analogue of `stop_orca_context` (`orca/common.py:204`): clears the
    global context and destroys the process group this module created."""
    _GLOBAL["context"] = None
    if _GLOBAL["distributed_initialized"]:
        if dist.is_initialized():
            dist.destroy_process_group()
        _GLOBAL["distributed_initialized"] = False
        _GLOBAL["device"] = None
