"""Unified typed configuration with environment-variable overrides.

Copied from `analytics_zoo_tpu/common/config.py` (L1-205): `_coerce`
(L23), `MeshConfig` (L45), `FailureConfig`, `CheckpointConfig`,
`ZooConfig` (L86) with `sharded_fit` (L107), `from_dict`, `from_env` (the
`ZOO_*` variables), `save` and `load`. The serving default is the port's
`serving/config.ServingConfig`. One field is the port's own: `device`
(env `ZOO_DEVICE`), where the context's rank runs: None is the card
(`cuda`, one rank per card by `local rank % cards`), `"cpu"` the CPU; the
JAX package reads the device from the platform its process was started
on (`JAX_PLATFORMS`).

The reference scatters configuration over six mechanisms — SparkConf keys from an
embedded properties file (`common/NNContext.scala:189-239`), Java system
properties (`bigdl.failure.retryTimes`), `init_orca_context` kwargs
(`orca/common.py:89`), `ZooContext`/`OrcaContext` class-property flags
(`orca/common.py:21-86`), the serving YAML, and per-example scopt CLIs. Here a
single dataclass hierarchy carries every knob; `ZOO_*` environment variables
override any field, and sub-configs serialize to/from plain dicts so the serving
YAML and CLI layers reuse the same schema.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _coerce(value: str, typ: Any, env_key: str) -> Any:
    """Parse an env-var string into the annotated field type."""
    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[T] → first non-None arg
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        typ = args[0] if args else str
        origin = typing.get_origin(typ)
    try:
        if typ is bool:
            return value.lower() in ("1", "true", "yes", "on")
        if typ is int:
            return int(value)
        if typ is float:
            return float(value)
        if origin is tuple or typ is tuple:
            return tuple(int(v) for v in value.split(",") if v)
    except ValueError as e:
        raise ValueError(f"Bad value for env override {env_key}={value!r}: {e}")
    return value


@dataclass
class MeshConfig:
    """Logical device-mesh axes over ICI (fast, intra-slice) and DCN (slow,
    cross-slice). Axis sizes of -1 are inferred from the device count. Axis
    order/meaning is defined by `analytics_zoo_tpu_torch.common.mesh.AXIS_NAMES`."""

    data: int = -1        # data parallel (outermost; may span DCN)
    fsdp: int = 1         # parameter/optimizer sharding (ZeRO-style)
    tensor: int = 1       # tensor/model parallel (innermost; rides ICI)
    sequence: int = 1     # sequence/context parallel (ring attention)
    pipeline: int = 1     # pipeline stages (spans DCN between slices)
    expert: int = 1       # expert parallel for MoE


@dataclass
class FailureConfig:
    """Retry/recovery semantics of the reference's training loop
    (`Topology.scala:1255-1337`): `bigdl.failure.retryTimes` default 5 within a
    120 s sliding window, restore from the latest snapshot on failure."""

    retry_times: int = 5
    retry_time_interval_s: int = 120


@dataclass
class CheckpointConfig:
    """Checkpoint layout compatible with the reference
    (`tf_optimizer.py:398-413`): `<dir>/<stamp>/model.<iteration>` plus
    `optimMethod-<name>.<iteration>`."""

    path: Optional[str] = None
    every_n_iterations: int = 0      # 0 → only on EveryEpoch trigger
    keep: int = 3
    async_save: bool = True


def _default_serving_config():
    # The canonical ServingConfig lives in serving/config.py (it also owns
    # YAML loading and model resolution); lazy factory keeps this base module
    # import-light and cycle-free.
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    return ServingConfig()


@dataclass
class ZooConfig:
    """Top-level framework config. Build with `ZooConfig()` and override fields,
    or via `ZooConfig.from_env()` / `from_dict()`."""

    mesh: MeshConfig = field(default_factory=MeshConfig)
    failure: FailureConfig = field(default_factory=FailureConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    serving: Any = field(default_factory=_default_serving_config)

    log_level: str = "INFO"
    log_output: bool = False
    seed: int = 0
    # GSPMD-sharded training by default: fit_keras shards params and
    # optimizer state over the mesh's fsdp axis with the default
    # transformer rule table (the same table serving's sharded placement
    # uses). Equivalent to fit_keras(sharding_rules=True); the env
    # spelling is ZOO_SHARDED_FIT=1. Pair with a MeshConfig whose fsdp
    # axis is > 1 (e.g. ZOO_MESH_DATA=1 ZOO_MESH_FSDP=-1).
    sharded_fit: bool = False
    # Fused Pallas optimizer kernels: fit_keras swaps a
    # default-hyperparameter adam/adamw compile spec for the one-HBM-pass
    # fused update (`pallas/fused_adam.py`; with lazy_embeddings the
    # declared tables take the sparse segment path). Equivalent to
    # fit_keras(fused_optimizer=True); env spellings ZOO_FUSED_OPTIMIZER=1
    # (this field) or ZOO_FUSED_OPT=1 (short form, read at fit time).
    # Off-path optimizers and non-lowering backends degrade to plain
    # optax with one WARNING, so this is safe to set fleet-wide.
    fused_optimizer: bool = False
    # Parallel streaming input pipeline: worker threads for
    # file-backed dataset read+decode (`data/pipeline.py` — TFRecord /
    # parquet / csv shards decode concurrently behind a deterministic
    # reorder buffer, so any value yields the SAME batch stream). 0
    # keeps datasets single-threaded unless they pass their own
    # workers knob. Env spelling ZOO_PIPELINE_WORKERS.
    pipeline_workers: int = 0
    # Depth of the trainer's host→device prefetch queue (batches held
    # ready while the device runs the current step). Bounds host
    # memory: the input side never materializes more than
    # prefetch_depth batches + one decoded shard per pipeline worker.
    # Env spelling ZOO_PREFETCH_DEPTH.
    prefetch_depth: int = 2
    default_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # pandas_read_backend flag of the reference (`nncontext.py:269`)
    pandas_read_backend: str = "pandas"
    # PRNG implementation. "rbg" generates random bits via the XLA RngBitGenerator
    # op, which is an order of magnitude faster than threefry on TPU (dropout in
    # a BERT-base train step is ~25% of wall time under threefry); keys remain
    # splittable. Set "threefry2x32" for cross-platform bit-exact streams.
    prng_impl: str = "rbg"
    # multi-host rendezvous (replaces the reference's five rendezvous schemes)
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # where this process's rank runs (the port's own field): None is the
    # card, "cpu" the CPU
    device: Optional[str] = None

    ENV_PREFIX = "ZOO_"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ZooConfig":
        cfg = cls()
        fields = {f.name for f in dataclasses.fields(cfg)}
        for k, v in d.items():
            if k not in fields:
                raise ValueError(f"Unknown config key: {k}")
            cur = getattr(cfg, k)
            if dataclasses.is_dataclass(cur) and isinstance(v, dict):
                sub_fields = {f.name for f in dataclasses.fields(cur)}
                legacy = getattr(type(cur), "LEGACY_FIELDS", {})
                for sk, sv in v.items():
                    sk = legacy.get(sk, sk)
                    if sk not in sub_fields:
                        raise ValueError(f"Unknown config key: {k}.{sk}")
                    setattr(cur, sk, sv)
            else:
                setattr(cfg, k, v)
        return cfg

    @classmethod
    def from_env(cls, base: Optional["ZooConfig"] = None) -> "ZooConfig":
        """Apply `ZOO_<FIELD>` / `ZOO_<SECTION>_<FIELD>` env overrides, e.g.
        `ZOO_MESH_TENSOR=4`, `ZOO_LOG_LEVEL=DEBUG`. `base` is not mutated."""
        import copy
        cfg = copy.deepcopy(base) if base is not None else cls()
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cfg):
            cur = getattr(cfg, f.name)
            if dataclasses.is_dataclass(cur):
                sub_hints = typing.get_type_hints(type(cur))
                legacy = getattr(type(cur), "LEGACY_FIELDS", {})
                for old, new in legacy.items():
                    key = f"{cls.ENV_PREFIX}{f.name}_{old}".upper()
                    if key in os.environ:
                        setattr(cur, new,
                                _coerce(os.environ[key], sub_hints[new], key))
                for sf in dataclasses.fields(cur):
                    key = f"{cls.ENV_PREFIX}{f.name}_{sf.name}".upper()
                    if key in os.environ:
                        setattr(cur, sf.name,
                                _coerce(os.environ[key], sub_hints[sf.name], key))
            else:
                key = f"{cls.ENV_PREFIX}{f.name}".upper()
                if key in os.environ:
                    setattr(cfg, f.name,
                            _coerce(os.environ[key], hints[f.name], key))
        return cfg

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)

    @classmethod
    def load(cls, path: str) -> "ZooConfig":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))
