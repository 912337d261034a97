"""Estimator — the unified training façade.

Port of `analytics_zoo_tpu/learn/estimator.py`: `Estimator.__init__`
(L79), `from_keras` (L89), `fit` (L160) with its retry-and-restore loop
(L244-292), `_restore_latest` and `_restore` (L294-310), `predict`,
`evaluate` with `_evaluate_quantized` (L322-381) and its
`QuantizationQualityError` (L47), `get_model`, `save`, `load` (L312-449) and
`load_orca_checkpoint` (L451); and `to_dataset` (L56), which takes
what the JAX one takes: a `TPUDataset` (`data/dataset.py`: in-memory,
a TFRecord stream, a disk-tier `FeatureSet`), an `XShards` of
`{"x": ..., "y": ...}`, a pandas DataFrame with `feature_cols` /
`label_cols`, or the in-memory forms of `TPUDataset.from_ndarrays`
(`{"x": ..., "y": ...}`, `(x, y)` or a bare x).

A dataset without in-memory arrays (`x` None: a TFRecord stream, a
disk-tier `FeatureSet`) trains through the JAX `fit`'s lazy bridge
(L183-230): its own batch size wins over `fit`'s, its `iter_train(dp,
seed=seed + epoch)` is the fit's `batch_iter_factory` (`dp` the context
mesh's data-parallel size, 1 without a context) carrying the dataset's
`shards_per_host` mark (a TFRecord stream reads disjoint files per host,
which the trainer's multi-process guard admits), and an unbuilt model is
built from the dataset's `first_sample` (one record, not a shuffle
buffer's fill). `distributed` and `sharding_rules` pass through to the
trainer (JAX L169), which runs the fit over the context's mesh of ranks. `evaluate` and `predict` run over the dataset's
`materialize()`.

With `model_dir`, `fit` checkpoints into it (`model.set_checkpoint`) and
runs the reference's retry loop (`Topology.scala:1255-1337`): on a
training failure other than a ValueError or a device error, reload the
newest checkpoint and go on with the epochs left, up to
`failure.retry_times` failures within `failure.retry_time_interval_s`
(`FailureConfig`, the JAX package's `common/config.py:64-65` defaults).
As in the JAX package, the reload restores the parameters only
(`_restore_latest`), so a retried fit starts its optimizer state afresh,
and the retry runs `fit_keras` with `seed + epoch_done`.

`device`: where `fit`, `predict` and `evaluate` run; `None` is this
rank's device under an initialised context (`init_orca_context`), else
`cuda`, and asking for `cuda` without a GPU raises. The model is moved
there in place.

`evaluate(quantize="int8")` evaluates the int8 twin of the model
(`serving/quantization.quantize_model_params`, a new module), so the f32
model is untouched by construction where the JAX package swaps its
parameters and restores them.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.common.tree import tree_map
from analytics_zoo_tpu_torch.data.dataset import TPUDataset
from analytics_zoo_tpu_torch.data.shards import XShards
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt_mod
from analytics_zoo_tpu_torch.learn import trainer
from analytics_zoo_tpu_torch.observability.registry import get_registry

log = logging.getLogger("analytics_zoo_tpu_torch.estimator")

# device faults are not retried, as the JAX package lets
# `jax.errors.JaxRuntimeError` through
_DEVICE_ERRORS = tuple(e for e in (torch.cuda.OutOfMemoryError,
                                   getattr(torch, "AcceleratorError", None))
                       if e is not None)


class QuantizationQualityError(ValueError):
    """The int8 model's metrics drifted past the tolerance from the f32
    baseline: the quality gate of `Estimator.evaluate(...,
    quantize="int8", quality_tolerance=...)` refusing to bless the
    quantized model for serving."""


@dataclass
class FailureConfig:
    """Retry/recovery semantics of the reference's training loop
    (`Topology.scala:1255-1337`): `bigdl.failure.retryTimes` default 5
    within a 120 s sliding window, restore from the latest snapshot on
    failure (the JAX package's `common/config.FailureConfig`)."""

    retry_times: int = 5
    retry_time_interval_s: int = 120


def to_dataset(data, batch_size: int = -1, batch_per_thread: int = -1,
               feature_cols: Optional[Sequence[str]] = None,
               label_cols: Optional[Sequence[str]] = None) -> TPUDataset:
    """Normalize any supported data form into a TPUDataset."""
    if isinstance(data, TPUDataset):
        return data
    if isinstance(data, XShards):
        return TPUDataset.from_xshards(data, batch_size, batch_per_thread)
    try:
        import pandas as pd
        if isinstance(data, pd.DataFrame):
            if not feature_cols:
                raise ValueError("DataFrame input needs feature_cols")
            return TPUDataset.from_dataframe(data, feature_cols, label_cols,
                                             batch_size, batch_per_thread)
    except ImportError:
        pass
    return TPUDataset.from_ndarrays(data, batch_size, batch_per_thread)


class Estimator:
    """Unified estimator façade (`orca/learn/base_estimator.py:43`)."""

    def __init__(self, model, model_dir: Optional[str] = None,
                 device: DeviceLike = None,
                 failure: Optional[FailureConfig] = None):
        self.model = model
        self.model_dir = model_dir
        self.device = device
        self.failure = failure or FailureConfig()
        self._load_ckpt: Optional[Tuple[str, Optional[int]]] = None
        self._resume_epoch = 0

    @staticmethod
    def from_keras(keras_model, model_dir: Optional[str] = None,
                   optimizer=None, loss=None, metrics=None,
                   device: DeviceLike = None) -> "Estimator":
        """The model may already be compiled; compile args given here
        override."""
        if optimizer is not None or loss is not None:
            keras_model.compile(optimizer or "adam", loss or "mse", metrics)
        return Estimator(keras_model, model_dir, device)

    def _on_device(self):
        """The model onto `device`; None is the context's rank device when
        a context is initialised, else `cuda`."""
        from analytics_zoo_tpu_torch.common.context import current_context
        ctx = current_context()
        device = self.device if self.device is not None or ctx is None \
            else ctx.device
        self.model.to(resolve_device(device))

    # -- training with retry/resume ---------------------------------------
    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            validation_data=None, checkpoint_trigger=None,
            feature_cols=None, label_cols=None, seed: int = 0,
            **fit_kwargs) -> Dict[str, List[float]]:
        """Train on `data` for `epochs`; `fit_kwargs` pass through to
        `learn.trainer.fit_keras` (`mixed_precision=True` runs bf16
        compute with f32 masters, `fused_optimizer=True` swaps a stock
        adam/adamw for the fused-Adam kernel, `auto_resume`,
        `step_retries`, `step_timeout_s`, `end_trigger`, the input
        pipeline and telemetry: `prefetch`, `prefetch_depth`,
        `batch_iter_factory`, `flops_per_step`, `metrics_report_s`,
        `profile_steps`, `profile_dir`, the programs: `steps_per_run`,
        `device_cache`, `compile_cache_dir`, and the distributed fit:
        `distributed`, `sharding_rules=True` or a
        `parallel.sharding.ShardingRules`, over the mesh of
        `init_orca_context`). Labels may be a list of arrays,
        one per output of a model compiled with a list of losses.
        `validation_data` (any form `to_dataset` takes) is evaluated after
        every epoch into `history["val_<metric>"]`. Returns the history."""
        ds = to_dataset(data, batch_size=batch_size or 32,
                        feature_cols=feature_cols, label_cols=label_cols)
        # a pre-built TPUDataset's own batch/shuffle settings win over fit()
        # defaults (the dataset carries the contract, `tf_dataset.py:116`)
        if ds.batch_size != -1:
            batch_size = ds.batch_size
        elif batch_size is None:
            batch_size = 32
        lazy = ds.x is None  # disk-tier FeatureSet / TFRecord stream bridge
        from analytics_zoo_tpu_torch.common.context import current_context
        ctx = current_context()
        dp = ctx.mesh.data_parallel_size if ctx is not None else 1
        batch_iter_factory = fit_kwargs.pop("batch_iter_factory", None)
        if batch_iter_factory is None and lazy:
            def batch_iter_factory(epoch):
                return ds.iter_train(dp, seed=seed + epoch)
            # datasets that read DISJOINT files per host declare it so the
            # trainer's multi-process streaming-duplication guard admits
            # them
            batch_iter_factory.shards_per_host = getattr(
                ds, "shards_per_host", False)
        self._on_device()
        if lazy and not self.model.built and hasattr(ds, "first_sample"):
            # cheap shape probe: one record, not a shuffle-buffer fill
            sx, _ = ds.first_sample()
            self.model.ensure_built(
                tree_map(lambda a: np.expand_dims(a, 0), sx), seed=seed)
        val = None
        if validation_data is not None:
            val = to_dataset(validation_data, batch_size=batch_size,
                             feature_cols=feature_cols,
                             label_cols=label_cols).materialize()
        elif ds.val is not None:
            val = ds.val.materialize()
        if self.model_dir:
            self.model.set_checkpoint(self.model_dir)
        if self._load_ckpt is not None:
            self._restore(*self._load_ckpt)
            self._load_ckpt = None

        failures: List[float] = []
        epoch_done = self._resume_epoch
        history: Dict[str, List[float]] = {}
        while epoch_done < epochs:
            try:
                h = trainer.fit_keras(
                    self.model, ds.x, ds.y, batch_size=batch_size,
                    epochs=epochs - epoch_done, validation_data=val,
                    shuffle=ds.shuffle,
                    checkpoint_trigger=checkpoint_trigger,
                    seed=seed + epoch_done,
                    batch_iter_factory=batch_iter_factory, **fit_kwargs)
                for k, v in h.items():
                    history.setdefault(k, []).extend(v)
                break
            except (KeyboardInterrupt,) + _DEVICE_ERRORS:
                raise
            except ValueError:
                raise  # config errors are not retryable (IllegalArgument)
            except Exception as e:  # noqa: BLE001 — retry semantics
                now = time.time()
                cfg = self.failure
                failures = [t for t in failures
                            if now - t < cfg.retry_time_interval_s]
                failures.append(now)
                if len(failures) > cfg.retry_times:
                    log.error("Exceeded %d failures within %ds window; "
                              "giving up", cfg.retry_times,
                              cfg.retry_time_interval_s)
                    raise
                # counted only once the budget check passed: the final
                # fatal failure re-raises above and is not a recovery
                get_registry().counter(
                    "training_retries_total",
                    "training failures recovered by snapshot-restore "
                    "retry").inc()
                log.warning("Training failure (%s: %s); restoring latest "
                            "snapshot and retrying (%d/%d)",
                            type(e).__name__, e, len(failures),
                            cfg.retry_times)
                epoch_done = self._restore_latest() or epoch_done
        self._resume_epoch = 0
        return history

    def _load_params(self, path: str, version: Optional[int] = None):
        """The parameters (and buffers) of a checkpoint into the model,
        remapped onto its layer names; returns the checkpoint's meta."""
        params, _, meta = ckpt_mod.load_checkpoint(path, version)
        self.model.load_state_dict(convert.state_from_jax(
            self.model._remap_loaded(params), self.model))
        return meta

    def _restore_latest(self) -> Optional[int]:
        """Parameters only, as the JAX package does: the retried fit's
        optimizer state starts afresh."""
        if not self.model_dir:
            return None
        if ckpt_mod.latest_checkpoint(self.model_dir) is None:
            return None
        meta = self._load_params(self.model_dir)
        return int(meta.get("epoch", 0)) if meta else None

    def _restore(self, path: str, version: Optional[int]):
        meta = self._load_params(path, version)
        self._resume_epoch = int(meta.get("epoch", 0)) if meta else 0

    # -- inference ---------------------------------------------------------
    def predict(self, data, batch_per_thread: int = 32, feature_cols=None):
        x, _ = to_dataset(data, batch_per_thread=batch_per_thread,
                          feature_cols=feature_cols).materialize()
        self._on_device()
        return self.model.predict(x, batch_per_thread=batch_per_thread)

    def evaluate(self, data, batch_per_thread: int = 32, metrics=None,
                 feature_cols=None, label_cols=None,
                 quantize: Optional[str] = None,
                 quality_tolerance: Optional[float] = None,
                 baseline_metrics: Optional[Dict[str, float]] = None
                 ) -> Dict[str, float]:
        """The metrics (`metrics`, else the compiled ones, else the loss)
        over `data`. `quantize="int8"` evaluates the post-training-quantized
        model instead and, with `quality_tolerance`, enforces the quality
        gate: every metric within `quality_tolerance` (absolute) of the f32
        baseline, or `QuantizationQualityError`. The baseline is evaluated
        here unless `baseline_metrics` (an earlier f32 `evaluate()`) is
        given; the result holds the int8 metrics and the baseline's as
        `baseline_<name>`."""
        ds = to_dataset(data, batch_per_thread=batch_per_thread,
                        feature_cols=feature_cols, label_cols=label_cols)
        if quantize is not None:
            return self._evaluate_quantized(ds, batch_per_thread, metrics,
                                            quantize, quality_tolerance,
                                            baseline_metrics)
        self._on_device()
        return self._evaluate(self.model, ds, batch_per_thread, metrics)

    @staticmethod
    def _evaluate(model, ds, batch_per_thread, metrics):
        from analytics_zoo_tpu_torch.ops import metrics as zmetrics
        ms = zmetrics.resolve(metrics) if metrics else None
        x, y = ds.materialize()
        return model.evaluate(x, y, batch_per_thread=batch_per_thread,
                              metrics=ms)

    def _evaluate_quantized(self, data, batch_per_thread, metrics, quantize,
                            quality_tolerance, baseline_metrics
                            ) -> Dict[str, float]:
        """The f32 baseline (given or evaluated here), the same
        evaluation of the int8 twin, then the tolerance gate."""
        if quantize != "int8":
            raise ValueError(
                f"Unsupported quantize={quantize!r}; only 'int8'")
        from analytics_zoo_tpu_torch.serving.quantization import \
            quantize_model_params
        base = baseline_metrics if baseline_metrics is not None else \
            self.evaluate(data, batch_per_thread=batch_per_thread,
                          metrics=metrics)
        if not self.model.built:
            raise ValueError("Model has no parameters; fit or load first")
        self._on_device()
        quantized = self._evaluate(quantize_model_params(self.model), data,
                                   batch_per_thread, metrics)
        if quality_tolerance is not None:
            # `not (|d| <= tol)`: a NaN metric (an int8 rewrite that
            # overflowed) compares False either way, and the gate refuses
            # what it cannot prove within tolerance
            drifted = {
                name: (base[name], quantized[name])
                for name in quantized
                if name in base
                and not (abs(quantized[name] - base[name])
                         <= quality_tolerance)}
            if drifted:
                detail = ", ".join(
                    f"{n}: f32={b:.6g} int8={q_:.6g} "
                    f"(|Δ|={abs(q_ - b):.6g})"
                    for n, (b, q_) in sorted(drifted.items()))
                raise QuantizationQualityError(
                    f"int8 quantization drifted {len(drifted)} metric(s) "
                    f"past the quality gate (tolerance "
                    f"{quality_tolerance:g}): {detail}. Refusing to "
                    "bless the quantized model; raise the tolerance "
                    "only if this accuracy loss is acceptable, or keep "
                    "serving f32/bf16.")
        out = dict(quantized)
        out.update({f"baseline_{k}": v for k, v in base.items()})
        return out

    # -- persistence (`orca` save/load + load_orca_checkpoint) ------------
    def get_model(self):
        return self.model

    def save(self, path: str) -> str:
        self.model.save_weights(path)
        return path

    def load(self, path: str) -> "Estimator":
        self.model.load_weights(path)
        return self

    def load_orca_checkpoint(self, path: str,
                             version: Optional[int] = None) -> "Estimator":
        """Resume from a `model.<version>` checkpoint
        (`orca/learn/tf/estimator.py:125` semantics; version=None →
        latest): the next `fit` loads its parameters and starts at its
        epoch."""
        self._load_ckpt = (path, version)
        return self
