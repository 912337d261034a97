"""Estimator — the unified training façade, single device.

Port of `analytics_zoo_tpu/learn/estimator.py`: `Estimator.__init__`
(L79), `from_keras` (L89) and `fit` (L160), and from `to_dataset` (L56)
the in-memory forms `TPUDataset.from_ndarrays` takes: `{"x": ..., "y":
...}`, `(x, y)` or a bare x. The JAX `fit` wraps the trainer in a
retry-and-restore loop over `model_dir` checkpoints; the port has no
checkpoints yet, so `model_dir` is refused and a failure raises
(ROADMAP.md queue 1).

`device`: where `fit` trains; `None` is `cuda`, and asking for `cuda`
without a GPU raises. The model is moved there in place before training.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.learn import trainer
from analytics_zoo_tpu_torch.ops.optimizers import NOT_PORTED_QUEUE


def to_dataset(data):
    """`(x, y)` from the in-memory forms of `TPUDataset.from_ndarrays`."""
    if isinstance(data, dict):
        return data["x"], data.get("y")
    if isinstance(data, (tuple, list)) and len(data) == 2:
        return data[0], data[1]
    if isinstance(data, (np.ndarray, tuple, list)):
        return data, None
    raise NotImplementedError(
        f"Estimator.fit takes in-memory arrays ({{'x': ..., 'y': ...}}, "
        f"(x, y) or x); {type(data).__name__} is not ported yet "
        f"({NOT_PORTED_QUEUE})")


class Estimator:
    """Unified estimator façade (`orca/learn/base_estimator.py:43`)."""

    def __init__(self, model, model_dir: Optional[str] = None,
                 device: DeviceLike = None):
        if model_dir is not None:
            raise NotImplementedError(
                "Estimator(model_dir=...) needs checkpoints, which are not "
                f"ported yet ({NOT_PORTED_QUEUE})")
        self.model = model
        self.model_dir = None
        self.device = device

    @staticmethod
    def from_keras(keras_model, model_dir: Optional[str] = None,
                   optimizer=None, loss=None, metrics=None,
                   device: DeviceLike = None) -> "Estimator":
        """The model may already be compiled; compile args given here
        override."""
        if optimizer is not None or loss is not None:
            keras_model.compile(optimizer or "adam", loss or "mse", metrics)
        return Estimator(keras_model, model_dir, device)

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            validation_data=None, checkpoint_trigger=None,
            feature_cols=None, label_cols=None, seed: int = 0,
            **fit_kwargs) -> Dict[str, List[float]]:
        """Train on `data` for `epochs`; `fit_kwargs` pass through to
        `learn.trainer.fit_keras` (`mixed_precision=True` runs bf16
        compute with f32 masters, `fused_optimizer=True` swaps a stock
        adam/adamw for the fused-Adam kernel). Returns the history."""
        device = resolve_device(self.device)
        if feature_cols is not None or label_cols is not None:
            raise NotImplementedError(
                "feature_cols/label_cols (DataFrame input) are not ported "
                f"yet ({NOT_PORTED_QUEUE})")
        x, y = to_dataset(data)
        self.model.to(device)
        return trainer.fit_keras(
            self.model, x, y, batch_size=batch_size or 32, epochs=epochs,
            validation_data=validation_data, shuffle=True,
            checkpoint_trigger=checkpoint_trigger, seed=seed, **fit_kwargs)
