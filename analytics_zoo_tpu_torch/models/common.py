"""ZooModel — the shared plumbing of the built-in model zoo.

Port of `analytics_zoo_tpu/models/common.py`: `ZooModel` (L21) with its
Keras passthroughs `compile`, `fit`, `evaluate`, `predict` and
`predict_classes`. A ZooModel wraps a constructed Keras-style model
(`self.model`, a functional `Model` or a `Sequential`) and its
hyperparameters (`self._config`). What still waits: persistence
(`save_model` / `load_model`) and `summary`, which raise
NotImplementedError naming ROADMAP.md queue 1, item 2.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.keras.engine import KerasNet

PERSISTENCE_NOT_PORTED = ("ZooModel save/load and summary are not ported "
                          "yet (ROADMAP.md queue 1, item 2)")


class ZooModel:
    """Base: subclasses set `self.model` (a KerasNet) in `build_model()` and
    record their constructor arguments in `self._config`."""

    def __init__(self):
        self.model: Optional[KerasNet] = None
        self._config: Dict[str, Any] = {}

    def compile(self, optimizer, loss, metrics=None):
        self.model.compile(optimizer, loss, metrics)

    def fit(self, x, y=None, batch_size=32, nb_epoch=1, **kw):
        return self.model.fit(x, y, batch_size=batch_size, nb_epoch=nb_epoch,
                              **kw)

    def evaluate(self, x, y=None, batch_per_thread=32, **kw):
        return self.model.evaluate(x, y, batch_per_thread=batch_per_thread,
                                   **kw)

    def predict(self, x, batch_per_thread=32, **kw):
        return self.model.predict(x, batch_per_thread=batch_per_thread, **kw)

    def predict_classes(self, x, batch_per_thread=32, zero_based_label=True):
        """The argmax over the class axis; the reference's labels are
        1-based by default."""
        probs = self.predict(x, batch_per_thread=batch_per_thread)
        cls = np.argmax(probs, axis=-1)
        return cls if zero_based_label else cls + 1

    def summary(self):
        raise NotImplementedError(PERSISTENCE_NOT_PORTED)

    def save_model(self, path: str, over_write: bool = False):
        raise NotImplementedError(PERSISTENCE_NOT_PORTED)

    @classmethod
    def load_model(cls, path: str) -> "ZooModel":
        raise NotImplementedError(PERSISTENCE_NOT_PORTED)
