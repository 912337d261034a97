"""ZooModel — the shared plumbing of the built-in model zoo.

Port of `analytics_zoo_tpu/models/common.py`: `ZooModel` (L21) with its
Keras passthroughs `compile`, `fit`, `evaluate`, `predict` and
`predict_classes`, `summary` and persistence (`_save_config`,
`save_model`, `load_model`, L51-90). A ZooModel wraps a constructed
Keras-style model (`self.model`, a functional `Model` or a `Sequential`)
and its hyperparameters (`self._config`).

A saved model is the JAX package's directory: `config.json` (`{"class":
<class name>, "config": <constructor arguments>}`, no device in it) and
the weights artifact `weights.npz`, `weights.structure.json` and
`weights.layers.json` (`KerasNet.save_weights`). So a model saved by either
package loads in the other. `load_model(path, device=None)` builds the
model on the card unless the caller passes `device="cpu"`.

`set_checkpoint` (JAX L92) hands the directory to the wrapped model, whose
`fit` then writes training checkpoints there (`learn/checkpoint.py`), and
`set_tensorboard` (JAX L95) its TensorBoard directory, where `fit` writes
its summaries (`utils/tensorboard.py`).

`Ranker` (JAX L99-155) is the JAX class copied as it is: numpy only,
NDCG@k and MAP over per-query candidate lists, scored through the model's
`predict`.

Not ported yet: `save_model_encrypted` (`learn/encrypted.py`, ROADMAP.md
queue 1, item 8); it raises NotImplementedError.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras.engine import KerasNet


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

    def summary(self) -> str:
        return self.model.summary()

    # -- persistence -------------------------------------------------------
    def _save_config(self, path: str, over_write: bool) -> None:
        """The config-json step of `save_model`."""
        os.makedirs(path, exist_ok=True)
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path) and not over_write:
            raise FileExistsError(f"{path} exists; pass over_write=True")
        with open(cfg_path, "w") as fh:
            json.dump({"class": type(self).__name__,
                       "config": self._config}, fh)

    def save_model(self, path: str, over_write: bool = False) -> None:
        """`ZooModel.saveModel`: config json + weights."""
        self._save_config(path, over_write)
        self.model.save_weights(os.path.join(path, "weights"))

    def save_model_encrypted(self, path: str, secret: str, salt: str,
                             over_write: bool = False):
        raise NotImplementedError(
            "save_model_encrypted needs learn/encrypted.py, which is not "
            "ported yet (ROADMAP.md queue 1, item 8)")

    @classmethod
    def load_model(cls, path: str, device: DeviceLike = None) -> "ZooModel":
        """A model saved by `save_model` (of either package), built on
        `device` (None is `cuda`) with its saved weights."""
        with open(os.path.join(path, "config.json")) as fh:
            blob = json.load(fh)
        if blob["class"] != cls.__name__:
            raise ValueError(
                f"Checkpoint is a {blob['class']}, not {cls.__name__}")
        inst = cls(**blob["config"], device=device)
        inst.model.load_weights(os.path.join(path, "weights"))
        return inst

    def set_checkpoint(self, path: str):
        self.model.set_checkpoint(path)

    def set_tensorboard(self, log_dir: str, app_name: str):
        self.model.set_tensorboard(log_dir, app_name)


# Copied from `analytics_zoo_tpu/models/common.py` L99-155 (numpy only).
class Ranker:
    """Ranking-evaluation mixin (`models/common/Ranker.scala`): NDCG@k and
    MAP over per-query candidate lists. A "query" is one (x, y) pair where
    `x` is the model input for that query's candidates and `y` their
    relevance labels; metrics average over queries."""

    @staticmethod
    def ndcg_score(y_true, y_pred, k: int, threshold: float = 0.0) -> float:
        """One query (`Ranker.scala:113-146`): DCG over the top-k by
        predicted score / ideal DCG over the top-k by label, with gains
        2^g and only g > threshold contributing."""
        if k <= 0:
            raise ValueError(f"k for NDCG should be positive, got {k}")
        y_true = np.ravel(np.asarray(y_true, np.float64))
        y_pred = np.ravel(np.asarray(y_pred, np.float64))
        denom = np.log(2.0 + np.arange(len(y_true)))
        by_label = np.sort(y_true)[::-1][:k]
        idcg = float(np.sum(np.where(by_label > threshold,
                                     2.0 ** by_label, 0.0)
                            / denom[:len(by_label)]))
        by_pred = y_true[np.argsort(-y_pred)][:k]
        dcg = float(np.sum(np.where(by_pred > threshold,
                                    2.0 ** by_pred, 0.0)
                           / denom[:len(by_pred)]))
        return 0.0 if idcg == 0.0 else dcg / idcg

    @staticmethod
    def map_score(y_true, y_pred, threshold: float = 0.0) -> float:
        """One query (`Ranker.scala:148-173`): mean average precision —
        precision accumulated at each relevant (> threshold) position of
        the score-sorted list."""
        y_true = np.ravel(np.asarray(y_true, np.float64))
        y_pred = np.ravel(np.asarray(y_pred, np.float64))
        order = np.argsort(-y_pred)
        s, ipos = 0.0, 0
        for i, g in enumerate(y_true[order]):
            if g > threshold:
                ipos += 1
                s += ipos / (i + 1.0)
        return 0.0 if ipos == 0 else s / ipos

    def evaluate_ndcg(self, queries, k: int, threshold: float = 0.0,
                      batch_per_thread: int = 32) -> float:
        """`evaluateNDCG`: mean NDCG@k over `queries` =
        iterable of (x_candidates, y_relevance)."""
        vals = [self.ndcg_score(y, self.predict(
            x, batch_per_thread=batch_per_thread), k, threshold)
            for x, y in queries]
        return float(np.mean(vals)) if vals else 0.0

    def evaluate_map(self, queries, threshold: float = 0.0,
                     batch_per_thread: int = 32) -> float:
        """`evaluateMAP`: mean MAP over per-query candidate lists."""
        vals = [self.map_score(y, self.predict(
            x, batch_per_thread=batch_per_thread), threshold)
            for x, y in queries]
        return float(np.mean(vals)) if vals else 0.0
