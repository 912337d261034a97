"""Validation metrics with the reference's compile-string registry.

Port of `analytics_zoo_tpu/ops/metrics.py`: `Metric` (L29), the
accuracies (L52-98, L169), `MAE` (L101), `MSE` (L109), `Loss` (L117), `AUC`
(L133), `get` (L195) and `resolve` (L225). `"accuracy"` / `"acc"` resolve by
the loss string to sparse, categorical or binary accuracy, as
`KerasUtils.toBigDLMetrics` does.

Same accumulator contract: `init() -> state`, `update(state, y_true,
y_pred) -> state`, `compute(state) -> value`, with states dicts of float32
tensors. `update` keeps its sums on the predictions' device, so an
evaluation reads them on the host once, at `compute`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

State = Dict[str, torch.Tensor]


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def _labels(y_true, y_pred) -> torch.Tensor:
    """Integer labels on the predictions' device, a trailing [*, 1] label
    dimension squeezed."""
    labels = torch.as_tensor(y_true, device=y_pred.device).long()
    if labels.dim() == y_pred.dim():
        labels = labels.squeeze(-1)
    return labels


class Metric:
    name = "metric"

    def init(self) -> State:
        return {"total": torch.zeros(()), "count": torch.zeros(())}

    def update(self, state: State, y_true, y_pred) -> State:
        if not isinstance(y_pred, (list, tuple)):   # one output per model
            y_pred = torch.as_tensor(y_pred)
        value, weight = self._batch(y_true, y_pred)
        return {"total": state["total"].to(value.device) + value,
                "count": state["count"].to(value.device) + weight}

    def compute(self, state: State) -> torch.Tensor:
        return state["total"] / torch.clamp(state["count"], min=1.0)

    def _batch(self, y_true, y_pred) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum of the metric over the batch, weight)."""
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


def _hits(hits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _f32(hits).sum(), _f32(hits.numel(), hits.device)


class SparseCategoricalAccuracy(Metric):
    """0-based integer labels against the argmax over the last axis."""
    name = "sparse_categorical_accuracy"

    def _batch(self, y_true, y_pred):
        return _hits(torch.argmax(y_pred, -1) == _labels(y_true, y_pred))


class CategoricalAccuracy(Metric):
    """One-hot labels (`metrics/Accuracy.scala` CategoricalAccuracy)."""
    name = "categorical_accuracy"

    def _batch(self, y_true, y_pred):
        y_true = torch.as_tensor(y_true, device=y_pred.device)
        return _hits(torch.argmax(y_pred, -1) == torch.argmax(y_true, -1))


class BinaryAccuracy(Metric):
    name = "binary_accuracy"

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def _batch(self, y_true, y_pred):
        pred = _f32(y_pred) > self.threshold
        return _hits(pred == (_f32(y_true, y_pred.device) > self.threshold))


class Top5Accuracy(Metric):
    """`ZooTop5Accuracy` (`keras/metrics`)."""
    name = "top5_accuracy"

    def __init__(self, k: int = 5):
        self.k = k

    def _batch(self, y_true, y_pred):
        topk = torch.topk(_f32(y_pred), self.k, dim=-1).indices
        labels = _labels(y_true, y_pred)
        return _hits(torch.any(topk == labels[..., None], dim=-1))


class MAE(Metric):
    name = "mae"

    def _batch(self, y_true, y_pred):
        err = torch.abs(_f32(y_pred) - _f32(y_true, y_pred.device))
        return err.sum(), _f32(err.numel(), err.device)


class MSE(Metric):
    name = "mse"

    def _batch(self, y_true, y_pred):
        err = torch.square(_f32(y_pred) - _f32(y_true, y_pred.device))
        return err.sum(), _f32(err.numel(), err.device)


class Loss(Metric):
    """A loss objective averaged as a validation metric
    (`toBigDLMetrics` "loss")."""
    name = "loss"

    def __init__(self, objective=None):
        from analytics_zoo_tpu_torch.ops import objectives
        self.objective = (objectives.get(objective)
                          if objective is not None
                          else objectives.MeanSquaredError())

    def _batch(self, y_true, y_pred):
        # a multi-output model's batch weighs its rows (the first output's
        # leading dim); the JAX package weighs it by its output count
        # (`jnp.shape` of the tuple), which differs on a short last batch
        first = y_pred[0] if isinstance(y_pred, (list, tuple)) else y_pred
        n = _f32(first.shape[0] if first.dim() else 1, first.device)
        return self.objective(y_true, y_pred) * n, n


class AUC(Metric):
    """Area under the ROC curve by fixed-threshold binning: true and false
    positive counts at `num_thresholds` evenly spaced thresholds,
    integrated by the trapezoid rule at `compute`."""
    name = "auc"

    def __init__(self, num_thresholds: int = 200):
        self.num_thresholds = num_thresholds

    def init(self) -> State:
        z = torch.zeros(self.num_thresholds)
        return {"tp": z, "fp": z.clone(), "pos": torch.zeros(()),
                "neg": torch.zeros(())}

    def update(self, state, y_true, y_pred):
        y_pred = torch.as_tensor(y_pred)
        score = _f32(y_pred).reshape(-1)
        label = _f32(y_true, score.device).reshape(-1) > 0.5
        thr = torch.linspace(0.0, 1.0, self.num_thresholds,
                             device=score.device)
        pred_pos = score[None, :] >= thr[:, None]          # [T, N]
        tp = torch.sum(pred_pos & label[None, :], dim=1)
        fp = torch.sum(pred_pos & ~label[None, :], dim=1)
        st = {k: v.to(score.device) for k, v in state.items()}
        return {"tp": st["tp"] + _f32(tp), "fp": st["fp"] + _f32(fp),
                "pos": st["pos"] + _f32(label).sum(),
                "neg": st["neg"] + _f32(~label).sum()}

    def compute(self, state):
        tpr = state["tp"] / torch.clamp(state["pos"], min=1.0)
        fpr = state["fp"] / torch.clamp(state["neg"], min=1.0)
        return torch.abs(torch.trapezoid(tpr, fpr))


class Accuracy(Metric):
    """Orca's loss-agnostic Accuracy (`orca/learn/metrics.py:26`): picks
    categorical, sparse or binary accuracy by the shapes."""
    name = "accuracy"

    def _batch(self, y_true, y_pred):
        y_true = torch.as_tensor(y_true)
        if (y_true.dim() == y_pred.dim() and y_pred.dim() >= 1
                and y_true.shape[-1] == y_pred.shape[-1]
                and y_pred.shape[-1] > 1):
            return CategoricalAccuracy()._batch(y_true, y_pred)
        if y_pred.dim() >= 2 and y_pred.shape[-1] > 1:
            return SparseCategoricalAccuracy()._batch(y_true, y_pred)
        return BinaryAccuracy()._batch(y_true, y_pred)


# ---------------------------------------------------------------------------
# Registry + loss-aware dispatch (`KerasUtils.scala:218-248`)
# ---------------------------------------------------------------------------
_ACC_BY_LOSS = {
    "sparse_categorical_crossentropy": SparseCategoricalAccuracy,
    "categorical_crossentropy": CategoricalAccuracy,
    "binary_crossentropy": BinaryAccuracy,
}

_TABLE = {
    "top5accuracy": Top5Accuracy,
    "top5acc": Top5Accuracy,
    "mae": MAE,
    "mse": MSE,
    "auc": AUC,
    "loss": Loss,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "categorical_accuracy": CategoricalAccuracy,
    "binary_accuracy": BinaryAccuracy,
}


def get(metric: Any, loss: Optional[str] = None) -> Metric:
    """Resolve one metric string; `"accuracy"` / `"acc"` need the loss
    string for the reference's loss-aware dispatch."""
    if isinstance(metric, Metric):
        return metric
    key = str(metric).lower()
    if key in ("accuracy", "acc"):
        if loss is None:
            return Accuracy()
        loss_key = str(loss).lower()
        if loss_key not in _ACC_BY_LOSS:
            raise ValueError(
                f"Unsupported metric: accuracy and loss: {loss} combination")
        return _ACC_BY_LOSS[loss_key]()
    if key not in _TABLE:
        raise ValueError(f"Unsupported metric: {metric}")
    return _TABLE[key]()


def resolve(metrics: Optional[Sequence[Any]], loss: Optional[str] = None
            ) -> List[Metric]:
    """Resolve a metrics list against a loss, like `toBigDLMetrics`."""
    if metrics is None:
        return []
    return [get(m, loss) for m in metrics]
