"""Loss objectives with the compile-string registry.

Port of `analytics_zoo_tpu/ops/objectives.py` (the whole file):
`Objective`, `_f32`, `_align` (L33), `MeanSquaredError` (L55),
`MeanAbsoluteError`, `MeanAbsolutePercentageError`,
`MeanSquaredLogarithmicError`, `BinaryCrossEntropy` (L82),
`CategoricalCrossEntropy` (L98), `SparseCategoricalCrossEntropy` (L114),
`Hinge`, `SquaredHinge`, `RankHinge` (L146), `KullbackLeiblerDivergence`,
`Poisson`, `CosineProximity`, the registry (L187-204) and `get` (L208).
Same conventions: reduction is the mean over the batch, computed in
float32 whatever the input dtype; probability-space crossentropies by
default, `from_logits=True` fuses the softmax/sigmoid; sparse labels are
0-based integers; hinge losses expect targets in {-1, 1}. Unknown strings
raise ValueError, as the reference does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

EPS = 1e-7


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _align(y_true, y_pred):
    """Align a rank-off-by-one target with a trailing size-1 prediction dim
    (or vice versa), so `[B] - [B, 1]` never broadcasts to `[B, B]`."""
    y_pred = _f32(y_pred)
    y_true = _f32(y_true).to(y_pred.device)
    if y_true.dim() == y_pred.dim() - 1 and y_pred.shape[-1] == 1:
        y_true = y_true[..., None]
    elif y_pred.dim() == y_true.dim() - 1 and y_true.shape[-1] == 1:
        y_pred = y_pred[..., None]
    return y_true, y_pred


class Objective:
    """Base class: a callable loss(y_true, y_pred) -> scalar."""

    def __call__(self, y_true, y_pred) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class MeanSquaredError(Objective):
    def __call__(self, y_true, y_pred):
        y_true, y_pred = _align(y_true, y_pred)
        return torch.mean(torch.square(y_pred - y_true))


class MeanAbsoluteError(Objective):
    def __call__(self, y_true, y_pred):
        y_true, y_pred = _align(y_true, y_pred)
        return torch.mean(torch.abs(y_pred - y_true))


class MeanAbsolutePercentageError(Objective):
    def __call__(self, y_true, y_pred):
        y_true, y_pred = _align(y_true, y_pred)
        diff = torch.abs(y_pred - y_true) / torch.clamp(torch.abs(y_true),
                                                         min=EPS)
        return 100.0 * torch.mean(diff)


class MeanSquaredLogarithmicError(Objective):
    def __call__(self, y_true, y_pred):
        y_true, y_pred = _align(y_true, y_pred)
        a = torch.log1p(torch.clamp(y_pred, min=EPS))
        b = torch.log1p(torch.clamp(y_true, min=EPS))
        return torch.mean(torch.square(a - b))


class BinaryCrossEntropy(Objective):
    def __init__(self, from_logits: bool = False):
        self.from_logits = from_logits

    def __call__(self, y_true, y_pred):
        y_true, y_pred = _align(y_true, y_pred)
        if self.from_logits:
            # stable: max(x,0) - x*y + log1p(exp(-|x|))
            x = y_pred
            per = (torch.clamp(x, min=0) - x * y_true
                   + torch.log1p(torch.exp(-torch.abs(x))))
        else:
            p = torch.clamp(y_pred, EPS, 1.0 - EPS)
            per = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log1p(-p))
        return torch.mean(per)


class CategoricalCrossEntropy(Objective):
    """One-hot targets over the last axis."""

    def __init__(self, from_logits: bool = False):
        self.from_logits = from_logits

    def __call__(self, y_true, y_pred):
        y_true, y_pred = _align(y_true, y_pred)
        if self.from_logits:
            logp = torch.log_softmax(y_pred, dim=-1)
        else:
            p = y_pred / torch.clamp(y_pred.sum(-1, keepdim=True), min=EPS)
            logp = torch.log(torch.clamp(p, EPS, 1.0))
        return torch.mean(-torch.sum(y_true * logp, dim=-1))


class SparseCategoricalCrossEntropy(Objective):
    """Integer (0-based) class labels."""

    def __init__(self, from_logits: bool = False):
        self.from_logits = from_logits

    def __call__(self, y_true, y_pred):
        y_pred = _f32(y_pred)
        labels = torch.as_tensor(y_true, device=y_pred.device).long()
        if labels.dim() == y_pred.dim():  # squeeze a trailing [*, 1] dim
            labels = labels.squeeze(-1)
        if self.from_logits:
            logp = torch.log_softmax(y_pred, dim=-1)
        else:
            logp = torch.log(torch.clamp(y_pred, EPS, 1.0))
        picked = torch.gather(logp, -1, labels[..., None])[..., 0]
        return torch.mean(-picked)


class Hinge(Objective):
    def __call__(self, y_true, y_pred):
        y_true, y_pred = _align(y_true, y_pred)
        return torch.mean(torch.clamp(1.0 - y_true * y_pred, min=0.0))


class SquaredHinge(Objective):
    def __call__(self, y_true, y_pred):
        y_true, y_pred = _align(y_true, y_pred)
        return torch.mean(torch.square(
            torch.clamp(1.0 - y_true * y_pred, min=0.0)))


class RankHinge(Objective):
    """Pairwise ranking hinge for text matching (`objectives/RankHinge.scala`):
    batch rows alternate positive/negative samples; loss =
    max(0, margin - (score_pos - score_neg)) per pair."""

    def __init__(self, margin: float = 1.0):
        self.margin = margin

    def __call__(self, y_true, y_pred):
        del y_true  # ordering carries the supervision
        s = _f32(y_pred).reshape(-1)
        pos, neg = s[0::2], s[1::2]
        return torch.mean(torch.clamp(self.margin - pos + neg, min=0.0))


class KullbackLeiblerDivergence(Objective):
    def __call__(self, y_true, y_pred):
        y_pred = torch.clamp(_f32(y_pred), EPS, 1.0)
        y_true = torch.clamp(_f32(y_true).to(y_pred.device), EPS, 1.0)
        return torch.mean(torch.sum(y_true * torch.log(y_true / y_pred),
                                    dim=-1))


class Poisson(Objective):
    def __call__(self, y_true, y_pred):
        y_true, y_pred = _align(y_true, y_pred)
        return torch.mean(y_pred - y_true * torch.log(y_pred + EPS))


class CosineProximity(Objective):
    def __call__(self, y_true, y_pred):
        y_pred = _f32(y_pred)
        y_true = _f32(y_true).to(y_pred.device)
        t = y_true / torch.clamp(torch.linalg.norm(y_true, dim=-1,
                                                   keepdim=True), min=EPS)
        p = y_pred / torch.clamp(torch.linalg.norm(y_pred, dim=-1,
                                                   keepdim=True), min=EPS)
        return -torch.mean(torch.sum(t * p, dim=-1))


# Registry — exact strings of `KerasUtils.toBigDLCriterion`
# (`KerasUtils.scala:180-203`).
_REGISTRY: Dict[str, Callable[..., Objective]] = {
    "binary_crossentropy": BinaryCrossEntropy,
    "categorical_crossentropy": CategoricalCrossEntropy,
    "mse": MeanSquaredError,
    "mean_squared_error": MeanSquaredError,
    "mae": MeanAbsoluteError,
    "mean_absolute_error": MeanAbsoluteError,
    "hinge": Hinge,
    "mape": MeanAbsolutePercentageError,
    "mean_absolute_percentage_error": MeanAbsolutePercentageError,
    "msle": MeanSquaredLogarithmicError,
    "mean_squared_logarithmic_error": MeanSquaredLogarithmicError,
    "squared_hinge": SquaredHinge,
    "sparse_categorical_crossentropy": SparseCategoricalCrossEntropy,
    "kld": KullbackLeiblerDivergence,
    "kullback_leibler_divergence": KullbackLeiblerDivergence,
    "cosine_proximity": CosineProximity,
    "poisson": Poisson,
    "rank_hinge": RankHinge,
}


def get(loss: Any, **kwargs) -> Objective:
    """Resolve a loss from its compile string (or pass an Objective, such
    as an `ops/autograd.CustomLoss`, or a plain callable through)."""
    if isinstance(loss, Objective):
        return loss
    if callable(loss):
        wrapped = loss

        class _Fn(Objective):
            def __call__(self, y_true, y_pred):
                return wrapped(y_true, y_pred)
        return _Fn()
    key = str(loss).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unsupported loss: {loss}")
    return _REGISTRY[key](**kwargs)
