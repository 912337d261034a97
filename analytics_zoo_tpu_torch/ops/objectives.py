"""Loss objectives with the compile-string registry.

Port of `analytics_zoo_tpu/ops/objectives.py`: `Objective`, `_f32`,
`_align` (L33), `MeanSquaredError` (L55), `BinaryCrossEntropy` (L82),
`CategoricalCrossEntropy` (L98), `SparseCategoricalCrossEntropy` (L114)
and `get` (L208). Same conventions: reduction is the mean over the batch,
computed in float32 whatever the input dtype; probability-space
crossentropies by default, `from_logits=True` fuses the softmax/sigmoid;
sparse labels are 0-based integers. The other registry strings raise
NotImplementedError until they are ported; unknown strings raise
ValueError, as the reference does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from analytics_zoo_tpu_torch.ops.optimizers import NOT_PORTED_QUEUE

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


_REGISTRY: Dict[str, Callable[..., Objective]] = {
    "binary_crossentropy": BinaryCrossEntropy,
    "categorical_crossentropy": CategoricalCrossEntropy,
    "mse": MeanSquaredError,
    "mean_squared_error": MeanSquaredError,
    "sparse_categorical_crossentropy": SparseCategoricalCrossEntropy,
}
# The JAX registry's other strings (`KerasUtils.scala:180-203`).
_NOT_PORTED = ("mae", "mean_absolute_error", "hinge", "mape",
               "mean_absolute_percentage_error", "msle",
               "mean_squared_logarithmic_error", "squared_hinge", "kld",
               "kullback_leibler_divergence", "cosine_proximity", "poisson",
               "rank_hinge")


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
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"loss {loss!r} is not ported yet ({NOT_PORTED_QUEUE})")
    if key not in _REGISTRY:
        raise ValueError(f"Unsupported loss: {loss}")
    return _REGISTRY[key](**kwargs)
