"""Orca metric names (`pyzoo/zoo/orca/learn/metrics.py:26-156`) — thin
wrappers over `analytics_zoo_tpu_torch.ops.metrics` keeping the exact
class-name surface users import from `zoo.orca.learn.metrics`.

Port of `analytics_zoo_tpu/learn/metrics.py`."""

from analytics_zoo_tpu_torch.ops.metrics import (  # noqa: F401
    AUC, MAE, MSE, Accuracy, BinaryAccuracy, CategoricalAccuracy,
    SparseCategoricalAccuracy, Top5Accuracy)

__all__ = ["Accuracy", "SparseCategoricalAccuracy", "CategoricalAccuracy",
           "BinaryAccuracy", "Top5Accuracy", "MAE", "MSE", "AUC"]
