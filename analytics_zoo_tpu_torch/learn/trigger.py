"""Orca trigger names (`pyzoo/zoo/orca/learn/trigger.py:76`) — re-exports of
the shared trigger family.

Port of `analytics_zoo_tpu/learn/trigger.py`."""

from analytics_zoo_tpu_torch.common.triggers import (  # noqa: F401
    EveryEpoch, MaxEpoch, MaxIteration, MaxScore, MinLoss, SeveralIteration)

__all__ = ["EveryEpoch", "SeveralIteration", "MaxEpoch", "MaxIteration",
           "MinLoss", "MaxScore"]
