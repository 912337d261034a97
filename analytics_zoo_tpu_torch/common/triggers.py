"""Training triggers — the `ZooTrigger` / BigDL `Trigger` family.

Copied from `analytics_zoo_tpu/common/triggers.py` as it is (`TriggerState`
L16, `Trigger.from_string` L30, `EveryEpoch`, `SeveralIteration`,
`MaxEpoch`, `MaxIteration`, `MinLoss`, `MaxScore`, `And`, `Or`): the JAX
module imports no jax, but importing it loads the JAX package.

The reference gates epochs, validation, and checkpoints on trigger objects
(`zoo/.../common/ZooTrigger.scala`, used by `Topology.scala:354-365` and
`orca/learn/trigger.py:76`). Each trigger is evaluated against an immutable
`TriggerState` snapshot of the loop's counters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class TriggerState:
    """Loop counters a trigger may inspect."""
    epoch: int = 0            # completed epochs
    iteration: int = 0        # completed global steps
    loss: float = float("inf")
    score: float = float("-inf")
    epoch_finished: bool = False


class Trigger:
    def __call__(self, state: TriggerState) -> bool:
        raise NotImplementedError

    @staticmethod
    def from_string(spec: str) -> "Trigger":
        """Parse 'every_epoch' / 'max_epoch:10' / 'several_iteration:3' specs
        (string forms of orca's python trigger layer, `orca/learn/trigger.py`)."""
        s = spec.strip().lower().replace(" ", ":")
        if s in ("every_epoch", "everyepoch"):
            return EveryEpoch()
        name, _, arg = s.partition(":")
        table = {
            "max_epoch": MaxEpoch, "maxepoch": MaxEpoch,
            "max_iteration": MaxIteration, "maxiteration": MaxIteration,
            "several_iteration": SeveralIteration,
            "severaliteration": SeveralIteration,
        }
        if name in table and arg:
            return table[name](int(arg))
        raise ValueError(f"Cannot parse trigger spec: {spec!r}")


class EveryEpoch(Trigger):
    """Fires at each epoch boundary (`ZooTrigger.scala` EveryEpoch)."""

    def __call__(self, state: TriggerState) -> bool:
        return state.epoch_finished


class SeveralIteration(Trigger):
    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.interval = interval

    def __call__(self, state: TriggerState) -> bool:
        return state.iteration > 0 and state.iteration % self.interval == 0


class MaxEpoch(Trigger):
    """End-when trigger: stop after `max` epochs."""

    def __init__(self, max_epoch: int):
        self.max_epoch = max_epoch

    def __call__(self, state: TriggerState) -> bool:
        return state.epoch >= self.max_epoch


class MaxIteration(Trigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = max_iteration

    def __call__(self, state: TriggerState) -> bool:
        return state.iteration >= self.max_iteration


class MinLoss(Trigger):
    def __init__(self, min_loss: float):
        self.min_loss = min_loss

    def __call__(self, state: TriggerState) -> bool:
        return state.loss < self.min_loss


class MaxScore(Trigger):
    def __init__(self, max_score: float):
        self.max_score = max_score

    def __call__(self, state: TriggerState) -> bool:
        return state.score > self.max_score


class And(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers: Sequence[Trigger] = triggers

    def __call__(self, state: TriggerState) -> bool:
        return all(t(state) for t in self.triggers)


class Or(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers: Sequence[Trigger] = triggers

    def __call__(self, state: TriggerState) -> bool:
        return any(t(state) for t in self.triggers)
