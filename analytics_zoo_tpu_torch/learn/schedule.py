"""Learning-rate schedulers.

Port of `analytics_zoo_tpu/learn/schedule.py` (the whole file:
`Scheduler`, `Default`, `Poly`, `Exponential`, `Step`, `MultiStep`,
`Warmup`, `SequentialSchedule`, `Plateau`). Reference:
`pyzoo/zoo/orca/learn/optimizers/schedule.py:19-218`, there thin wrappers
over BigDL SGD schedules.

`make(base_lr)` returns a host function of the integer step count that
returns a float, computed in float32 as the JAX schedules compute it on an
int32 count: the port's optimizers (`ops/optimizers.py`) call it with
their host count, as optax calls the JAX schedule with its state's count.
`Plateau` is feedback-driven (it watches a validation metric), so it stays
a host-side object with `on_metric()`, the same place the reference runs
it (on the host, between epochs).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

f32 = np.float32


class Scheduler:
    def make(self, base_lr: float) -> Callable[[int], float]:
        raise NotImplementedError


class Default(Scheduler):
    """`schedule.py:89`: constant lr."""

    def make(self, base_lr):
        return lambda step: base_lr


class Poly(Scheduler):
    """`schedule.py:26`: lr · (1 − iter/max_iteration)^power."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def make(self, base_lr):
        def fn(step):
            frac = np.clip(f32(step) / f32(self.max_iteration), f32(0.0),
                           f32(1.0))
            return float(f32(base_lr) * (f32(1.0) - frac) ** f32(self.power))
        return fn


class Exponential(Scheduler):
    """`schedule.py:47`: lr · decay_rate^(iter/decay_step)."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.stair_case = stair_case

    def make(self, base_lr):
        def fn(step):
            p = f32(step) / f32(self.decay_step)
            if self.stair_case:
                p = np.floor(p)
            return float(f32(base_lr) * f32(self.decay_rate) ** p)
        return fn


class Step(Scheduler):
    """`schedule.py:67`: lr · gamma^floor(iter/step_size)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def make(self, base_lr):
        return lambda step: float(f32(base_lr) * f32(self.gamma) ** np.floor(
            f32(step) / f32(self.step_size)))


class MultiStep(Scheduler):
    """`schedule.py:167`: gamma applied at each milestone."""

    def __init__(self, step_sizes: Sequence[int], gamma: float):
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def make(self, base_lr):
        milestones = np.asarray(self.step_sizes)

        def fn(step):
            n = int(np.sum(step >= milestones))
            return float(f32(base_lr) * f32(self.gamma) ** f32(n))
        return fn


class Warmup(Scheduler):
    """`schedule.py:147`: lr grows by `delta` per iteration (used as a
    SequentialSchedule stage)."""

    def __init__(self, delta: float):
        self.delta = delta

    def make(self, base_lr):
        return lambda step: float(f32(base_lr) + f32(self.delta) * f32(step))


class SequentialSchedule(Scheduler):
    """`schedule.py:188`: chain stages, each active for `max_iteration`
    steps. `add(scheduler, max_iteration)` mirrors the reference; each
    stage's step counter restarts at 0."""

    def __init__(self, iteration_per_epoch: int = 1):
        self.iteration_per_epoch = iteration_per_epoch
        self.stages: List[Tuple[Scheduler, int]] = []

    def add(self, scheduler: Scheduler, max_iteration: int
            ) -> "SequentialSchedule":
        self.stages.append((scheduler, max_iteration))
        return self

    def make(self, base_lr):
        if not self.stages:
            return lambda step: base_lr
        fns = [s.make(base_lr) for s, _ in self.stages]
        bounds = np.cumsum([m for _, m in self.stages])

        def fn(step):
            for i in range(len(fns) - 1):
                if step < bounds[i]:
                    return fns[i](step - (bounds[i - 1] if i > 0 else 0))
            return fns[-1](step - (bounds[-2] if len(bounds) > 1 else 0))
        return fn


class Plateau:
    """`schedule.py:109`: reduce lr when a monitored metric stops
    improving. Host-side: call `on_metric(value)` after each epoch/eval;
    read `.lr` for the current value (rebuild the optimizer with it — the
    reference likewise mutates it on the host)."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min",
                 epsilon: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0, base_lr: float = 0.01):
        if mode not in ("min", "max"):
            raise ValueError(f"Unsupported mode: {mode}")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.lr = base_lr
        self._best: Optional[float] = None
        self._wait = 0
        self._cooling = 0

    def _improved(self, value: float) -> bool:
        if self._best is None:
            return True
        if self.mode == "min":
            return value < self._best - self.epsilon
        return value > self._best + self.epsilon

    def on_metric(self, value: float) -> float:
        """Update state with the latest monitored value; returns lr."""
        if self._cooling > 0:
            self._cooling -= 1
            self._wait = 0
        if self._improved(value):
            self._best = value
            self._wait = 0
        elif self._cooling == 0:
            self._wait += 1
            if self._wait > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self._cooling = self.cooldown
                self._wait = 0
        return self.lr
