"""Optimizers and learning-rate schedules, with the compile-string
registry.

Port of `analytics_zoo_tpu/ops/optimizers.py`: `warmup_linear_decay`
(L28), `fixed` (L58), `adam_weight_decay` (L66), `FusedAdamState` (L91),
`FusedGradientTransformation` (L104), `fused_adam` (L119), `_FUSED_EQUIV`
(L173), `as_fused` (L182) and `get` (L208).

The JAX package builds its optimizers from optax; the port writes its own
Adam/AdamW with the same contract — `init(params) -> state`,
`update(grads, state, params) -> (updates, state)`, updates applied as
`p + u` — and optax's arithmetic step by step (`scale_by_adam`,
`add_decayed_weights`, `scale_by_learning_rate`): moments in the param
dtype, bias correction `1 - β^t` formed in f32, `lr` negated and cast to
the update's dtype. Parameter trees are dicts of tensors keyed by state-dict
name. `fused_adam(...)` adds `fused_apply`, which runs the fused-Adam kernel
(`kernels/fused_adam.py`) over every leaf in place.

Schedules are host functions of the integer step count returning a float,
computed in float32 as the JAX schedules compute them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.kernels.fused_adam import fused_adam_step

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]

NOT_PORTED_QUEUE = "ROADMAP.md queue 1, 'The rest of training'"


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------
def warmup_linear_decay(lr: float, total_steps: int,
                        warmup_portion: float = -1.0) -> Schedule:
    """The reference's `warmupMethod`: with x = step/total,
    lr_factor = x/warmup while x < warmup, else 1 - x (linear decay to zero
    at `total`). warmup_portion=-1 → no warmup, constant."""
    if warmup_portion is None or warmup_portion < 0:
        return fixed(lr)
    f32 = np.float32

    def schedule(step: int) -> float:
        x = f32(step) / f32(total_steps)
        factor = x / f32(warmup_portion) if x < f32(warmup_portion) \
            else f32(1.0) - x
        return float(f32(lr) * factor)
    return schedule


def fixed(lr: float) -> Schedule:
    """`Fixed` schedule (`common/Optim.scala:29`): lr at every step."""
    return lambda step: float(np.float32(lr))


def _lr_at(learning_rate: LearningRate, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) \
        else learning_rate


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------
class FusedAdamState(NamedTuple):
    """(count, mu, nu), field for field the JAX `FusedAdamState` and
    optax's `ScaleByAdamState`; the plain Adam keeps the same state.
    `count` is a host int (schedules read it without a device sync)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class FusedGradientTransformation(NamedTuple):
    """An (init, update) pair plus the fused fast path
    `fused_apply(grads, state, params) -> (params, state)`: the kernel
    writes the parameters and moments in place and no updates tree
    exists."""

    init: Callable
    update: Callable
    fused_apply: Callable


def _adam(learning_rate: LearningRate, b1: float, b2: float, eps: float,
          weight_decay: Optional[float]) -> GradientTransformation:
    """optax.adam (weight_decay None) or optax.adamw, eps_root 0, no
    mask, moments in the param dtype."""
    f32 = np.float32

    def init_fn(params):
        return FusedAdamState(
            0, {n: torch.zeros_like(p) for n, p in params.items()},
            {n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update_fn(grads, state, params=None):
        if weight_decay is not None and params is None:
            raise ValueError("adamw needs the params: call "
                             "update(grads, state, params)")
        count = state.count + 1
        bc1 = float(f32(1.0) - f32(b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(b2) ** f32(count))
        step = -float(f32(_lr_at(learning_rate, state.count)))
        updates = {}
        for name, g in grads.items():
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            mu_hat = mu / torch.tensor(bc1, dtype=torch.float32).to(mu.dtype)
            nu_hat = nu / torch.tensor(bc2, dtype=torch.float32).to(nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + eps)
            if weight_decay is not None:
                u = u + weight_decay * params[name]
            updates[name] = u * torch.tensor(step, dtype=u.dtype)
        return updates, FusedAdamState(count, state.mu, state.nu)

    return GradientTransformation(init_fn, update_fn)


def adam(learning_rate: LearningRate = 1e-3, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """optax.adam."""
    return _adam(learning_rate, b1, b2, eps, None)


def adamw(learning_rate: LearningRate = 1e-3, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw (decoupled weight decay)."""
    return _adam(learning_rate, b1, b2, eps, weight_decay)


def adam_weight_decay(lr: float = 1e-3,
                      warmup_portion: float = -1.0,
                      total_steps: int = -1,
                      schedule: str = "linear",
                      beta1: float = 0.9,
                      beta2: float = 0.999,
                      epsilon: float = 1e-6,
                      weight_decay: float = 0.01,
                      mask: Optional[Any] = None) -> GradientTransformation:
    """BERT AdamWeightDecay: decoupled weight decay 0.01, eps 1e-6, linear
    warmup over `warmup_portion` of `total_steps` then linear decay to
    zero. No fused twin, as in the JAX package: the schedule lives in a
    closure that `as_fused` must not guess at."""
    if schedule != "linear":
        raise ValueError(f"Unsupported warmup schedule: {schedule}")
    if mask is not None:
        raise NotImplementedError(
            f"adam_weight_decay(mask=...) is not ported yet "
            f"({NOT_PORTED_QUEUE})")
    if total_steps > 0:
        sched = warmup_linear_decay(lr, total_steps, warmup_portion)
    else:
        sched = fixed(lr)
    return adamw(sched, b1=beta1, b2=beta2, eps=epsilon,
                 weight_decay=weight_decay)


def fused_adam(learning_rate: LearningRate = 1e-3, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0) -> FusedGradientTransformation:
    """Adam/AdamW as one fused-kernel launch over every leaf
    (`kernels/fused_adam.py`): read (grad, m, v, param), write (m, v,
    param) in place, bias correction folded, decoupled weight decay, f32
    moments with f32/bf16 params. `learning_rate` may be a float or a
    schedule (called with the pre-increment step count)."""

    def init_fn(params):
        # moments in each param's memory format (a channels_last conv
        # kernel's too), which the kernel walks as one flat array
        return FusedAdamState(
            0,
            {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()},
            {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()})

    def fused_apply(grads, state, params):
        if params is None:
            raise ValueError(
                "fused_adam is a params-aware transformation; call "
                "fused_apply(grads, state, params) with the parameters")
        count = state.count + 1
        fused_adam_step(params, state.mu, state.nu, grads, count,
                        lr=_lr_at(learning_rate, state.count), b1=b1, b2=b2,
                        eps=eps, weight_decay=weight_decay)
        return params, FusedAdamState(count, state.mu, state.nu)

    @torch.no_grad()
    def update_fn(grads, state, params=None):
        """The optax contract: returns updates (new − old) and leaves the
        params untouched, at the cost of one copy of them."""
        if params is None:
            raise ValueError("fused_adam.update needs the params")
        new = {n: p.clone() for n, p in params.items()}
        _, state = fused_apply(grads, state, new)
        return {n: new[n] - params[n] for n in params}, state

    return FusedGradientTransformation(init_fn, update_fn, fused_apply)


# String spec → fused equivalent: exactly the hyperparameters the registry
# entry would have compiled, so toggling `fused_optimizer` changes the
# kernels, never the math.
_FUSED_EQUIV: Dict[str, Callable[[], FusedGradientTransformation]] = {
    "adam": lambda: fused_adam(learning_rate=0.001),
    "adamw": lambda: fused_adam(learning_rate=0.001, eps=1e-6,
                                weight_decay=0.01),
    "adam_weight_decay": lambda: fused_adam(learning_rate=0.001, eps=1e-6,
                                            weight_decay=0.01),
}


def as_fused(optimizer: Any, spec: Any) -> Optional[Any]:
    """The fused twin of a compiled optimizer, or None when no exact twin
    exists. `spec` is the model's compile string; an already-fused
    transformation passes through."""
    if getattr(optimizer, "fused_apply", None) is not None:
        return optimizer
    key = str(spec).lower() if spec is not None else None
    maker = _FUSED_EQUIV.get(key)
    return maker() if maker is not None else None


# Registry — the JAX package's strings and defaults (`KerasUtils.scala`
# 207-216). The strings not ported yet raise NotImplementedError.
_REGISTRY: Dict[str, Callable[[], GradientTransformation]] = {
    "adam": lambda: adam(learning_rate=0.001),
    "adamw": lambda: adam_weight_decay(),
    "adam_weight_decay": lambda: adam_weight_decay(),
}
_NOT_PORTED = ("sgd", "rmsprop", "adamax", "adagrad", "adadelta")


def get(optimizer: Any):
    """Resolve an optimizer compile string, or pass a transformation
    through (duck-typed on callable `init` and `update`). Unknown strings
    raise ValueError, as the reference does."""
    if callable(getattr(optimizer, "init", None)) \
            and callable(getattr(optimizer, "update", None)):
        return optimizer
    key = str(optimizer).lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet ({NOT_PORTED_QUEUE})")
    if key not in _REGISTRY:
        raise ValueError(f"Unsupported optimizer: {optimizer}")
    return _REGISTRY[key]()
