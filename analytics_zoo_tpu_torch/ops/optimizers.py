"""Optimizers and learning-rate schedules, with the compile-string
registry.

Port of `analytics_zoo_tpu/ops/optimizers.py` (the whole file):
`warmup_linear_decay` (L28), `poly_epoch_decay` (L47), `fixed` (L58),
`adam_weight_decay` (L66, with its `mask`), `FusedAdamState` (L91),
`FusedGradientTransformation` (L104), `fused_adam` (L119), `_FUSED_EQUIV`
(L173), `as_fused` (L182), the registry (L196-205: sgd, rmsprop, adamax,
adagrad, adadelta, adam, adamw, adam_weight_decay) and `get` (L208).

The JAX package builds its optimizers from optax; the port writes its own
with the same contract — `init(params) -> state`, `update(grads, state,
params) -> (updates, state)`, updates applied as `p + u` — and optax's
arithmetic step by step (`scale_by_adam`, `scale_by_adamax`,
`scale_by_rms` with `eps` inside the square root, `scale_by_rss` with its
accumulator starting at 0.1, `scale_by_adadelta`, `trace`-less SGD,
`add_decayed_weights`, `scale_by_learning_rate`): moments in the param
dtype, bias correction `1 - β^t` formed in f32, `lr` negated and cast to
the update's dtype. These optimizers have no Pallas twin in the JAX
package, so plain PyTorch is their port. Parameter trees are dicts of
tensors keyed by state-dict name. `fused_adam(...)` adds `fused_apply`,
which runs the fused-Adam kernel (`kernels/fused_adam.py`) over every leaf
in place.

Optimizer state in optax's layout. A checkpoint holds the state as optax
lays it out, one record per link of the chain (`EmptyState` for a link
without state, `ScaleByScheduleState(count)` for a scheduled rate), since
the JAX `restore_opt_state` pours leaves into its template by leaf order.
The states of the optimizers added here are that layout already (tuples
of the records below, counts as host ints). Adam and AdamW keep the one
`FusedAdamState` record the kernels and the lazy-embedding paths step;
their `to_optax(state)` and `from_optax(layout)` give and take the chain
(`convert.opt_layout_to_jax` / `opt_layout_from_jax` carry it across).

Schedules are host functions of the integer step count returning a float,
computed in float32 as the JAX schedules compute them.

Per-step scalars. What an update reads that changes from step to step (the
scheduled rate, the bias corrections, the folded `(a, b, lr·wd)` of the
fused twin) is computed on the host by each transformation's
`scalars(state)`, from the state's host counts with the functions above,
and read by `update(..., scalars=row)` from an f32 tensor on the
parameters' device: the trainer's row of the step's scalar table, which it
writes before the step, so a step captured as a CUDA graph reads each
replay's values. No Python float enters an op of the update. Called
without `scalars`, an update computes its row and copies it to the device
itself. The arithmetic is the old one, operation for operation: a scalar
operand is the row's f32 value cast to the operand's dtype, which is what
the host float became. (On the card a division by a host scalar ran as a
product with its reciprocal, PyTorch's fast path for a CPU scalar; a
divisor on the device divides, as the CPU, optax and the JAX package do.)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.kernels.fused_adam import (_fold_scalars,
                                                        fused_adam_step)

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]


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


def poly_epoch_decay(lr: float, power: float, max_epochs: int,
                     steps_per_epoch: int) -> Schedule:
    """`PolyEpochDecay` (`Adam.scala:141-151`): lr * (1 -
    epoch/maxEpochs)^power, epoch-granular."""
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, max_epochs)
        return float(f32(lr) * (f32(1.0) - f32(epoch) / f32(max_epochs))
                     ** f32(power))
    return schedule


def fixed(lr: float) -> Schedule:
    """`Fixed` schedule (`common/Optim.scala:29`): lr at every step."""
    return lambda step: float(np.float32(lr))


def _lr_at(learning_rate: LearningRate, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) \
        else learning_rate


def _lr_state(learning_rate: LearningRate, count: int):
    """The state of `scale_by_learning_rate`'s link: a schedule keeps the
    count it is read at, a constant nothing."""
    return ScaleByScheduleState(count) if callable(learning_rate) \
        else EmptyState()


def _neg_lr(learning_rate: LearningRate, count: int) -> float:
    """−lr at `count`, an f32 value: the factor of
    `scale_by_learning_rate`."""
    return float(np.float32(-np.float32(_lr_at(learning_rate, count))))


def _scale_by_lr(step: torch.Tensor, updates):
    """`scale_by_learning_rate`: a constant multiplies as a weak-typed
    scalar, a schedule's value is cast to each update's dtype; both equal
    multiplying by −lr (`step`, the row's f32 value) rounded to the
    update's dtype."""
    cast = _Casts(step)
    return {n: u * cast(u.dtype) for n, u in updates.items()}


class _Casts:
    """A row's f32 value cast to each dtype it meets, once a dtype."""

    def __init__(self, value: torch.Tensor):
        self._value = value
        self._by_dtype: Dict[torch.dtype, torch.Tensor] = {}

    def __call__(self, dtype: torch.dtype) -> torch.Tensor:
        out = self._by_dtype.get(dtype)
        if out is None:
            out = self._by_dtype[dtype] = self._value.to(dtype)
        return out


def scalar_row(values, device) -> torch.Tensor:
    """Host floats as the f32 row an update reads, on `device`."""
    return torch.tensor([float(v) for v in values],
                        dtype=torch.float32).to(device)


def _row(scalars, scalars_fn, state, tree) -> torch.Tensor:
    """The update's row: `scalars` as given (the trainer's table row), or
    computed from `state` and copied to the device of `tree`'s leaves."""
    if scalars is not None:
        return scalars
    device = next(iter(tree.values())).device if tree else "cpu"
    return scalar_row(scalars_fn(state), device)


def takes_scalars(optimizer) -> bool:
    """Whether `optimizer` declares per-step scalars, and its update and
    `fused_apply` then take them as `scalars=`."""
    fn = getattr(optimizer, "scalars", None)
    return fn is not None and fn is not _no_scalars


def step_scalars(optimizer, state) -> List[float]:
    """The f32 values `optimizer`'s next update reads, from its state's
    host counts (none for a transformation that declares no `scalars`)."""
    if not takes_scalars(optimizer):
        return []
    return [float(v) for v in optimizer.scalars(state)]


def _lr_scalars(learning_rate: LearningRate) -> Callable:
    """`scalars` of a chain whose only per-step value is the rate: (−lr,)
    at the count its schedule link holds."""
    return lambda state: (_neg_lr(learning_rate, _lr_count(state)),)


def _lr_count(state) -> int:
    """The schedule count a chain's state holds (0 without a schedule)."""
    return next((part.count for part in state
                 if isinstance(part, ScaleByScheduleState)), 0)


def _next_lr_state(learning_rate: LearningRate, state):
    return _lr_state(learning_rate, _lr_count(state) + 1)


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


class EmptyState(NamedTuple):
    """optax's `EmptyState`: a link of a chain that keeps no state."""


class ScaleByScheduleState(NamedTuple):
    """optax's `ScaleByScheduleState`: the step count a scheduled rate is
    read at (a host int)."""

    count: int


class ScaleByRmsState(NamedTuple):
    nu: Dict[str, torch.Tensor]


class ScaleByRssState(NamedTuple):
    sum_of_squares: Dict[str, torch.Tensor]


class ScaleByAdaDeltaState(NamedTuple):
    e_g: Dict[str, torch.Tensor]
    e_x: Dict[str, torch.Tensor]


class MaskedState(NamedTuple):
    """optax's `MaskedState` around a masked link (`adamw(mask=...)`)."""

    inner_state: Any


def _identity_layout(state):
    return state


def _no_scalars(state) -> List[float]:
    return []


class GradientTransformation(NamedTuple):
    """`init`, `update`, and the optax layout of the state: `to_optax`
    gives the chain's records, `from_optax` takes them back."""

    init: Callable
    update: Callable
    to_optax: Callable = _identity_layout
    from_optax: Callable = _identity_layout
    scalars: Callable = _no_scalars


class FusedGradientTransformation(NamedTuple):
    """An (init, update) pair plus the fused fast path
    `fused_apply(grads, state, params) -> (params, state)`: the kernel
    writes the parameters and moments in place and no updates tree
    exists."""

    init: Callable
    update: Callable
    fused_apply: Callable
    to_optax: Callable = _identity_layout
    from_optax: Callable = _identity_layout
    scalars: Callable = _no_scalars


def _adam(learning_rate: LearningRate, b1: float, b2: float, eps: float,
          weight_decay: Optional[float],
          mask: Optional[Any] = None) -> GradientTransformation:
    """optax.adam (weight_decay None) or optax.adamw, eps_root 0, moments
    in the param dtype. `mask` (a dict of bools keyed like the params, or
    a callable that makes one from them) limits the weight decay to the
    leaves it marks, as optax's `masked` does."""
    f32 = np.float32

    def init_fn(params):
        return FusedAdamState(
            0, {n: torch.zeros_like(p) for n, p in params.items()},
            {n: torch.zeros_like(p) for n, p in params.items()})

    def scalars_fn(state):
        """(1 − β1ᵗ, 1 − β2ᵗ, −lr) of the next step, each in f32."""
        count = state.count + 1
        return (float(f32(1.0) - f32(b1) ** f32(count)),
                float(f32(1.0) - f32(b2) ** f32(count)),
                -float(f32(_lr_at(learning_rate, state.count))))

    @torch.no_grad()
    def update_fn(grads, state, params=None, scalars=None):
        if weight_decay is not None and params is None:
            raise ValueError("adamw needs the params: call "
                             "update(grads, state, params)")
        decays = _decay_mask(mask, params, grads)
        row = _row(scalars, scalars_fn, state, grads)
        bc1, bc2, step = _Casts(row[0]), _Casts(row[1]), _Casts(row[2])
        updates = {}
        for name, g in grads.items():
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            mu_hat = mu / bc1(mu.dtype)
            nu_hat = nu / bc2(nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + eps)
            if weight_decay is not None and decays[name]:
                u = u + weight_decay * params[name]
            updates[name] = u * step(u.dtype)
        return updates, FusedAdamState(state.count + 1, state.mu, state.nu)

    def to_optax(state):
        parts = [state]
        if weight_decay is not None:
            parts.append(EmptyState() if mask is None
                         else MaskedState(EmptyState()))
        parts.append(_lr_state(learning_rate, state.count))
        return tuple(parts)

    def from_optax(layout):
        return layout[0]

    return GradientTransformation(init_fn, update_fn, to_optax, from_optax,
                                  scalars_fn)


def _decay_mask(mask, params, grads) -> Dict[str, bool]:
    if mask is None:
        return {n: True for n in grads}
    marks = mask(params) if callable(mask) else mask
    return {n: bool(marks[n]) for n in grads}


def adam(learning_rate: LearningRate = 1e-3, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """optax.adam."""
    return _adam(learning_rate, b1, b2, eps, None)


def adamw(learning_rate: LearningRate = 1e-3, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4,
          mask: Optional[Any] = None) -> GradientTransformation:
    """optax.adamw (decoupled weight decay, limited to the leaves `mask`
    marks when given)."""
    return _adam(learning_rate, b1, b2, eps, weight_decay, mask)


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
    zero; `mask` (a dict of bools keyed like the params, or a callable
    making one) limits the decay to the leaves it marks. No fused twin, as
    in the JAX package: the schedule lives in a closure that `as_fused`
    must not guess at."""
    if schedule != "linear":
        raise ValueError(f"Unsupported warmup schedule: {schedule}")
    if total_steps > 0:
        sched = warmup_linear_decay(lr, total_steps, warmup_portion)
    else:
        sched = fixed(lr)
    return adamw(sched, b1=beta1, b2=beta2, eps=epsilon,
                 weight_decay=weight_decay, mask=mask)


def _zeros(params, fill: float = 0.0):
    return {n: torch.full_like(p, fill) for n, p in params.items()}


def sgd(learning_rate: LearningRate = 0.01) -> GradientTransformation:
    """optax.sgd without momentum: chain(identity, scale_by_learning_rate);
    its state is (EmptyState(), the rate's link)."""

    def init_fn(params):
        return (EmptyState(), _lr_state(learning_rate, 0))

    scalars_fn = _lr_scalars(learning_rate)

    @torch.no_grad()
    def update_fn(grads, state, params=None, scalars=None):
        row = _row(scalars, scalars_fn, state, grads)
        updates = _scale_by_lr(row[0], grads)
        return updates, (EmptyState(), _next_lr_state(learning_rate, state))

    return GradientTransformation(init_fn, update_fn, scalars=scalars_fn)


def rmsprop(learning_rate: LearningRate = 0.001, decay: float = 0.9,
            eps: float = 1e-8) -> GradientTransformation:
    """optax.rmsprop (not centered, no momentum, `eps_in_sqrt=True`):
    ν ← (1−decay)·g² + decay·ν, u = g·rsqrt(ν + eps); its state is
    (ScaleByRmsState(nu), the rate's link, EmptyState())."""

    def init_fn(params):
        return (ScaleByRmsState(_zeros(params)),
                _lr_state(learning_rate, 0), EmptyState())

    scalars_fn = _lr_scalars(learning_rate)

    @torch.no_grad()
    def update_fn(grads, state, params=None, scalars=None):
        row = _row(scalars, scalars_fn, state, grads)
        nu = {n: (1 - decay) * (g * g) + decay * state[0].nu[n]
              for n, g in grads.items()}
        u = {n: torch.rsqrt(nu[n] + eps) * g for n, g in grads.items()}
        return (_scale_by_lr(row[0], u),
                (ScaleByRmsState(nu), _next_lr_state(learning_rate, state),
                 EmptyState()))

    return GradientTransformation(init_fn, update_fn, scalars=scalars_fn)


def adamax(learning_rate: LearningRate = 0.002, b1: float = 0.9,
           b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """optax.adamax: μ ← (1−b1)·g + b1·μ, ν ← max(|g| + eps, b2·ν),
    u = μ / (1 − b1^t) / ν; its state is (ScaleByAdamState(count, mu, nu),
    the rate's link)."""
    f32 = np.float32

    def init_fn(params):
        return (FusedAdamState(0, _zeros(params), _zeros(params)),
                _lr_state(learning_rate, 0))

    def scalars_fn(state):
        """(1 − β1ᵗ, −lr) of the next step, each in f32."""
        count = state[0].count + 1
        return (float(f32(1.0) - f32(b1) ** f32(count)),
                _neg_lr(learning_rate, _lr_count(state)))

    @torch.no_grad()
    def update_fn(grads, state, params=None, scalars=None):
        row = _row(scalars, scalars_fn, state, grads)
        bc1 = _Casts(row[0])
        adam_state = state[0]
        mu, nu, u = {}, {}, {}
        for n, g in grads.items():
            mu[n] = (1 - b1) * g + b1 * adam_state.mu[n]
            nu[n] = torch.maximum(torch.abs(g) + eps, b2 * adam_state.nu[n])
            mu_hat = mu[n] / bc1(mu[n].dtype)
            u[n] = mu_hat / nu[n]
        return (_scale_by_lr(row[1], u),
                (FusedAdamState(adam_state.count + 1, mu, nu),
                 _next_lr_state(learning_rate, state)))

    return GradientTransformation(init_fn, update_fn, scalars=scalars_fn)


def adagrad(learning_rate: LearningRate = 0.01,
            initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
    """optax.adagrad: s ← g² + s (s starts at 0.1), u = g·rsqrt(s + eps)
    where s > 0, else 0; its state is (ScaleByRssState(sum_of_squares),
    the rate's link)."""

    def init_fn(params):
        return (ScaleByRssState(_zeros(params, initial_accumulator_value)),
                _lr_state(learning_rate, 0))

    scalars_fn = _lr_scalars(learning_rate)

    @torch.no_grad()
    def update_fn(grads, state, params=None, scalars=None):
        row = _row(scalars, scalars_fn, state, grads)
        sos = {n: g * g + state[0].sum_of_squares[n]
               for n, g in grads.items()}
        u = {n: torch.where(sos[n] > 0, torch.rsqrt(sos[n] + eps), 0.0) * g
             for n, g in grads.items()}
        return (_scale_by_lr(row[0], u),
                (ScaleByRssState(sos), _next_lr_state(learning_rate, state)))

    return GradientTransformation(init_fn, update_fn, scalars=scalars_fn)


def adadelta(learning_rate: LearningRate = 1.0, rho: float = 0.9,
             eps: float = 1e-6,
             weight_decay: float = 0.0) -> GradientTransformation:
    """optax.adadelta: chain(add_decayed_weights(weight_decay),
    scale_by_adadelta, scale_by_learning_rate); e_g ← (1−ρ)·g² + ρ·e_g,
    u = √(e_x + eps) / √(e_g + eps) · g, e_x ← (1−ρ)·u² + ρ·e_x. Its state
    is (EmptyState(), ScaleByAdaDeltaState(e_g, e_x), the rate's link).
    Like optax it needs the params (the decay link adds `wd · p`, 0 · p
    included)."""

    def init_fn(params):
        return (EmptyState(),
                ScaleByAdaDeltaState(_zeros(params), _zeros(params)),
                _lr_state(learning_rate, 0))

    scalars_fn = _lr_scalars(learning_rate)

    @torch.no_grad()
    def update_fn(grads, state, params=None, scalars=None):
        if params is None:
            raise ValueError("adadelta needs the params: call "
                             "update(grads, state, params)")
        row = _row(scalars, scalars_fn, state, grads)
        e_g, e_x, u = {}, {}, {}
        for n, g in grads.items():
            g = g + weight_decay * params[n]
            e_g[n] = (1 - rho) * (g * g) + rho * state[1].e_g[n]
            u[n] = (torch.sqrt(state[1].e_x[n] + eps)
                    / torch.sqrt(e_g[n] + eps)) * g
            e_x[n] = (1 - rho) * (u[n] * u[n]) + rho * state[1].e_x[n]
        return (_scale_by_lr(row[0], u),
                (EmptyState(), ScaleByAdaDeltaState(e_g, e_x),
                 _next_lr_state(learning_rate, state)))

    return GradientTransformation(init_fn, update_fn, scalars=scalars_fn)


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

    def scalars_fn(state):
        """The folded `(a, b, lr·wd)` of the next step
        (`kernels/fused_adam._fold_scalars`)."""
        return _fold_scalars(state.count + 1,
                             _lr_at(learning_rate, state.count), b1, b2, eps,
                             weight_decay)

    def fused_apply(grads, state, params, scalars=None):
        if params is None:
            raise ValueError(
                "fused_adam is a params-aware transformation; call "
                "fused_apply(grads, state, params) with the parameters")
        count = state.count + 1
        fused_adam_step(params, state.mu, state.nu, grads, count,
                        lr=_lr_at(learning_rate, state.count), b1=b1, b2=b2,
                        eps=eps, weight_decay=weight_decay, folded=scalars)
        return params, FusedAdamState(count, state.mu, state.nu)

    @torch.no_grad()
    def update_fn(grads, state, params=None, scalars=None):
        """The optax contract: returns updates (new − old) and leaves the
        params untouched, at the cost of one copy of them."""
        if params is None:
            raise ValueError("fused_adam.update needs the params")
        new = {n: p.clone() for n, p in params.items()}
        _, state = fused_apply(grads, state, new, scalars)
        return {n: new[n] - params[n] for n in params}, state

    return FusedGradientTransformation(init_fn, update_fn, fused_apply,
                                       scalars=scalars_fn)


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
# 207-216).
_REGISTRY: Dict[str, Callable[[], GradientTransformation]] = {
    "sgd": lambda: sgd(learning_rate=0.01),
    "rmsprop": lambda: rmsprop(learning_rate=0.001, decay=0.9),
    "adamax": lambda: adamax(learning_rate=0.002, eps=1e-8),
    "adagrad": lambda: adagrad(learning_rate=0.01),
    "adadelta": lambda: adadelta(learning_rate=1.0, rho=0.95, eps=1e-8),
    "adam": lambda: adam(learning_rate=0.001),
    "adamw": lambda: adam_weight_decay(),
    "adam_weight_decay": lambda: adam_weight_decay(),
}


def get(optimizer: Any):
    """Resolve an optimizer compile string, or pass a transformation
    through (duck-typed on callable `init` and `update`). Unknown strings
    raise ValueError, as the reference does."""
    if callable(getattr(optimizer, "init", None)) \
            and callable(getattr(optimizer, "update", None)):
        return optimizer
    key = str(optimizer).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unsupported optimizer: {optimizer}")
    return _REGISTRY[key]()
