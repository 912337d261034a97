"""The port's optimizers, schedules, triggers and losses held against the
JAX package on the CPU: each of the eight optimizer strings (and
`adam_weight_decay(mask=...)`) against optax over 5 steps with a constant
and a scheduled rate, the state's optax layout leaf for leaf,
`learn/schedule.py` and `poly_epoch_decay` at 20 steps, the triggers on
the same `TriggerState`s, and the 13 losses ported in this slice.

Inputs come from numpy with a seed, in float32. Tolerances: parameters and
state leaves after 5 steps, relative 1e-6 (atol 1e-7 for values near 0);
schedules relative 1e-6; losses 1e-6; triggers exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.common import triggers as jtg
from analytics_zoo_tpu.learn import schedule as jsched
from analytics_zoo_tpu.ops import objectives as jobj
from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common import triggers as tg
from analytics_zoo_tpu_torch.learn import metrics as tmetrics
from analytics_zoo_tpu_torch.learn import schedule as tsched
from analytics_zoo_tpu_torch.learn import trigger as ttrigger
from analytics_zoo_tpu_torch.ops import objectives, optimizers

RTOL, ATOL = 1e-6, 1e-7
STEPS = 5
STRINGS = ["sgd", "rmsprop", "adamax", "adagrad", "adadelta", "adam",
           "adamw", "adam_weight_decay"]


def _problem(seed=0):
    """Params {"a": [4, 3], "b": [3]} and STEPS gradients."""
    rs = np.random.RandomState(seed)
    params = {"a": rs.standard_normal((4, 3)).astype(np.float32),
              "b": rs.standard_normal((3,)).astype(np.float32)}
    grads = [{k: rs.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(STEPS)]
    return params, grads


def _port_flat(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _run_port(opt, params, grads):
    p = _port_flat(params)
    state = opt.init(p)
    for g in grads:
        u, state = opt.update(_port_flat(g), state, p)
        p = {k: p[k] + u[k] for k in p}
    return p, state


def _run_jax(opt, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        u, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                              state, p)
        p = optax.apply_updates(p, u)
    return p, state


class _Flat:
    """Stands in for a model in `convert.opt_layout_to_jax`: a flat dict
    of moments is its own JAX tree (no layers, no buffers)."""

    def ordered_layers(self):
        return []

    def named_parameters(self):
        return iter(())

    def state_dict(self):
        return {}


def _paths(tree):
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _layout_leaves(opt, state):
    tree = convert._layout_to_jax(opt.to_optax(state), _Flat())
    return jax.tree_util.tree_leaves(tree), _paths(tree)


def _compare(port_pair, jax_pair, opt):
    (tp, tstate), (jp, jstate) = port_pair, jax_pair
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL)
    # the state in optax's layout: the same records, leaf for leaf
    leaves, paths = _layout_leaves(opt, tstate)
    want = jax.tree_util.tree_leaves(jstate)
    assert paths == _paths(jstate)
    for a, b in zip(leaves, want):
        assert np.shape(a) == np.shape(b)
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", STRINGS)
def test_registry_optimizer_matches_optax(name):
    """The registry string on both packages: 5 steps, constant rate."""
    params, grads = _problem()
    port_opt = optimizers.get(name)
    _compare(_run_port(port_opt, params, grads),
             _run_jax(jopt.get(name), params, grads), port_opt)


def _schedules():
    """(port, jax) Poly decays of one shape."""
    return (tsched.Poly(0.5, 20).make(0.05),
            jsched.Poly(0.5, 20).make(0.05))


# the registry's constructors with a scheduled rate, on both packages
SCHEDULED = {
    "sgd": (lambda s: optimizers.sgd(s), lambda s: optax.sgd(s)),
    "rmsprop": (lambda s: optimizers.rmsprop(s, decay=0.9),
                lambda s: optax.rmsprop(s, decay=0.9)),
    "adamax": (lambda s: optimizers.adamax(s, eps=1e-8),
               lambda s: optax.adamax(s, eps=1e-8)),
    "adagrad": (lambda s: optimizers.adagrad(s), lambda s: optax.adagrad(s)),
    "adadelta": (lambda s: optimizers.adadelta(s, rho=0.95, eps=1e-8),
                 lambda s: optax.adadelta(s, rho=0.95, eps=1e-8)),
    "adam": (lambda s: optimizers.adam(s), lambda s: optax.adam(s)),
    "adamw": (lambda s: optimizers.adamw(s, eps=1e-6, weight_decay=0.01),
              lambda s: optax.adamw(s, eps=1e-6, weight_decay=0.01)),
    "adam_weight_decay": (
        lambda s: optimizers.adam_weight_decay(0.05, warmup_portion=0.2,
                                               total_steps=10),
        lambda s: jopt.adam_weight_decay(0.05, warmup_portion=0.2,
                                         total_steps=10)),
}


@pytest.mark.parametrize("name", STRINGS)
def test_scheduled_optimizer_matches_optax(name):
    """The same optimizers with a scheduled rate (the schedule's count is a
    leaf of the state: `ScaleByScheduleState`)."""
    params, grads = _problem(1)
    port_s, jax_s = _schedules()
    make_port, make_jax = SCHEDULED[name]
    port_opt = make_port(port_s)
    _compare(_run_port(port_opt, params, grads),
             _run_jax(make_jax(jax_s), params, grads), port_opt)


def test_fused_adam_layout_is_the_jax_fused_state():
    params, grads = _problem(2)
    opt = optimizers.fused_adam(1e-3)
    p = _port_flat(params)
    state = opt.init(p)
    for g in grads:
        p, state = opt.fused_apply(_port_flat(g), state, p)
    leaves, paths = _layout_leaves(opt, state)
    template = jopt.fused_adam().init({k: jnp.asarray(v)
                                       for k, v in params.items()})
    assert paths == _paths(template)
    assert int(leaves[0]) == STEPS and leaves[0].dtype == np.int32


@pytest.mark.parametrize("callable_mask", [False, True])
def test_adam_weight_decay_mask_matches_optax(callable_mask):
    params, grads = _problem(3)
    mask = {"a": True, "b": False}
    port_mask = (lambda p: mask) if callable_mask else mask
    port_opt = optimizers.adam_weight_decay(0.01, mask=port_mask)
    jax_opt = jopt.adam_weight_decay(
        0.01, mask=(lambda p: mask) if callable_mask else mask)
    _compare(_run_port(port_opt, params, grads),
             _run_jax(jax_opt, params, grads), port_opt)
    # the masked link keeps optax's MaskedState(EmptyState())
    state = port_opt.init(_port_flat(params))
    assert port_opt.to_optax(state)[1] == optimizers.MaskedState(
        optimizers.EmptyState())


def test_adadelta_needs_params():
    params, grads = _problem()
    opt = optimizers.get("adadelta")
    state = opt.init(_port_flat(params))
    with pytest.raises(ValueError, match="params"):
        opt.update(_port_flat(grads[0]), state)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def _seq(mod):
    return mod.SequentialSchedule(5).add(mod.Warmup(0.01), 4) \
        .add(mod.Poly(2.0, 10), 10).add(mod.Exponential(3, 0.5), 100)


SCHEDULE_CASES = {
    "default": lambda m: m.Default(),
    "poly": lambda m: m.Poly(0.5, 15),
    "exponential": lambda m: m.Exponential(4, 0.8),
    "exponential_stair": lambda m: m.Exponential(4, 0.8, stair_case=True),
    "step": lambda m: m.Step(3, 0.5),
    "multistep": lambda m: m.MultiStep([2, 7, 11], 0.3),
    "warmup": lambda m: m.Warmup(0.002),
    "sequential": _seq,
}


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_schedule_matches_the_jax_package(case):
    port = SCHEDULE_CASES[case](tsched).make(0.1)
    ref = SCHEDULE_CASES[case](jsched).make(0.1)
    for step in range(20):
        np.testing.assert_allclose(port(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6)


def test_poly_epoch_decay_matches_the_jax_package():
    port = optimizers.poly_epoch_decay(0.1, 2.0, 4, 3)
    ref = jopt.poly_epoch_decay(0.1, 2.0, 4, 3)
    for step in range(20):
        np.testing.assert_allclose(port(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6)


def test_plateau_matches_the_jax_package():
    port = tsched.Plateau(factor=0.5, patience=1, cooldown=1, base_lr=0.1)
    ref = jsched.Plateau(factor=0.5, patience=1, cooldown=1, base_lr=0.1)
    for v in (1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8):
        assert port.on_metric(v) == ref.on_metric(v)


# ---------------------------------------------------------------------------
# triggers
# ---------------------------------------------------------------------------
def _trigger_pairs():
    pairs = [(tg.EveryEpoch(), jtg.EveryEpoch()),
             (tg.SeveralIteration(3), jtg.SeveralIteration(3)),
             (tg.MaxEpoch(2), jtg.MaxEpoch(2)),
             (tg.MaxIteration(5), jtg.MaxIteration(5)),
             (tg.MinLoss(0.5), jtg.MinLoss(0.5)),
             (tg.MaxScore(0.8), jtg.MaxScore(0.8)),
             (tg.And(tg.EveryEpoch(), tg.MaxEpoch(2)),
              jtg.And(jtg.EveryEpoch(), jtg.MaxEpoch(2))),
             (tg.Or(tg.MinLoss(0.5), tg.MaxIteration(5)),
              jtg.Or(jtg.MinLoss(0.5), jtg.MaxIteration(5)))]
    for spec in ("every_epoch", "max_epoch:3", "several_iteration:2",
                 "MaxIteration 4"):
        pairs.append((tg.Trigger.from_string(spec),
                      jtg.Trigger.from_string(spec)))
    return pairs


def test_triggers_match_the_jax_package():
    states = [dict(epoch=e, iteration=i, loss=l, score=s, epoch_finished=f)
              for e in (0, 1, 2, 3) for i in (0, 2, 3, 5, 6)
              for l, s in ((0.4, 0.9), (0.7, 0.1)) for f in (False, True)]
    for port, ref in _trigger_pairs():
        for st in states:
            assert port(tg.TriggerState(**st)) == ref(jtg.TriggerState(**st))
    with pytest.raises(ValueError, match="Cannot parse"):
        tg.Trigger.from_string("sometimes")
    with pytest.raises(ValueError, match="positive"):
        tg.SeveralIteration(0)
    assert ttrigger.__all__ == ["EveryEpoch", "SeveralIteration", "MaxEpoch",
                                "MaxIteration", "MinLoss", "MaxScore"]
    assert tmetrics.Top5Accuracy is not None and len(tmetrics.__all__) == 8


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _loss_inputs(name, rs):
    if name in ("hinge", "squared_hinge"):
        return (np.sign(rs.standard_normal((6, 3))).astype(np.float32),
                rs.standard_normal((6, 3)).astype(np.float32))
    if name in ("kld", "kullback_leibler_divergence"):
        t = rs.rand(6, 4).astype(np.float32)
        p = rs.rand(6, 4).astype(np.float32)
        return t / t.sum(-1, keepdims=True), p / p.sum(-1, keepdims=True)
    if name == "poisson":
        return (rs.poisson(2.0, (6, 1)).astype(np.float32),
                rs.rand(6, 1).astype(np.float32) * 3 + 0.1)
    if name in ("msle", "mean_squared_logarithmic_error", "mape",
                "mean_absolute_percentage_error"):
        return (rs.rand(6).astype(np.float32) * 4,
                rs.rand(6, 1).astype(np.float32) * 4)
    if name == "rank_hinge":
        return (np.zeros((8, 1), np.float32),
                rs.standard_normal((8, 1)).astype(np.float32))
    return (rs.standard_normal((6, 3)).astype(np.float32),
            rs.standard_normal((6, 3)).astype(np.float32))


LOSSES = ["mae", "mean_absolute_error", "hinge", "mape",
          "mean_absolute_percentage_error", "msle",
          "mean_squared_logarithmic_error", "squared_hinge", "kld",
          "kullback_leibler_divergence", "cosine_proximity", "poisson",
          "rank_hinge"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_the_jax_package(name):
    rs = np.random.RandomState(sorted(LOSSES).index(name))
    y_true, y_pred = _loss_inputs(name, rs)
    want = float(jobj.get(name)(jnp.asarray(y_true), jnp.asarray(y_pred)))
    got = objectives.get(name)(torch.from_numpy(y_true),
                               torch.from_numpy(y_pred))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=1e-6)


def test_rank_hinge_margin_and_gradient():
    rs = np.random.RandomState(4)
    s = rs.standard_normal((6, 1)).astype(np.float32)
    want = float(jobj.RankHinge(margin=0.5)(None, jnp.asarray(s)))
    pred = torch.from_numpy(s).requires_grad_()
    got = objectives.RankHinge(margin=0.5)(None, pred)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    got.backward()
    jg = jax.grad(lambda p: jobj.RankHinge(margin=0.5)(None, p))(
        jnp.asarray(s))
    np.testing.assert_allclose(pred.grad.numpy(), np.asarray(jg), atol=1e-7)
