"""The port's training kernels and their plain versions, held against the
JAX package on the CPU: the flash-attention backward, the attention and
element dropout rules, fused Adam and the plain Adam/AdamW, the learning
rate schedules and the loss objectives.

On the CPU each kernel wrapper takes its plain version; the reference is
the JAX package's jnp path (its Pallas kernels do not run in interpret mode
on this jax): `jax.grad` through `flash_attention` without `interpret`,
`fused_adam._fold_scalars` + `_adam_math`, `optax.adamw`. Dropout bits
cannot match across frameworks (Philox here, the TPU PRNG or `jax.random`
there), so dropout is held to its rules: exact at rate 0, zeros at rate
>= 1, exact against an injected mask, the keep fraction in statistics, the
backward mask equal to the forward's. Inputs are made with numpy from a
seed. The CUDA kernels themselves run only on the card: the tests marked
`gpu` skip here.
"""

import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.ops import objectives as jobj
from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu.pallas import dropout as jdrop
from analytics_zoo_tpu.pallas import fused_adam as jfa
from analytics_zoo_tpu.pallas.flash_attention import \
    flash_attention as jax_flash_attention
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build
from analytics_zoo_tpu_torch.kernels import dropout as dr
from analytics_zoo_tpu_torch.kernels import flash_attention as fa
from analytics_zoo_tpu_torch.kernels import fused_adam as fad
from analytics_zoo_tpu_torch.kernels import philox
from analytics_zoo_tpu_torch.ops import objectives, optimizers

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)   # test_flash_vjp's gradient tolerance


def _qkv(B=2, H=3, T=64, D=32, seed=0, n=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, T, D).astype(np.float32) for _ in range(n)]


def _padding_mask(B, T, seed=1):
    rs = np.random.RandomState(seed)
    lens = rs.randint(1, T + 1, size=B)
    keep = np.arange(T)[None, :] < lens[:, None]
    return ((1.0 - keep) * -10000.0).astype(np.float32)[:, None, None, :]


def _leaf(a):
    return torch.from_numpy(a).requires_grad_()


# ---------------------------------------------------------------------------
# Philox
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("counter, key, want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox-4x32-10."""
    ctr = [torch.tensor([c], dtype=torch.int64) for c in counter]
    out = philox.philox4x32(*ctr, key[0] | (key[1] << 32))
    assert [int(w) for w in out] == list(want)


def test_attention_keep_bytes_layout():
    """Byte (h, i, j) is byte j % 16 of the draw at counter (j//16, i, h)."""
    bytes_ = philox.attention_keep_bytes(3, 40, seed=11)
    for h, i, j in [(0, 0, 0), (2, 39, 39), (1, 7, 17), (2, 5, 32)]:
        words = philox.philox4x32(torch.tensor([j // 16]),
                                  torch.tensor([i]), torch.tensor([h]), 0, 11)
        word = int(words[(j % 16) // 4])
        assert int(bytes_[h, i, j]) == (word >> (8 * (j % 4))) & 0xFF


def test_site_seeds_are_distinct_and_fixed():
    seeds = {philox.site_seed(s, i) for s in range(20) for i in range(30)}
    assert len(seeds) == 600
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert philox.site_seed(7, 3) == philox.site_seed(7, 3)


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T", [64, 200])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_gradients_match_jax(T, masked):
    """The port's autograd Function (on the CPU: the plain forward and
    `_reference_attention_bwd`) against jax.grad of the JAX
    flash_attention (off TPU: `_reference_attention`)."""
    q, k, v, g = _qkv(T=T, n=4)
    mask = _padding_mask(2, T) if masked else None

    def jloss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, mask=None if mask is None
                                  else jnp.asarray(mask))
        return jnp.sum(out * g)
    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(_leaf, (q, k, v))
    out = fa.flash_attention(tq, tk, tv, mask=None if mask is None
                             else torch.from_numpy(mask))
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    (out * torch.from_numpy(g)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_reference_bwd_matches_autograd_with_keep_scale(masked):
    """The kernels' formula (P from lse, delta) equals torch autograd of
    the plain forward with the same injected keep-scale matrix."""
    T = 72
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(T=T, n=4, seed=3))
    mask = torch.from_numpy(_padding_mask(2, T)) if masked else None
    keep = fa._keep_scale(q, 0.1, 99)
    assert keep.shape == (2, 3, T, T)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa._reference_attention(tq, tk, tv, mask, keep)
    out.backward(g)
    lse = fa._reference_lse(q, k, mask)
    got = fa._reference_attention_bwd(q, k, v, mask, out.detach(), lse, g,
                                      keep)
    for a, b in zip(got, (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_flash_dropout_equals_the_plain_version_with_its_mask():
    """Forward and gradients with dropout on: the wrapper's CPU route draws
    the kernels' bits, so it equals the plain version given the keep-scale
    matrix, and the backward uses the forward's mask."""
    T = 80
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(T=T, n=4, seed=4))
    mask = torch.from_numpy(_padding_mask(2, T, seed=5))
    keep = fa._keep_scale(q, 0.1, 1234)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*a, mask=mask, dropout_rate=0.1,
                             dropout_seed=1234)
    ref = fa._reference_attention(*b, mask, keep)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    out.backward(g)
    ref.backward(g)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-5)


def test_attention_keep_rule_statistics_and_seeds():
    t = dr._byte_threshold(0.1)
    assert t == jdrop._byte_threshold(0.1) == 230
    keep = philox.attention_keep_scale(24, 256, seed=5, threshold=t)
    kept = keep > 0
    assert torch.unique(keep).tolist() == [0.0, float(np.float32(256.0 / t))]
    p, n = t / 256.0, kept.numel()
    assert abs(kept.float().mean().item() - p) <= 5 * math.sqrt(
        p * (1 - p) / n)
    again = philox.attention_keep_scale(24, 256, seed=5, threshold=t)
    other = philox.attention_keep_scale(24, 256, seed=6, threshold=t)
    assert torch.equal(keep, again)
    assert (keep != other).float().mean() > 0.1


def test_flash_backward_input_checks():
    q = torch.zeros(2, 3, 16, 32)
    lse = torch.zeros(2, 3, 16)
    fa._check_bwd_inputs(q, q, lse, q)
    with pytest.raises(ValueError, match="do"):
        fa._check_bwd_inputs(q, q, lse, torch.zeros(2, 16, 3, 32)
                             .transpose(1, 2))
    with pytest.raises(ValueError, match="lse"):
        fa._check_bwd_inputs(q, q, lse.double(), q)


def test_flash_rate_zero_and_no_grad_routes():
    """Rate 0 is the undropped attention; without autograd no Function
    node is built (serving), with it the node is the port's."""
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    plain = fa.flash_attention(q, k, v)
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, dropout_rate=0.0, dropout_seed=3), plain,
        rtol=0, atol=0)
    assert plain.grad_fn is None
    with torch.inference_mode():
        assert fa.flash_attention(*(t.requires_grad_() for t in
                                    (q, k, v))).grad_fn is None


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.9999, 1.0 / 3])
def test_thresholds_match_the_jax_package(rate):
    assert dr._dropout_threshold(rate) == jdrop._dropout_threshold(rate)
    assert dr._byte_threshold(rate) == jdrop._byte_threshold(rate)


def test_fused_dropout_rate_edges_and_seed():
    x = torch.randn(4, 33)
    assert dr.fused_dropout(x, 0.0) is x
    assert dr.fused_dropout(x, -0.1, seed=1) is x
    for rate in (1.0, 1.5):
        out = dr.fused_dropout(x, rate, seed=1)
        assert out.shape == x.shape and not out.any()
    with pytest.raises(ValueError, match="seed"):
        dr.fused_dropout(x, 0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_dropout_is_its_rule_on_injected_mask(dtype):
    """Exact against the plain version with the Philox mask injected, the
    kept values scaled by 1/(1-rate) in the dtype; the keep fraction is
    within 5 sigma of 1 - rate; one seed gives one mask."""
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 257)
                         .astype(np.float32)).to(dtype)
    rate, seed = 0.2, 31
    out = dr.fused_dropout(x, rate, seed=seed)
    keep = dr.dropout_keep(x.shape, seed, rate)
    assert torch.equal(out, torch.where(keep, x * dr._scale(rate, dtype),
                                        torch.zeros((), dtype=dtype)))
    assert torch.equal((out != 0), keep & (x != 0))
    n, p = keep.numel(), 1 - rate
    assert abs(keep.float().mean().item() - p) <= 5 * math.sqrt(
        p * (1 - p) / n)
    assert torch.equal(out, dr.fused_dropout(x, rate, seed=seed))
    assert not torch.equal(out, dr.fused_dropout(x, rate, seed=seed + 1))


def test_fused_dropout_backward_mask_equals_forward_mask():
    x = torch.randn(8, 128, requires_grad=True)
    out = dr.fused_dropout(x, 0.1, seed=9)
    out.backward(torch.ones_like(out))
    assert torch.equal(x.grad != 0, out.detach() != 0)
    kept = x.grad != 0
    torch.testing.assert_close(x.grad[kept],
                               torch.full_like(x.grad[kept], 1 / 0.9))


def test_dropout_kernel_input_checks():
    with pytest.raises(TypeError):
        dr._check_kernel_input(torch.zeros(4, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        dr._check_kernel_input(torch.zeros(4, 6).t())


# ---------------------------------------------------------------------------
# fused Adam, plain Adam/AdamW, schedules
# ---------------------------------------------------------------------------
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
SHAPES = {"w": (5, 7), "b": (7,), "s": (3, 4, 2)}


def _adam_problem(dtype, seed=0):
    """Params, nonzero moments and 5 steps of grads, from numpy."""
    rs = np.random.RandomState(seed)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    mu = {k: rs.randn(*s).astype(np.float32) * 1e-2
          for k, s in SHAPES.items()}
    nu = {k: rs.rand(*s).astype(np.float32) * 1e-3
          for k, s in SHAPES.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(5)]
    if dtype == torch.bfloat16:
        params = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)
                                .astype(jnp.float32))
                  for k, v in params.items()}
    return params, mu, nu, grads


def _t(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype)
            for k, v in tree.items()}


def test_fold_scalars_match_the_jax_package():
    for count in (1, 2, 10, 1000):
        for lr in (1e-3, 5e-5):
            got = fad._fold_scalars(count, lr, 0.9, 0.999, 1e-8, 1e-2)
            want = np.asarray(jfa._fold_scalars(count, lr, 0.9, 0.999, 1e-8,
                                                1e-2))
            np.testing.assert_allclose(got, want, rtol=1e-6)


def _lr_schedule():
    return (optimizers.warmup_linear_decay(1e-2, 10, 0.3),
            jopt.warmup_linear_decay(1e-2, 10, 0.3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheduled", [False, True])
def test_fused_adam_matches_fold_scalars_and_adam_math(dtype, scheduled):
    """5 steps of the port's fused Adam (its CPU route) against the JAX
    package's `_fold_scalars` + `_adam_math` per leaf, starting from the
    same nonzero moments (crossed through `convert`)."""
    params, mu, nu, grads = _adam_problem(dtype)
    port_lr, jax_lr = _lr_schedule() if scheduled else (1e-3, 1e-3)
    opt = optimizers.fused_adam(port_lr, **ADAM)
    jstate = jopt.FusedAdamState(jnp.int32(0), mu, nu)
    state = convert.opt_state_from_jax(jstate)
    tp = _t(params, dtype)
    jp = {k: jnp.asarray(v, jnp.bfloat16 if dtype == torch.bfloat16
                         else jnp.float32) for k, v in params.items()}
    jm, jn = dict(mu), dict(nu)
    for step, g in enumerate(grads):
        ids = {k: v.data_ptr() for k, v in tp.items()}
        tp, state = opt.fused_apply(_t(g, dtype), state, tp)
        assert {k: v.data_ptr() for k, v in tp.items()} == ids   # in place
        lr = jax_lr(jnp.int32(step)) if scheduled else jax_lr
        a, b, lrwd = jfa._fold_scalars(step + 1, lr, 0.9, 0.999, 1e-8, 1e-2)
        for k in jp:
            gk = jnp.asarray(g[k], jp[k].dtype).astype(jnp.float32)
            pn, jm[k], jn[k] = jfa._adam_math(jp[k].astype(jnp.float32),
                                              jm[k], jn[k], gk, a, b, lrwd,
                                              0.9, 0.999)
            jp[k] = pn.astype(jp[k].dtype)
    assert state.count == 5
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    for k in jp:
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k].astype(jnp.float32)),
                                   **tol)
        np.testing.assert_allclose(state.mu[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(jn[k]),
                                   rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("dtype, fused", [
    (torch.float32, False), (torch.bfloat16, False), (torch.float32, True)])
@pytest.mark.parametrize("scheduled", [False, True])
def test_adamw_matches_optax(dtype, fused, scheduled):
    """5 steps of the port's plain AdamW and of its fused Adam against
    optax.adamw, from the same nonzero moments (an optax state crossed
    through `convert`). The plain AdamW follows optax's dtypes (moments in
    the param dtype). The fused Adam keeps f32 moments, where optax keeps
    bf16 moments for bf16 params — another computation — so its bf16 case
    is held to `_adam_math` above instead."""
    params, mu, nu, grads = _adam_problem(dtype, seed=1)
    port_lr, jax_lr = _lr_schedule() if scheduled else (1e-3, 1e-3)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jtx = optax.adamw(jax_lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jstate = jtx.init(jp)
    jstate = (optax.ScaleByAdamState(
        count=jnp.int32(0),
        mu={k: jnp.asarray(v, jdt) for k, v in mu.items()},
        nu={k: jnp.asarray(v, jdt) for k, v in nu.items()}),) + jstate[1:]
    opt = (optimizers.fused_adam if fused else optimizers.adamw)(
        port_lr, **ADAM)
    state = convert.opt_state_from_jax(jstate)
    if not fused:
        state = state._replace(
            mu={k: v.to(dtype) for k, v in state.mu.items()},
            nu={k: v.to(dtype) for k, v in state.nu.items()})
        assert all(v.dtype == dtype for v in state.mu.values())
    tp = _t(params, dtype)
    for g in grads:
        jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        upd, jstate = jtx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tg = _t(g, dtype)
        if fused:
            tp, state = opt.fused_apply(tg, state, tp)
        else:
            u, state = opt.update(tg, state, tp)
            tp = {k: tp[k] + u[k] for k in tp}
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    for k in jp:
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k], np.float32), **tol)
    back = convert.opt_state_to_jax(state)
    assert int(back.count) == int(jstate[0].count) == 5


@pytest.mark.parametrize("portion", [-1.0, 0.1, 0.5])
def test_schedules_match_the_jax_package(portion):
    port = optimizers.warmup_linear_decay(3e-4, 20, portion)
    ref = jopt.warmup_linear_decay(3e-4, 20, portion)
    for step in range(0, 21):
        np.testing.assert_allclose(port(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6)
    assert optimizers.fixed(0.1)(7) == pytest.approx(0.1)


def test_optimizer_registry():
    assert callable(optimizers.get("adam").init)
    assert callable(optimizers.get("AdamW").update)
    tx = optimizers.adamw()
    assert optimizers.get(tx) is tx
    assert callable(optimizers.get("sgd").update)
    with pytest.raises(ValueError, match="Unsupported"):
        optimizers.get("nope")
    assert optimizers.as_fused(optimizers.get("adam"), "adam").fused_apply
    fused = optimizers.fused_adam()
    assert optimizers.as_fused(fused, None) is fused
    # the fused transformation keeps optax's update contract too: updates
    # equal to its in-place step, the params left as they were
    p = {"w": torch.linspace(-1, 1, 6)}
    g = {"w": torch.linspace(0.5, -0.5, 6)}
    before = p["w"].clone()
    upd, state = fused.update(g, fused.init(p), p)
    assert torch.equal(p["w"], before) and state.count == 1
    stepped, _ = fused.fused_apply(g, fused.init(p), {"w": before.clone()})
    torch.testing.assert_close(before + upd["w"], stepped["w"])
    # a warmup instance carries its schedule in a closure: no twin
    assert optimizers.as_fused(optimizers.adam_weight_decay(
        1e-4, warmup_portion=0.1, total_steps=10), None) is None
    assert optimizers.as_fused(optimizers.adam_weight_decay(
        mask={"w": True}), None) is None


def test_fused_adam_costs_match_the_jax_package():
    shapes = {"a": (768, 3072), "b": (3072,), "c": (2,)}
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        port = fad.update_cost({k: torch.zeros(s, dtype=dtype)
                                for k, s in shapes.items()})
        ref = jfa.update_cost({k: jnp.zeros(s, jdt)
                               for k, s in shapes.items()})
        assert port == tuple(float(x) for x in ref)


def test_fused_adam_kernel_input_checks():
    p = torch.zeros(4, 3)
    fad._check_kernel_inputs(p, p, p, p.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        fad._check_kernel_inputs(p, p.bfloat16(), p, p)
    with pytest.raises(ValueError, match="contiguous"):
        fad._check_kernel_inputs(p, p, p, torch.zeros(3, 4).t())
    with pytest.raises(ValueError, match="match"):
        fad._check_kernel_inputs(p, p, torch.zeros(4), p)


def test_cpu_routes_launch_nothing():
    before = LAUNCHES.snapshot()
    x = torch.randn(4, 8, requires_grad=True)
    dr.fused_dropout(x, 0.1, seed=1).sum().backward()
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv())
    fa.flash_attention(q, k, v, dropout_rate=0.1,
                       dropout_seed=2).sum().backward()
    p = {"w": torch.zeros(3)}
    opt = optimizers.fused_adam()
    opt.fused_apply({"w": torch.ones(3)}, opt.init(p), p)
    assert LAUNCHES.snapshot() == before


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------
def _objective_cases():
    rs = np.random.RandomState(7)
    logits = rs.randn(6, 4).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(logits, -1))
    onehot = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 6)]
    labels = rs.randint(0, 4, 6).astype(np.int32)
    binary = rs.randint(0, 2, (6, 1)).astype(np.float32)
    return [
        ("mse", {}, rs.randn(6).astype(np.float32), rs.randn(6, 1)
         .astype(np.float32)),
        ("mean_squared_error", {}, rs.randn(6, 3).astype(np.float32),
         rs.randn(6, 3).astype(np.float32)),
        ("binary_crossentropy", {}, binary, 1 / (1 + np.exp(-logits[:, :1]))),
        ("binary_crossentropy", {"from_logits": True}, binary[:, 0],
         logits[:, :1]),
        ("categorical_crossentropy", {}, onehot, probs),
        ("categorical_crossentropy", {"from_logits": True}, onehot, logits),
        ("sparse_categorical_crossentropy", {}, labels, probs),
        ("sparse_categorical_crossentropy", {"from_logits": True},
         labels[:, None], logits),
    ]


@pytest.mark.parametrize("case", range(8))
def test_objectives_match_jax(case):
    name, kw, y_true, y_pred = _objective_cases()[case]
    ref = float(jobj.get(name, **kw)(jnp.asarray(y_true),
                                     jnp.asarray(y_pred)))
    got = objectives.get(name, **kw)(torch.from_numpy(y_true),
                                     torch.from_numpy(np.array(y_pred)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), ref, rtol=1e-6, atol=1e-7)


def test_objective_registry():
    assert isinstance(objectives.get("hinge"), objectives.Hinge)
    with pytest.raises(ValueError, match="Unsupported"):
        objectives.get("nope")
    fn = objectives.get(lambda t, p: (p - t).abs().mean())
    assert fn(torch.zeros(3), torch.ones(3)).item() == 1.0


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------
def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edited header must rebuild every source that includes it."""
    assert _build.source_files(fa.BWD_SOURCE) == [
        fa.BWD_SOURCE, "common.cuh", "mma.cuh", "philox.cuh"]
    assert _build.source_files(fad.SOURCE) == [fad.SOURCE, "common.cuh"]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {s: _build.library_path(s) for s in
              (fa.SOURCE, fa.BWD_SOURCE, dr.SOURCE, fad.SOURCE)}
    (csrc / "philox.cuh").write_text((csrc / "philox.cuh").read_text()
                                     + "\n// edited\n")
    after = {s: _build.library_path(s) for s in before}
    assert after[fad.SOURCE] == before[fad.SOURCE]
    assert all(after[s] != before[s]
               for s in (fa.SOURCE, fa.BWD_SOURCE, dr.SOURCE))
    # mma.cuh, included by the two flash sources only
    (csrc / "mma.cuh").write_text((csrc / "mma.cuh").read_text()
                                  + "\n// edited\n")
    again = {s: _build.library_path(s) for s in before}
    assert all(again[s] != after[s] for s in (fa.SOURCE, fa.BWD_SOURCE))
    assert all(again[s] == after[s] for s in (dr.SOURCE, fad.SOURCE))


def test_headers_ship_as_package_data():
    text = (_build.PACKAGE_DIR.parent / "pyproject.toml").read_text()
    assert '"csrc/*.cuh"' in text and '"csrc/*.cu"' in text


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("T", [45, 64, 65, 200, 512])
@pytest.mark.parametrize("D", [30, 32, 64, 128])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_kernels_match_plain_on_gpu(T, D, dtype, tol, rate):
    """The tile edges of the kernels: T below, at and past one 64-row tile,
    ragged and at BERT's 512; D padded to 32 (30 read element by element),
    64 and 128."""
    _need_gpu()
    B, H = 2, 3
    shape = (B, H, T, D)
    q, k, v, g = (torch.from_numpy(a).cuda().to(dtype)
                  for a in _qkv(B, H, T, D, n=4))
    mask = torch.from_numpy(_padding_mask(B, T)).cuda()
    seed = 77 if rate else None
    before = LAUNCHES.snapshot()
    o, lse = fa.flash_attention_fwd(q, k, v, mask, rate, seed)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, mask, o, lse, g, rate, seed)
    torch.cuda.synchronize()
    after = LAUNCHES.snapshot()
    for name in (fa.BWD_DKV_NAME, fa.BWD_DQ_NAME):
        assert after.get(name, 0) == before.get(name, 0) + 1
    keep = fa.keep_scale_matrix(shape, rate, seed, "cuda") if rate else None
    tq, tk, tv = (t.float().requires_grad_() for t in (q, k, v))
    fa._reference_attention(tq, tk, tv, mask, keep).backward(g.float())
    for got, want in zip((dq, dk, dv), (tq.grad, tk.grad, tv.grad)):
        err = (got.float() - want).abs().max().item()
        assert err <= tol * max(1.0, want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_and_fused_adam_kernels_match_plain_on_gpu(dtype):
    _need_gpu()
    x = torch.randn(1000, 77, device="cuda").to(dtype)
    out = dr.fused_dropout(x, 0.1, seed=5)
    assert torch.equal(out, dr._reference_dropout(
        x, 0.1, dr.dropout_keep(x.shape, 5, 0.1, "cuda")))
    p = torch.randn(333, 7, device="cuda").to(dtype)
    m = torch.randn(333, 7, device="cuda") * 1e-2
    v = torch.rand(333, 7, device="cuda") * 1e-3
    g = torch.randn(333, 7, device="cuda").to(dtype)
    sc = fad._fold_scalars(2, 1e-3, 0.9, 0.999, 1e-8, 1e-2)
    want = fad._adam_math(p.float(), m.clone(), v.clone(), g.float(), *sc,
                          0.9, 0.999)
    fad.leaf_update(p, m, v, g, sc, 0.9, 0.999)
    for got, w in zip((p, m, v), want):
        assert torch.equal(got, w.to(got.dtype))


@pytest.mark.gpu
def test_keep_scale_export_equals_plain_philox_on_gpu():
    _need_gpu()
    got = fa.keep_scale_matrix((2, 3, 70, 16), 0.1, 123, "cuda")
    want = philox.attention_keep_scale(6, 70, 123, dr._byte_threshold(0.1),
                                       "cuda").view(2, 3, 70, 70)
    assert torch.equal(got, want)
