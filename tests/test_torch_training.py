"""The port's training slice held against the JAX package on the CPU:
`Estimator.from_keras(...).fit` on the BENCH_TINY BERT (`bench.py:500`:
vocab 512, hidden 128, 2 blocks, 2 heads, seq 64, intermediate 256,
batch 8), the trainer's batching, mixed precision and fused-optimizer
paths, dropout sites and seeds, optimizer-state conversion, and the
guards of the entry points.

Both packages start from the same weights (the JAX `build`, carried across
by `convert`) and see the same batches: the JAX fit runs with
`distributed=False, device_cache=False`, so it batches on the host with the
`np.random.RandomState(seed + epoch)` shuffle the port uses. Dropout is 0
for the comparisons (dropout bits cannot match across frameworks).

Tolerances. f32: per-epoch losses 1e-4 (they agree to ~1e-7); parameters
1e-4, except the key slice of each QKV bias — its true gradient is zero
(softmax is invariant to a constant added to a row's scores), so its
gradient is rounding noise that Adam's m/√v turns into steps of about lr
(a little more when the gradient changes scale), bounded by 2·lr·steps.
Mixed precision: the two frameworks round to bf16 at other places, so
per-epoch losses agree to 5e-3 and parameters move apart by at most that
excursion, 2·lr·steps, with updates that agree to 10% in relative L2.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.learn import trainer as jtrainer
from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models.bert import BERTClassifier as JClassifier
from analytics_zoo_tpu.ops import objectives as jobj
from analytics_zoo_tpu.ops.optimizers import FusedAdamState as JFusedState
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common import device as device_mod
from analytics_zoo_tpu_torch.kernels import LAUNCHES
from analytics_zoo_tpu_torch.kernels import dropout as dr
from analytics_zoo_tpu_torch.kernels import flash_attention as fa
from analytics_zoo_tpu_torch.kernels import fused_adam as fad
from analytics_zoo_tpu_torch.learn import trainer
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from analytics_zoo_tpu_torch.ops import objectives, optimizers
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel

TINY = dict(vocab=512, hidden_size=128, n_block=2, n_head=2, seq_len=64,
            intermediate_size=256)
NO_DROP = dict(hidden_drop=0.0, attn_drop=0.0, dropout=0.0)
LR, EPOCHS, BATCH = 1e-3, 3, 8


@pytest.fixture(scope="module", autouse=True)
def ctx():
    c = zoo.init_orca_context(cluster_mode="local")
    yield c
    zoo.stop_orca_context()


def _data(n=32, seed=0):
    rs = np.random.RandomState(seed)
    lens = rs.randint(8, 65, n)
    mask = (np.arange(64)[None, :] < lens[:, None]).astype(np.float32)
    return {"x": [rs.randint(0, TINY["vocab"], (n, 64)).astype(np.int32),
                  mask],
            "y": rs.randint(0, 2, (n,)).astype(np.int32)}


def _loss_pair():
    return (jobj.get("sparse_categorical_crossentropy", from_logits=True),
            objectives.get("sparse_categorical_crossentropy",
                           from_logits=True))


def _jax_model(seed=3, **kw):
    jm = JClassifier(2, use_flash=True, **TINY, **NO_DROP, **kw)
    jm.params = jax.device_get(jm.build(jax.random.PRNGKey(seed)))
    return jm


def _port_model(params, **kw):
    tm = BERTClassifier(2, use_flash=True, device="cpu", **TINY, **kw)
    tm.load_state_dict(convert.params_from_jax(params))
    return tm


def _k_bias_mask(key, value):
    """True on the key slice of a QKV bias (q|k|v column order)."""
    mask = torch.zeros(value.shape, dtype=torch.bool)
    if key.endswith("attn.qkv_bias"):
        d = value.shape[0] // 3
        mask[d:2 * d] = True
    return mask


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_loss_curve_matches_jax(mixed_precision):
    """3 epochs, shuffle on, through Estimator.fit on both packages."""
    jloss, tloss = _loss_pair()
    jm = _jax_model()
    init = jm.params
    data = _data()
    jh = JEstimator.from_keras(jm, optimizer=optax.adamw(LR),
                               loss=jloss).fit(
        data, epochs=EPOCHS, batch_size=BATCH,
        mixed_precision=mixed_precision, distributed=False,
        device_cache=False)
    tm = _port_model(init, **NO_DROP)
    th = Estimator.from_keras(tm, optimizer=optimizers.adamw(LR), loss=tloss,
                              device="cpu").fit(
        data, epochs=EPOCHS, batch_size=BATCH,
        mixed_precision=mixed_precision)
    assert len(th["loss"]) == EPOCHS
    want = convert.params_from_jax(jax.device_get(jm.params))
    start = convert.params_from_jax(init)
    steps = EPOCHS * len(data["y"]) // BATCH
    if not mixed_precision:
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=1e-4)
        for key, value in tm.state_dict().items():
            diff = (value.detach() - want[key]).abs()
            kb = _k_bias_mask(key, value)
            assert diff[~kb].max() <= 1e-4, key
            if kb.any():
                assert diff[kb].max() <= 2 * LR * steps, key
        return
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=5e-3)
    num = den = 0.0
    for key, value in tm.state_dict().items():
        value = value.detach()
        assert (value - want[key]).abs().max() <= 2 * LR * steps, key
        num += float(((value - want[key]) ** 2).sum())
        den += float(((want[key] - start[key]) ** 2).sum())
    assert (num / den) ** 0.5 <= 0.1


def test_fused_optimizer_fit_equals_plain_adamw():
    """`fused_optimizer=True` with a fused twin gives what the plain AdamW
    with the same hyperparameters gives: the same operations with the bias
    correction folded elsewhere, so losses agree to 1e-6 and the updates
    to 1e-3 in relative L2 (Adam amplifies the rounding of near-zero
    gradients, as above)."""
    _, tloss = _loss_pair()
    params = _jax_model(seed=4).params
    data = _data(seed=1)
    runs = []
    for opt, fused in ((optimizers.adamw(LR, weight_decay=1e-2), False),
                       (optimizers.fused_adam(LR, weight_decay=1e-2), True)):
        tm = _port_model(params, **NO_DROP)
        h = Estimator.from_keras(tm, optimizer=opt, loss=tloss,
                                 device="cpu").fit(
            data, epochs=2, batch_size=BATCH, fused_optimizer=fused)
        runs.append((h["loss"], tm.state_dict()))
    (l0, p0), (l1, p1) = runs
    np.testing.assert_allclose(l1, l0, rtol=0, atol=1e-6)
    start = convert.params_from_jax(params)
    num = sum(float(((p1[k] - p0[k]) ** 2).sum()) for k in p0)
    den = sum(float(((p0[k] - start[k]) ** 2).sum()) for k in p0)
    assert (num / den) ** 0.5 <= 1e-3


def test_fused_optimizer_resolves_compile_strings():
    """`fused_optimizer=True` on a model compiled with "adam" runs the
    fused twin (its state keeps f32 moments); an optimizer without a twin
    keeps the plain path."""
    _, tloss = _loss_pair()
    tm = _port_model(_jax_model().params, **NO_DROP)
    tm.compile("adam", tloss)
    assert tm._optimizer_spec == "adam"
    twin = trainer._resolve_fused(tm, tm.optimizer, True)
    assert twin.fused_apply is not None
    assert trainer._resolve_fused(tm, tm.optimizer, False) is tm.optimizer
    warm = optimizers.adam_weight_decay(1e-4, warmup_portion=0.1,
                                        total_steps=10)
    tm.compile(warm, tloss)
    assert trainer._resolve_fused(tm, tm.optimizer, True) is warm
    h = tm.fit(_data()["x"], _data()["y"], batch_size=BATCH, nb_epoch=1,
               fused_optimizer=True)
    assert len(h["loss"]) == 1 and np.isfinite(h["loss"]).all()


def test_iter_batches_match_the_jax_package():
    data = _data(n=29)
    port = list(trainer.iter_batches(data["x"], data["y"], 8, shuffle=True,
                                     seed=5))
    ref = list(jtrainer.iter_batches(data["x"], data["y"], 8, shuffle=True,
                                     seed=5))
    assert len(port) == len(ref) == 3
    for (px, py, pr), (jx, jy, jr) in zip(port, ref):
        assert pr == jr
        np.testing.assert_array_equal(py, jy)
        for a, b in zip(px, jx):
            np.testing.assert_array_equal(a, b)


def test_mixed_precision_keeps_f32_masters_and_grads():
    _, tloss = _loss_pair()
    tm = _port_model(_jax_model().params)
    params = dict(tm.named_parameters())
    opt = optimizers.fused_adam(LR)
    seen = {}
    orig = opt.fused_apply

    def spy(grads, state, p):
        seen.update({k: g.dtype for k, g in grads.items()})
        return orig(grads, state, p)
    step = trainer.build_train_step(tm, tloss,
                                    opt._replace(fused_apply=spy), True)
    data = _data(n=8)
    xb = [torch.from_numpy(a) for a in data["x"]]
    _, _, loss = step(params, opt.init(params), xb,
                      torch.from_numpy(data["y"]), 11)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert set(seen.values()) == {torch.float32}
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in tm.parameters())


def _count(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_training_step_runs_every_dropout_site(monkeypatch):
    """Per step: 2 + 2·blocks dropout passes forward and as many backward
    (the chip's 52 at 12 blocks), one flash forward and one backward per
    block."""
    drops = _count(monkeypatch, dr, "dropout_apply")
    fwd = _count(monkeypatch, fa, "flash_attention_fwd")
    bwd = _count(monkeypatch, fa, "flash_attention_bwd")
    _, tloss = _loss_pair()
    tm = _port_model(_jax_model().params)
    params = dict(tm.named_parameters())
    opt = optimizers.fused_adam(LR)
    step = trainer.build_train_step(tm, tloss, opt)
    data = _data(n=4)
    step(params, opt.init(params), [torch.from_numpy(a) for a in data["x"]],
         torch.from_numpy(data["y"]), 3)
    n_block = TINY["n_block"]
    assert len(drops) == 2 * (2 * n_block + 2)
    assert len(fwd) == len(bwd) == n_block


def test_serving_routes_forward_only(monkeypatch):
    """Under inference_mode a predict runs one flash forward per block and
    no backward, and builds no autograd graph."""
    fwd = _count(monkeypatch, fa, "flash_attention_fwd")
    bwd = _count(monkeypatch, fa, "flash_attention_bwd")
    drops = _count(monkeypatch, dr, "dropout_apply")
    tm = _port_model(_jax_model().params)
    im = InferenceModel(max_batch=4, device="cpu").load_keras(tm)
    data = _data(n=3)
    out = im.predict(data["x"])
    assert out.shape == (3, 2)
    assert len(fwd) == TINY["n_block"] and not bwd and not drops


def test_dropout_training_is_seeded():
    """With dropout 0.1 everywhere: one fit seed gives one loss curve, bit
    for bit (the embedding gathers' backward is a deterministic sum), another
    seed another; the CPU route launches no kernel."""
    _, tloss = _loss_pair()
    params = _jax_model().params
    data = _data(n=16)
    before = LAUNCHES.snapshot()
    curves = []
    for seed in (0, 0, 1):
        tm = _port_model(params)
        curves.append(Estimator.from_keras(
            tm, optimizer=optimizers.adamw(LR), loss=tloss,
            device="cpu").fit(data, epochs=2, batch_size=BATCH,
                              seed=seed)["loss"])
    assert curves[0] == curves[1] and curves[0] != curves[2]
    assert np.isfinite(curves).all()
    assert LAUNCHES.snapshot() == before


def test_default_compile_and_keras_fit():
    tm = _port_model(_jax_model().params)
    tm.default_compile(lr=5e-5, total_steps=8)
    # AdamWeightDecay with warmup: no fused twin, as in the JAX package
    assert tm._optimizer_spec is None
    assert trainer._resolve_fused(tm, tm.optimizer, True) is tm.optimizer
    data = _data(n=16)
    h = tm.fit(data["x"], data["y"], batch_size=BATCH, nb_epoch=2)
    assert len(h["loss"]) == 2 and np.isfinite(h["loss"]).all()


def test_converted_weights_are_trainable():
    tm = _port_model(_jax_model().params)
    assert all(p.requires_grad for p in tm.parameters())
    # embeddings 3, embedding LN 2, pooler 2, 12 per block, classifier 2
    assert len(list(tm.parameters())) == 3 + 2 + 2 + 12 * TINY["n_block"] + 2


@pytest.mark.parametrize("kind", ["optax_adamw", "fused"])
def test_optimizer_state_round_trips(kind):
    params = _jax_model().params
    rs = np.random.RandomState(0)
    mu = jax.tree_util.tree_map(lambda a: rs.randn(*a.shape)
                                .astype(np.float32), params)
    nu = jax.tree_util.tree_map(lambda a: rs.rand(*a.shape)
                                .astype(np.float32), params)
    if kind == "fused":
        state = JFusedState(np.int32(7), mu, nu)
    else:
        state = optax.adamw(1e-3).init(params)
        state = (optax.ScaleByAdamState(np.int32(7), mu, nu),) + state[1:]
    port = convert.opt_state_from_jax(state)
    assert port.count == 7
    assert set(port.mu) == set(_port_model(params).state_dict())
    back = convert.opt_state_to_jax(port)
    assert int(back.count) == 7
    for a, b in zip(jax.tree_util.tree_leaves(back.mu),
                    jax.tree_util.tree_leaves(mu)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(back.nu),
                    jax.tree_util.tree_leaves(nu)):
        np.testing.assert_array_equal(a, b)


def _one_batch_factory(epoch):
    d = _data(n=8)
    return iter([(d["x"], d["y"], 8)])


@pytest.mark.parametrize("kwargs", [
    {"sharding_rules": True},
    {"device_cache": True, "batch_iter_factory": _one_batch_factory},
])
def test_unported_fit_arguments_raise(kwargs):
    """What the port does not run raises: sharding rules (ROADMAP work),
    and a device cache of streaming input, which has no host copy to keep
    on the device (as in the JAX package)."""
    _, tloss = _loss_pair()
    tm = _port_model(_jax_model().params, **NO_DROP)
    est = Estimator.from_keras(tm, optimizer="adam", loss=tloss,
                               device="cpu")
    match = "streaming" if "batch_iter_factory" in kwargs else "ROADMAP"
    with pytest.raises(NotImplementedError, match=match):
        est.fit(_data(n=8), batch_size=BATCH, **kwargs)


@pytest.mark.parametrize("kwargs", [
    {"metrics_report_s": 1.0}, {"prefetch_depth": 2},
    {"batch_iter_factory": _one_batch_factory},
    {"profile_steps": (0, 1)}, {"flops_per_step": 1.0},
    {"device_cache": True}, {"compile_cache_dir": "cache"},
    {"steps_per_run": 2},
    {"feature_cols": ["ids", "mask"], "label_cols": ["y"]},
])
def test_ported_fit_arguments_run(kwargs, tmp_path):
    """The telemetry, input-pipeline and program arguments that used to
    raise (or, for `steps_per_run`, change nothing) run a short fit, and
    so do a DataFrame's `feature_cols` / `label_cols`."""
    _, tloss = _loss_pair()
    tm = _port_model(_jax_model().params, **NO_DROP)
    est = Estimator.from_keras(tm, optimizer="adam", loss=tloss,
                               device="cpu")
    if "profile_steps" in kwargs:
        kwargs = dict(kwargs, profile_dir=str(tmp_path))
    if "compile_cache_dir" in kwargs:
        kwargs = dict(kwargs, compile_cache_dir=str(tmp_path / "cache"))
    data = _data(n=8)
    if "feature_cols" in kwargs:
        import pandas as pd
        (ids, mask), y = data["x"], data["y"]
        data = pd.DataFrame({"ids": list(ids), "mask": list(mask), "y": y})
    h = est.fit(data, batch_size=BATCH, **kwargs)
    assert len(h["loss"]) == 1 and np.isfinite(h["loss"][0])
    if "profile_steps" in kwargs:
        assert len(h["profile_artifacts"]) == 1


def test_estimator_guards(monkeypatch):
    _, tloss = _loss_pair()
    tm = _port_model(_jax_model().params, **NO_DROP)
    assert Estimator(tm, model_dir="/nowhere").model_dir == "/nowhere"
    import pandas as pd
    with pytest.raises(ValueError, match="needs feature_cols"):
        Estimator(tm, device="cpu").fit(pd.DataFrame({"a": [1, 2]}))
    with pytest.raises(ValueError, match="Unsupported metric"):
        Estimator.from_keras(tm, optimizer="adam", loss=tloss,
                             metrics=["no_such_metric"])
    est = Estimator.from_keras(tm, optimizer="adam", loss=tloss,
                               device="cpu")
    with pytest.raises(ValueError, match="batch"):
        est.fit(_data(n=4), batch_size=BATCH)
    h = est.fit((_data(n=8)["x"], _data(n=8)["y"]), batch_size=BATCH,
                device_cache=False, distributed=False)
    assert len(h["loss"]) == 1
    # entry points default to the card and refuse the CPU unless asked
    monkeypatch.setattr(device_mod.torch.cuda, "is_available", lambda: False)
    for est in (Estimator(tm), Estimator(tm, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            est.fit(_data(n=8), batch_size=BATCH)


@pytest.mark.gpu
def test_training_step_launches_every_kernel_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _, tloss = _loss_pair()
    params = _jax_model().params
    tm = BERTClassifier(2, use_flash=True, **TINY)
    tm.load_state_dict(convert.params_from_jax(params))
    data = _data(n=8)
    est = Estimator.from_keras(tm, optimizer=optimizers.fused_adam(LR),
                               loss=tloss)
    LAUNCHES.reset()
    h = est.fit(data, batch_size=BATCH, mixed_precision=True,
                fused_optimizer=True)
    counts = LAUNCHES.snapshot()
    n = TINY["n_block"]
    assert np.isfinite(h["loss"]).all()
    assert counts == {fa.KERNEL_NAME: n, fa.BWD_DKV_NAME: n,
                      fa.BWD_DQ_NAME: n, dr.KERNEL_NAME: 2 * (2 * n + 2),
                      fad.KERNEL_NAME: fad.sweep_launches(tm.parameters())}
    LAUNCHES.reset()
    InferenceModel(max_batch=8).load_keras(tm).predict(data["x"])
    assert LAUNCHES.snapshot() == {fa.KERNEL_NAME: n}
