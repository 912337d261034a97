"""The port's NeuralCF slice held against the JAX package on the CPU, at
the BENCH_TINY sizes of `bench_ncf.py:52` (200 users, 100 items, 4096
samples, batch 512; embeddings 64, MLP 128/64/32 as `bench_ncf.py` builds
it): the layers and the functional `Model`, the NeuralCF forward,
`Estimator.fit(lazy_embeddings=True, fused_optimizer=True)` over 3 epochs,
`evaluate`, `predict` and the ranking helpers, the metrics, mixed
precision through the fused one-step, and the conversion of weights and
optimizer state.

Both packages start from the same weights (the JAX `build`, carried across
by `convert`, which matches layers by graph order) and see the same
batches: the JAX fit runs with `distributed=False, device_cache=False`, so
it batches on the host with the port's `RandomState(seed + epoch)`
shuffle. On the CPU the JAX fit's fused path falls back to
`make_lazy_one_step` (`fused_available()` is False: the installed jax
refuses the Pallas cost estimate), the same SparseAdam step, which makes
it the oracle of the port's kernel path and of its plain path alike.

Tolerances:
- layers, `Model` and the NeuralCF forward: 1e-6 absolute (f32, the same
  operations);
- fits: per-epoch losses 1e-5; parameters within 2·lr·steps, with at most
  1e-3 of the dense parameters and touched table rows beyond 1e-6 (the
  port's kernel path folds Adam's bias correction where the oracle
  corrects the moments, so the two round differently, and Adam's m/√v can
  turn rounding in a near-zero gradient into a step of up to lr); rows no
  batch touched bitwise equal to their initial values;
- `evaluate`, `predict` and metrics: 1e-6; rankings: the same items in the
  same order, scores 1e-6;
- conversion: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.keras import Input as JInput
from analytics_zoo_tpu.keras import Model as JModel
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.learn import lazy_embedding as jlazy
from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models.recommendation import NeuralCF as JNCF
from analytics_zoo_tpu.models.recommendation import \
    UserItemFeature as JUserItemFeature
from analytics_zoo_tpu.ops import metrics as jmetrics
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input, Model
from analytics_zoo_tpu_torch.kernels import segment_update as seg
from analytics_zoo_tpu_torch.learn import lazy_embedding as lazy
from analytics_zoo_tpu_torch.learn import trainer
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.models.recommendation import (NeuralCF,
                                                           UserItemFeature)
from analytics_zoo_tpu_torch.ops import metrics, optimizers

USERS, ITEMS, N, BATCH = 200, 100, 4096, 512
CFG = dict(user_count=USERS, item_count=ITEMS, class_num=2, user_embed=64,
           item_embed=64, mf_embed=64, hidden_layers=(128, 64, 32))
LR, EPOCHS = 1e-3, 3
LOSS = "sparse_categorical_crossentropy"


@pytest.fixture(scope="module", autouse=True)
def ctx():
    c = zoo.init_orca_context(cluster_mode="local")
    yield c
    zoo.stop_orca_context()


def _data(n=N, seed=0, rule=False):
    """(x, y) as `bench_ncf.py:70-73` draws them; with `rule`, 5-class
    labels from `examples/recommendation_ncf.py`'s (u·7 + i·3) % 5."""
    rs = np.random.RandomState(seed)
    x = np.stack([rs.randint(1, USERS, n), rs.randint(1, ITEMS, n)],
                 axis=1).astype(np.int32)
    y = (x[:, 0] * 7 + x[:, 1] * 3) % 5 if rule else rs.randint(0, 2, n)
    return x, y.astype(np.int32)


def _jax_ncf(seed=1, **kw):
    j = JNCF(**dict(CFG, **kw))
    j.model.params = jax.device_get(j.model.build(jax.random.PRNGKey(seed)))
    return j


def _names(j):
    return [layer.name for layer in j.model._ordered_layers()]


def _port_ncf(j, params=None, **kw):
    t = NeuralCF(**dict(CFG, **kw), device="cpu")
    t.model.load_state_dict(convert.model_params_from_jax(
        j.model.params if params is None else params, _names(j), t.model))
    return t


def _touched(x):
    """Row masks of the rows the batches touch, per table."""
    out = {}
    for name, col, rows in (("ncf_mlp_user", 0, USERS + 1),
                            ("ncf_mf_user", 0, USERS + 1),
                            ("ncf_mlp_item", 1, ITEMS + 1),
                            ("ncf_mf_item", 1, ITEMS + 1)):
        mask = torch.zeros(rows, dtype=torch.bool)
        mask[torch.from_numpy(x[:, col]).long()] = True
        out[name] = mask
    return out


def _assert_fit_close(state, want, start, x, steps):
    """Parameters within 2·lr·steps, at most 1e-3 of the dense ones and of
    the touched rows beyond 1e-6; untouched rows bitwise initial."""
    touched = _touched(x)
    diffs = []
    for key, value in state.items():
        value = value.detach()
        layer = key.split(".")[0]
        if layer in touched:
            t = touched[layer]
            assert torch.equal(value[~t], start[key][~t]), key
            diffs.append((value[t] - want[key][t]).abs())
        else:
            diffs.append((value - want[key]).abs())
    assert max(float(d.max()) for d in diffs) <= 2 * LR * steps
    over = sum(int((d > 1e-6).sum()) for d in diffs)
    assert over <= 1e-3 * sum(d.numel() for d in diffs)


# ---------------------------------------------------------------------------
# layers and Model
# ---------------------------------------------------------------------------
def _rand(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


# name -> (JAX layer, port layer, input shapes without the batch, inputs)
def _layer_cases():
    ids = np.array([3, 0, 10, 7], np.int32)
    two = [_rand((4, 5), 1), _rand((4, 5), 2)]
    cases = {
        "dense_relu": (lambda: JL.Dense(5, activation="relu"),
                       lambda: L.Dense(5, activation="relu", device="cpu"),
                       [(7,)], [_rand((4, 7))]),
        "dense_softmax_no_bias": (
            lambda: JL.Dense(3, activation="softmax", use_bias=False),
            lambda: L.Dense(3, activation="softmax", use_bias=False,
                            device="cpu"), [(6,)], [_rand((4, 6))]),
        "dense_rank3": (lambda: JL.Dense(4), lambda: L.Dense(4, device="cpu"),
                        [(3, 6)], [_rand((2, 3, 6))]),
        "activation_tanh": (lambda: JL.Activation("tanh"),
                            lambda: L.Activation("tanh"), [(5,)],
                            [_rand((4, 5))]),
        "flatten": (JL.Flatten, L.Flatten, [(3, 2)], [_rand((4, 3, 2))]),
        "select": (lambda: JL.Select(1, 1), lambda: L.Select(1, 1), [(3,)],
                   [_rand((4, 3))]),
        "embedding_int_ids": (lambda: JL.Embedding(11, 4),
                              lambda: L.Embedding(11, 4, device="cpu"),
                              [()], [ids]),
        "embedding_float_ids": (
            lambda: JL.Embedding(11, 4),
            lambda: L.Embedding(11, 4, device="cpu"), [(2,)],
            [np.array([[3.7, 1.0], [0.2, 9.9], [10.0, 4.5], [2.0, 6.0]],
                      np.float32)]),
    }
    for mode in L.Merge.MODES:
        cases[f"merge_{mode}"] = (lambda m=mode: JL.Merge(mode=m),
                                  lambda m=mode: L.Merge(mode=m),
                                  [(5,), (5,)], two)
    return cases


LAYER_CASES = _layer_cases()


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    jmake, tmake, shapes, xs = LAYER_CASES[case]
    jlayer, tlayer = jmake(), tmake()
    nodes = [Input(s) for s in shapes]
    tlayer(nodes if len(nodes) > 1 else nodes[0])
    jshape = [(None,) + s for s in shapes]
    params = jlayer.build(jax.random.PRNGKey(0),
                          jshape if len(jshape) > 1 else jshape[0])
    with torch.no_grad():
        for name, value in params.items():
            getattr(tlayer, name).copy_(torch.from_numpy(np.array(value)))
    jx = [jnp.asarray(a) for a in xs]
    want = np.asarray(jlayer.call(params, jx if len(jx) > 1 else jx[0]))
    tx = [torch.from_numpy(a) for a in xs]
    with torch.no_grad():
        got = tlayer(tx if len(tx) > 1 else tx[0]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    node = tlayer([Input(s) for s in shapes] if len(shapes) > 1
                  else Input(shapes[0]))
    assert node.shape == jlayer.compute_output_shape(
        jshape if len(jshape) > 1 else jshape[0])


def test_initializers_and_embedding_options():
    gen = torch.Generator().manual_seed(0)
    u = L.get_init("uniform")(gen, (20000,))
    assert 0.0 <= float(u.min()) and float(u.max()) < 0.05     # [0, 0.05)
    assert abs(float(u.mean()) - 0.025) < 1e-3
    assert not L.get_init("zeros")(gen, (3, 2)).any()
    w = _rand((6, 3))
    emb = L.Embedding(6, 3, weights=w, trainable=False, device="cpu")
    emb.build(gen)
    np.testing.assert_array_equal(emb.embeddings.detach().numpy(), w)
    assert emb.embeddings.requires_grad
    assert not emb(torch.tensor([1, 2])).requires_grad    # stop_gradient
    with pytest.raises(ValueError, match="pretrained"):
        L.Embedding(5, 3, weights=w, device="cpu").build(gen)
    with pytest.raises(ValueError, match="merge mode"):
        L.Merge(mode="nope")


def test_model_graph_registers_layers_in_graph_order():
    inp = Input((4,))
    shared = L.Dense(3, device="cpu", name="shared")
    a = shared(inp)
    b = shared(L.Dense(4, device="cpu", name="first")(inp))
    out = L.merge([a, b], mode="sum", name="join")
    model = Model(inp, out)
    assert [l.name for l in model.ordered_layers()] == ["shared", "first",
                                                        "join"]
    assert list(model.state_dict()) == ["shared.kernel", "shared.bias",
                                        "first.kernel", "first.bias"]
    model.ensure_built(seed=3)
    x = torch.from_numpy(_rand((2, 4)))
    with torch.no_grad():
        y = model(x)
        want = shared(x) + shared(model.first(x))
    assert torch.equal(y, want)
    with pytest.raises(ValueError, match="Duplicate layer name"):
        Model(inp, L.Dense(2, device="cpu", name="shared")(a))
    with pytest.raises(ValueError, match="expects 1 inputs"):
        model([x, x])


@pytest.mark.parametrize("include_mf", [True, False])
def test_neuralcf_forward_matches_jax(include_mf):
    j = _jax_ncf(include_mf=include_mf)
    t = _port_ncf(j, include_mf=include_mf)
    x, _ = _data(n=64)
    want = np.asarray(j.model.apply(j.model.params, jnp.asarray(x)))
    with torch.no_grad():
        got = t.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    names = {s.path[0] for s in t.model.lazy_embedding_specs}
    assert names == ({"ncf_mlp_user", "ncf_mlp_item", "ncf_mf_user",
                      "ncf_mf_item"} if include_mf
                     else {"ncf_mlp_user", "ncf_mlp_item"})


# ---------------------------------------------------------------------------
# the slice: Estimator.fit with lazy embeddings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [True, False])
def test_lazy_fit_matches_jax(fused):
    """`fused=True` is the slice's kernel path (segment Adam + fused Adam,
    their plain versions on the CPU); `fused=False` the port's plain path
    (`make_lazy_one_step`)."""
    j = _jax_ncf()
    init, names = j.model.params, _names(j)
    x, y = _data()
    jh = JEstimator.from_keras(j.model, optimizer="adam", loss=LOSS).fit(
        (x, y), epochs=EPOCHS, batch_size=BATCH, lazy_embeddings=True,
        fused_optimizer=True, distributed=False, device_cache=False)
    t = _port_ncf(j, init)
    th = Estimator.from_keras(t.model, optimizer="adam", loss=LOSS,
                              device="cpu").fit(
        (x, y), epochs=EPOCHS, batch_size=BATCH, steps_per_run=4,
        lazy_embeddings=True, fused_optimizer=fused)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=1e-5)
    want = convert.model_params_from_jax(jax.device_get(j.model.params),
                                         names, t.model)
    start = convert.model_params_from_jax(init, names, t.model)
    _assert_fit_close(t.model.state_dict(), want, start, x,
                      EPOCHS * N // BATCH)


def test_fused_step_forms_no_vocabulary_sized_gradient(monkeypatch):
    """The rows-reindexed backward: each table's gradient is [B, dim] and
    nothing of a table's shape comes out of autograd; every table takes
    one segment update a step."""
    j = _jax_ncf()
    t = _port_ncf(j)
    shapes, updates = [], []
    real_grad, real_update = torch.autograd.grad, seg.segment_adam_update

    def grad(*a, **k):
        out = real_grad(*a, **k)
        shapes.extend(tuple(g.shape) for g in out if g is not None)
        return out

    def update(table, mu, nu, ids, d_rows, *a, **k):
        updates.append((tuple(table.shape), tuple(d_rows.shape),
                        d_rows.dtype))
        return real_update(table, mu, nu, ids, d_rows, *a, **k)
    monkeypatch.setattr(torch.autograd, "grad", grad)
    monkeypatch.setattr(seg, "segment_adam_update", update)
    x, y = _data(n=2 * BATCH)
    Estimator.from_keras(t.model, optimizer="adam", loss=LOSS,
                         device="cpu").fit(
        (x, y), batch_size=BATCH, lazy_embeddings=True, fused_optimizer=True)
    assert (USERS + 1, 64) not in shapes and (ITEMS + 1, 64) not in shapes
    assert len(updates) == 2 * 4
    assert {u[1] for u in updates} == {(BATCH, 64)}
    assert {u[2] for u in updates} == {torch.float32}


def test_dense_cotangent_specs_match_reindexed():
    """Specs without `set_ids_fn` take the dense gradient and
    `_dedup_rows`; they train as the reindexed path does, to rounding."""
    j = _jax_ncf()
    x, y = _data(n=2 * BATCH)
    states, losses = [], []
    for reindex in (True, False):
        t = _port_ncf(j)
        if not reindex:
            t.model.lazy_embedding_specs = [
                s._replace(set_ids_fn=None)
                for s in t.model.lazy_embedding_specs]
        h = Estimator.from_keras(t.model, optimizer="adam", loss=LOSS,
                                 device="cpu").fit(
            (x, y), epochs=2, batch_size=BATCH, lazy_embeddings=True,
            fused_optimizer=True)
        states.append(t.model.state_dict())
        losses.append(h["loss"])
    np.testing.assert_allclose(losses[1], losses[0], rtol=0, atol=1e-6)
    sd = convert.model_params_from_jax(j.model.params, _names(j), t.model)
    start = {k: sd[k] for k in t.model.state_dict()}     # graph order
    want = dict(zip(start, states[0].values()))
    got = dict(zip(start, states[1].values()))
    _assert_fit_close(got, want, start, x, 4)


def test_mixed_precision_through_the_fused_step():
    """bf16 compute with f32 masters: the loss falls over 4 epochs on the
    example's learnable rule, tables stay f32, untouched rows bitwise."""
    j = _jax_ncf(class_num=5)
    t = _port_ncf(j, class_num=5)
    start = {k: v.clone() for k, v in t.model.state_dict().items()}
    x, y = _data(n=8 * BATCH, rule=True)
    h = Estimator.from_keras(t.model, optimizer="adam", loss=LOSS,
                             device="cpu").fit(
        (x, y), epochs=4, batch_size=BATCH, lazy_embeddings=True,
        fused_optimizer=True, mixed_precision=True)
    assert np.isfinite(h["loss"]).all() and h["loss"][-1] < h["loss"][0]
    touched = _touched(x)
    for key, value in t.model.state_dict().items():
        assert value.dtype == torch.float32
        layer = key.split(".")[0]
        if layer in touched:
            m = touched[layer]
            assert torch.equal(value[~m], start[key][~m])
            assert not torch.equal(value[m], start[key][m])


def test_lazy_fit_guards(caplog):
    j = _jax_ncf()
    t = _port_ncf(j)
    x, y = _data(n=BATCH)
    est = Estimator.from_keras(t.model, optimizer="adamw", loss=LOSS,
                               device="cpu")
    with pytest.raises(ValueError, match="inherits adam defaults"):
        est.fit((x, y), batch_size=BATCH, lazy_embeddings=True)
    # explicit row-Adam hyperparameters and a compiled optimizer with no
    # fused twin: the tables stay on the segment path, with a warning
    t.model.lazy_embedding_specs = [s._replace(lr=LR) for s in
                                    t.model.lazy_embedding_specs]
    t.model.compile(optimizers.adamw(LR), LOSS)
    calls = []
    real = seg.segment_adam_update

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    seg.segment_adam_update = spy
    try:
        h = Estimator(t.model, device="cpu").fit(
            (x, y), batch_size=BATCH, lazy_embeddings=True,
            fused_optimizer=True)
    finally:
        seg.segment_adam_update = real
    assert len(calls) == 4 and np.isfinite(h["loss"]).all()
    assert "fused segment path" in caplog.text
    bert_like = Model(Input((3,)), L.Dense(2, device="cpu")(Input((3,))))
    bert_like.compile("adam", LOSS)
    with pytest.raises(ValueError, match="no lazy_embedding_specs"):
        bert_like.fit(np.zeros((4, 3), np.float32),
                      np.zeros(4, np.int32), batch_size=4,
                      lazy_embeddings=True)


# ---------------------------------------------------------------------------
# evaluate, predict, ranking, metrics
# ---------------------------------------------------------------------------
def _trained_pair():
    j = _jax_ncf(class_num=5)
    t = _port_ncf(j, class_num=5)
    return j, t


@pytest.mark.parametrize("metric_list", [["accuracy"], None])
def test_evaluate_and_predict_match_jax(metric_list):
    """1000 pairs in batches of 256: three whole batches and a padded
    tail; `None` evaluates the compiled loss."""
    j, t = _trained_pair()
    j.compile("adam", LOSS, metric_list)
    t.compile("adam", LOSS, metric_list)
    x, y = _data(n=1000, seed=3, rule=True)
    want = j.evaluate(x, y, batch_per_thread=256)
    got = t.evaluate(x, y, batch_per_thread=256)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    np.testing.assert_allclose(t.predict(x, batch_per_thread=256),
                               np.asarray(j.predict(x, batch_per_thread=256)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        t.predict_classes(x, batch_per_thread=256, zero_based_label=False),
        j.predict_classes(x, batch_per_thread=256, zero_based_label=False))


def test_recommend_for_user_and_item_match_jax():
    j, t = _trained_pair()
    users = [5, 17, 123]
    tc = [UserItemFeature(u, i) for u in users for i in range(1, ITEMS + 1)]
    jc = [JUserItemFeature(u, i) for u in users for i in range(1, ITEMS + 1)]
    for got, want in ((t.recommend_for_user(tc, max_items=4),
                       j.recommend_for_user(jc, max_items=4)),
                      (t.recommend_for_item(tc, max_users=2),
                       j.recommend_for_item(jc, max_users=2))):
        assert set(got) == set(want)
        for key in want:
            assert [i for i, _ in got[key]] == [i for i, _ in want[key]]
            np.testing.assert_allclose([s for _, s in got[key]],
                                       [s for _, s in want[key]], rtol=0,
                                       atol=1e-6)
    scores = t.predict_user_item_pair(tc)[:, -1]
    top = torch.topk(torch.from_numpy(scores[:ITEMS]), 4)
    assert [i for i, _ in t.recommend_for_user(tc, 4)[5]] == \
        [int(i) + 1 for i in top.indices]


def _metric_inputs(name):
    rs = np.random.RandomState(7)
    probs = rs.dirichlet(np.ones(6), 40).astype(np.float32)
    if name in ("sparse_categorical_accuracy", "top5accuracy", "accuracy"):
        return rs.randint(0, 6, 40).astype(np.int32), probs
    if name == "categorical_accuracy":
        return np.eye(6, dtype=np.float32)[rs.randint(0, 6, 40)], probs
    score = rs.uniform(size=(40, 1)).astype(np.float32)
    label = rs.randint(0, 2, (40, 1)).astype(np.float32)
    return label, score


@pytest.mark.parametrize("name", [
    "sparse_categorical_accuracy", "categorical_accuracy", "binary_accuracy",
    "top5accuracy", "mae", "mse", "auc", "accuracy"])
def test_metric_matches_jax(name):
    """Two batches accumulated, then computed."""
    y, p = _metric_inputs(name)
    jm, tm = jmetrics.get(name), metrics.get(name)
    assert type(tm).__name__ == type(jm).__name__ and tm.name == jm.name
    js, ts = jm.init(), tm.init()
    for sl in (slice(0, 25), slice(25, 40)):
        js = jm.update(js, jnp.asarray(y[sl]), jnp.asarray(p[sl]))
        ts = tm.update(ts, torch.from_numpy(y[sl]), torch.from_numpy(p[sl]))
    assert abs(float(tm.compute(ts)) - float(jm.compute(js))) <= 1e-6


def test_metric_registry_matches_jax():
    for loss in ("sparse_categorical_crossentropy",
                 "categorical_crossentropy", "binary_crossentropy", None):
        assert type(metrics.get("accuracy", loss)).__name__ == \
            type(jmetrics.get("accuracy", loss)).__name__
    with pytest.raises(ValueError, match="combination"):
        metrics.get("acc", "mse")
    with pytest.raises(ValueError, match="Unsupported metric"):
        metrics.get("no_such_metric")
    loss = metrics.Loss(LOSS)
    y, p = _metric_inputs("accuracy")
    jl = jmetrics.Loss(LOSS)
    want = jl.compute(jl.update(jl.init(), jnp.asarray(y), jnp.asarray(p)))
    got = loss.compute(loss.update(loss.init(), torch.from_numpy(y),
                                   torch.from_numpy(p)))
    assert abs(float(got) - float(want)) <= 1e-6


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------
def test_model_params_round_trip_by_graph_order():
    j = _jax_ncf()
    names = _names(j)
    NeuralCF(**CFG, device="cpu")         # moves the port's name counters
    t = NeuralCF(**CFG, device="cpu")     # so: other auto names than j's
    assert [l.name for l in t.model.ordered_layers()] != names
    t.model.load_state_dict(convert.model_params_from_jax(
        j.model.params, names, t.model))
    back = convert.model_params_to_jax(t.model.state_dict(), names, t.model)
    assert list(back) == names
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(j.model.params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(j.model.params)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="layers"):
        convert.model_params_from_jax(j.model.params, names[:-1], t.model)


def test_lazy_state_round_trip():
    """The JAX `init_state` (optax adam over the rest, with None at the
    tables) filled with random values → the port's layout → back."""
    j = _jax_ncf()
    j.compile("adam", LOSS)
    names = _names(j)
    specs = jlazy.resolve_specs(j.model)
    state = jlazy.init_state(j.model.params, specs, optax.adam(LR))
    rs = np.random.RandomState(9)
    state = jax.tree_util.tree_map(
        lambda a: rs.standard_normal(np.shape(a)).astype(np.float32)
        if np.ndim(a) else a, state)
    state["t"] = np.int32(5)
    t = NeuralCF(**CFG, device="cpu")
    port = convert.lazy_state_from_jax(state, names, t.model)
    fresh = lazy.init_state(dict(t.model.named_parameters()),
                            lazy.resolve_specs(_compiled(t)),
                            optimizers.fused_adam(LR))
    assert port["t"] == 5 and set(port["tables"]) == set(fresh["tables"])
    assert set(port["rest"].mu) == set(fresh["rest"].mu)
    for key, (mu, nu) in port["tables"].items():
        assert mu.shape == fresh["tables"][key][0].shape
    back = convert.lazy_state_to_jax(port, names, t.model)
    adam = state["rest"][0]
    assert int(back["t"]) == 5 and int(back["rest"].count) == int(adam.count)
    for got, want in ((back["rest"].mu, adam.mu), (back["rest"].nu, adam.nu),
                      (back["tables"], state["tables"])):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)


def _compiled(t):
    t.model.compile("adam", LOSS)
    return t.model


def test_trainer_picks_the_one_step():
    j = _jax_ncf()
    t = _port_ncf(j)
    model = _compiled(t)
    specs = lazy.resolve_specs(model)
    fused = trainer._pick_one_step(model, model.loss, model.optimizer, False,
                                   specs, True)
    plain = trainer._pick_one_step(model, model.loss, model.optimizer, False,
                                   specs, False)
    dense = trainer._pick_one_step(model, model.loss, model.optimizer, False,
                                   None, True)
    assert fused.__qualname__.startswith("make_fused_one_step")
    assert plain.__qualname__.startswith("make_lazy_one_step")
    assert dense.__qualname__.startswith("build_train_step")
