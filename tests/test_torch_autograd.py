"""The port's autograd DSL and nested models held against the JAX package
on the CPU: every `Variable` operator and math function, `Lambda` and
`pad_lambda`, `Parameter` and `Constant`, `CustomLoss` and a fit on it, a
functional `Model` nested as a layer behind a `Lambda` head (uint8 input,
the normalisation of `examples/inception_imagenet.py`), and
`SessionRecommender(include_history=True)`, whose history branch sums
through a `Lambda`.

Both packages take the same weights: the port's, drawn from a seed,
carried to the JAX tree by `convert`. Inputs come from numpy with a seed.
Sizes are small (widths <= 16, a 32×32 image into a nested LeNet-5).

Tolerances (absolute):
- each op and `Lambda`, `Parameter`, `Constant` and `CustomLoss` values,
  f32: 1e-6 (one or two roundings of values below 10);
- a nested model's forward, f32: 1e-5; its 3-step f32 fit (Adam at lr
  1e-3, one batch an epoch, the JAX fit with host batches): per-step
  losses 1e-4, moving statistics 1e-4; its bf16 fit (mixed precision):
  per-step losses 5e-2 against the JAX bf16 fit;
- the `CustomLoss` fit and `SessionRecommender(include_history=True)`:
  forward 1e-5, 3-step losses 1e-5.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.keras import Input as JInput
from analytics_zoo_tpu.keras import Model as JModel
from analytics_zoo_tpu.keras import Sequential as JSequential
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models import image as jimage
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.ops import autograd as JA
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input, Model, Sequential
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.models import image as timage
from analytics_zoo_tpu_torch.models import recommendation as trec
from analytics_zoo_tpu_torch.ops import autograd as TA
from analytics_zoo_tpu_torch.ops import objectives, optimizers

OP_TOL = 1e-6
TOL = 1e-5
FIT_TOL = 1e-4
LOSS_FIT_TOL = 1e-5
BF16_FIT_TOL = 5e-2
FIT_LR = 1e-3
FIT_STEPS = 3
BATCH = 5
CLS_LOSS = "sparse_categorical_crossentropy"
MEAN = np.array([123.0, 117.0, 104.0], np.float32)
STD = np.array([58.4, 57.1, 57.4], np.float32)


@pytest.fixture(scope="module", autouse=True)
def ctx():
    c = zoo.init_orca_context(cluster_mode="local")
    yield c
    zoo.stop_orca_context()


def names(jmodel):
    return [(l.name, names(l)) if hasattr(l, "_ordered_layers") else l.name
            for l in jmodel._ordered_layers()]


def share(tmodel, jmodel, seed=0):
    """Build the port model from `seed`; give the JAX model the same
    weights."""
    tmodel.ensure_built(seed=seed)
    jmodel.params = convert.model_params_to_jax(
        tmodel.state_dict(), names(jmodel), tmodel)
    return jmodel.params


def rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Variable operators and math functions
# ---------------------------------------------------------------------------
S = (3, 4)
# (name, input shapes without the batch, fn(autograd module, *variables))
OPS = [
    ("add", [S, S], lambda A, x, y: x + y),
    ("add_const", [S], lambda A, x: x + 2.0),
    ("radd", [S], lambda A, x: 2.0 + x),
    ("sub", [S, S], lambda A, x, y: x - y),
    ("rsub", [S], lambda A, x: 1.5 - x),
    ("mul", [S, S], lambda A, x, y: x * y),
    ("rmul", [S], lambda A, x: 3.0 * x),
    ("div", [S, S], lambda A, x, y: x / (A.abs(y) + 1.0)),
    ("rdiv", [S], lambda A, x: 1.0 / (A.abs(x) + 1.0)),
    ("pow_op", [S], lambda A, x: A.abs(x) ** 1.5),
    ("neg_op", [S], lambda A, x: -x),
    ("getitem", [S], lambda A, x: x[:, 1:3]),
    ("slice", [S], lambda A, x: x.slice(1, 1, 2)),
    ("slice_to_end", [S], lambda A, x: x.slice(2, 1, -1)),
    ("index_select", [S], lambda A, x: x.index_select(2, -1)),
    ("squeeze_dim", [(3, 1, 4)], lambda A, x: x.squeeze(2)),
    ("squeeze_all", [(1, 3, 1)], lambda A, x: x.squeeze()),
    ("abs", [S], lambda A, x: A.abs(x)),
    ("square", [S], lambda A, x: A.square(x)),
    ("sqrt", [S], lambda A, x: A.sqrt(A.abs(x))),
    ("exp", [S], lambda A, x: A.exp(x)),
    ("log", [S], lambda A, x: A.log(A.abs(x) + 0.5)),
    ("neg", [S], lambda A, x: A.neg(x)),
    ("erf", [S], lambda A, x: A.erf(x)),
    ("softsign", [S], lambda A, x: A.softsign(x)),
    ("softplus", [S], lambda A, x: A.softplus(x * 4.0)),
    ("sum", [S], lambda A, x: A.sum(x, axis=1)),
    ("sum_keepdims", [S], lambda A, x: A.sum(x, axis=-1, keepdims=True)),
    ("sum_batch", [S], lambda A, x: A.sum(x)),
    ("mean", [S], lambda A, x: A.mean(x, axis=2)),
    ("clip", [S], lambda A, x: A.clip(x, -0.5, 0.7)),
    ("pow", [S], lambda A, x: A.pow(A.abs(x), 2.5)),
    ("maximum", [S, S], lambda A, x, y: A.maximum(x, y)),
    ("maximum_const", [S], lambda A, x: A.maximum(x, 0.1)),
    ("mm", [(3, 4), (4, 2)], lambda A, x, y: A.mm(x, y)),
    ("mm_axes", [(3, 4), (5, 4)], lambda A, x, y: A.mm(x, y, axes=[2, 2])),
    ("mm_axes_first", [(4, 3), (4, 2)],
     lambda A, x, y: A.mm(x, y, axes=[1, 1])),
    ("dot", [S, S], lambda A, x, y: A.dot(x, y)),
    ("dot_normalize", [S, S], lambda A, x, y: A.dot(x, y, normalize=True)),
    ("l2_normalize", [S], lambda A, x: A.l2_normalize(x, axis=1)),
    ("slice_fn", [S], lambda A, x: A.slice(x, 1, 0, 2)),
    ("index_select_fn", [S], lambda A, x: A.index_select(x, 1, 1)),
    ("softmax", [S], lambda A, x: A.softmax(x)),
    ("softmax_axis", [S], lambda A, x: A.softmax(x, axis=1)),
    ("expand_dims", [S], lambda A, x: A.expand_dims(x, 1)),
    ("expand_dims_last", [S], lambda A, x: A.expand_dims(x, -1)),
    ("squeeze_fn", [(3, 1)], lambda A, x: A.squeeze(x, 2)),
    ("stack", [S, S], lambda A, x, y: A.stack([x, y])),
    ("concatenate", [S, S], lambda A, x, y: A.concatenate([x, y], axis=1)),
    ("chain", [S, S],
     lambda A, x, y: A.mean(A.square(x - y) * 0.5 + A.exp(-A.abs(x)),
                            axis=2)),
]


def _run_graph(A, Model_, shapes, fn, xs):
    vs = [A.Variable(input_shape=s) for s in shapes]
    out = fn(A, *vs)
    return out, Model_(vs if len(vs) > 1 else vs[0], out)


@pytest.mark.parametrize("name, shapes, fn", OPS, ids=[o[0] for o in OPS])
def test_variable_op_matches_jax(name, shapes, fn):
    xs = [rand((BATCH,) + s, i) for i, s in enumerate(shapes)]
    jout, jm = _run_graph(JA, JModel, shapes, fn, xs)
    tout, tm = _run_graph(TA, Model, shapes, fn, xs)
    assert tout.shape == jout.shape
    assert [type(l).__name__ for l in tm.ordered_layers()] == [
        type(l).__name__ for l in jm._ordered_layers()]
    assert [l.name.rsplit("_", 1)[0] for l in tm.ordered_layers()] == [
        l.name.rsplit("_", 1)[0] for l in jm._ordered_layers()]
    jparams = jm.build(jax.random.PRNGKey(0))
    want = np.asarray(jm.apply(jparams, xs if len(xs) > 1 else xs[0]))
    tm.ensure_built()
    got = tm.apply([torch.from_numpy(x) for x in xs]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)


def test_variable_checks():
    x = TA.Variable(input_shape=(3, 4))
    with pytest.raises(ValueError, match="batch dimension"):
        x.slice(0, 0, 1)
    with pytest.raises(ValueError, match="out of range"):
        x.index_select(3, 0)
    with pytest.raises(IndexError, match="out of range"):
        x.index_select(1, 3)
    with pytest.raises(ValueError, match="input_shape or node"):
        TA.Variable()


def test_lambda_and_pad_lambda_match_jax():
    """`Lambda` from a function of one and of two inputs, in a functional
    graph and first in a `Sequential` with `input_shape`; `pad_lambda`."""
    x, y = rand((BATCH, 3, 4), 1), rand((BATCH, 3, 4), 2)

    def both(A, L_, Model_, In):
        a, b = In(shape=(3, 4)), In(shape=(3, 4))
        h = A.Lambda(lambda s, t: s * t + 1.0)([a, b])
        return Model_([a, b], L_.Dense(2, activation="tanh",
                                       **dev(L_))(h))

    def dev(L_):
        return {"device": "cpu"} if L_ is L else {}
    tm, jm = both(TA, L, Model, Input), both(JA, JL, JModel, JInput)
    params = share(tm, jm, seed=3)
    np.testing.assert_allclose(
        tm.apply([torch.from_numpy(x), torch.from_numpy(y)]).detach().numpy(),
        np.asarray(jm.apply(params, [x, y])), rtol=0, atol=OP_TOL)

    tseq = Sequential([TA.Lambda(lambda t: t + 1.0, input_shape=(3, 4))])
    jseq = JSequential([JA.Lambda(lambda t: t + 1.0, input_shape=(3, 4))])
    tseq.ensure_built()
    got = tseq.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x + 1.0, rtol=0, atol=OP_TOL)
    np.testing.assert_allclose(got, jseq.predict(x, batch_per_thread=4),
                               rtol=0, atol=OP_TOL)

    cfg = ((0, 0), (1, 2), (0, 1))
    tpad, jpad = TA.pad_lambda(cfg, -1.5), JA.pad_lambda(cfg, -1.5)
    assert tpad.compute_output_shape((None, 3, 4)) == \
        jpad.compute_output_shape((None, 3, 4)) == (None, 6, 5)
    np.testing.assert_array_equal(tpad(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpad.call({}, x)))


def test_lambda_shape_inference_follows_captured_tensors():
    """The dummies of shape inference go where the function's captured
    tensors live; an integer input keeps its dtype until the function
    casts it, and the float result matches the JAX package's."""
    mean = torch.from_numpy(MEAN)
    lam = TA.Lambda(lambda t: (t.float() - mean) / 2.0)
    assert TA._captured_device(lam.function) == torch.device("cpu")
    assert lam.compute_output_shape((None, 2, 2, 3)) == (None, 2, 2, 3)
    img = np.random.RandomState(4).randint(0, 256, (2, 2, 2, 3)).astype(
        np.uint8)
    out = lam(torch.from_numpy(img))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), (img - MEAN) / 2.0, rtol=0,
                               atol=OP_TOL)
    meta = torch.zeros(3, device="meta")
    assert TA._captured_device(lambda t, m=meta: t + m) == \
        torch.device("meta")


# ---------------------------------------------------------------------------
# Parameter, Constant
# ---------------------------------------------------------------------------
def _linear(A, Model_, dev):
    inp = A.Variable(input_shape=(4,))
    w = A.Parameter((4, 2), name="w", **dev)
    b = A.Parameter((2,), name="b", **dev)
    c = A.Constant(np.array([0.5, -2.0], np.float32), name="c", **dev)
    return Model_(inp, A.mm(inp, w) + b * c), w, b


def test_parameter_and_constant_match_jax():
    tm, tw, tb = _linear(TA, Model, {"device": "cpu"})
    jm, jw, jb = _linear(JA, JModel, {})
    assert {"w", "b", "c"} <= {l.name for l in tm.ordered_layers()}
    assert [type(l).__name__ for l in tm.ordered_layers()] == [
        type(l).__name__ for l in jm._ordered_layers()]
    assert "c.data" not in tm.state_dict()
    assert sorted(tm.state_dict()) == ["b.value", "w.value"]
    params = share(tm, jm, seed=5)
    assert params["c"] == {}
    np.testing.assert_array_equal(tw.get_weight(), np.asarray(
        jw.get_weight(params)))
    x = rand((BATCH, 4), 6)
    np.testing.assert_allclose(
        tm.apply(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jm.apply(params, x)), rtol=0, atol=OP_TOL)
    tb.set_weight(np.ones(2, np.float32))
    np.testing.assert_array_equal(tb.get_weight(), np.ones(2))
    with pytest.raises(ValueError, match="shape"):
        tb.set_weight(np.ones(3, np.float32))
    init = TA.Parameter((2, 2), init_weight=np.eye(2), device="cpu")
    init._layer.build(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(init.get_weight(), np.eye(2))


def test_frozen_parameter_stays_through_a_fit():
    inp = TA.Variable(input_shape=(3,))
    w = TA.Parameter((3, 1), name="w_free", device="cpu")
    k = TA.Parameter((1,), name="k_frozen", trainable=False, device="cpu")
    m = Model(inp, TA.mm(inp, w) + k)
    m.compile("adam", "mse")
    m.ensure_built(seed=1)
    w0, k0 = w.get_weight(), k.get_weight()
    m.fit(rand((8, 3), 7), rand((8, 1), 8), batch_size=4, nb_epoch=2)
    assert not np.array_equal(w.get_weight(), w0)
    np.testing.assert_array_equal(k.get_weight(), k0)


# ---------------------------------------------------------------------------
# CustomLoss
# ---------------------------------------------------------------------------
def _mae(A):
    """`examples/autograd_custom_loss.py:30-35`."""
    y_true = A.Variable(input_shape=(1,))
    y_pred = A.Variable(input_shape=(1,))
    return A.CustomLoss(A.mean(A.abs(y_true - y_pred), axis=1), y_true,
                        y_pred)


def _squared(A):
    y_true = A.Variable(input_shape=(3,))
    y_pred = A.Variable(input_shape=(3,))
    return A.CustomLoss(A.sum(A.square(y_true - y_pred) * 0.5, axis=1),
                        y_true, y_pred)


@pytest.mark.parametrize("make, width", [(_mae, 1), (_squared, 3)])
def test_custom_loss_values_match_jax(make, width):
    yt, yp = rand((7, width), 9), rand((7, width), 10)
    got = make(TA)(torch.from_numpy(yt), torch.from_numpy(yp))
    want = float(make(JA)(yt, yp))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=0, atol=OP_TOL)
    # float64 labels are taken as float32
    np.testing.assert_allclose(
        float(make(TA)(yt.astype(np.float64), torch.from_numpy(yp))), want,
        rtol=0, atol=OP_TOL)
    loss = make(TA)
    assert objectives.get(loss) is loss


@pytest.mark.parametrize("fused", [True, False])
def test_custom_loss_fit_matches_jax(fused):
    """The example's model and mean-absolute-error loss: a 3-step fit on
    shared weights, fused Adam (its plain version here) or plain Adam."""
    tm = Sequential([L.Dense(8, input_shape=(4,), activation="relu",
                             device="cpu"), L.Dense(1, device="cpu")])
    jm = JSequential([JL.Dense(8, input_shape=(4,), activation="relu"),
                      JL.Dense(1)])
    share(tm, jm, seed=11)
    rs = np.random.RandomState(12)
    x = rs.rand(16, 4).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True) + 1.0).astype(np.float32)
    jh = JEstimator.from_keras(jm, optimizer=optax.adam(FIT_LR),
                               loss=_mae(JA)).fit(
        (x, y), epochs=FIT_STEPS, batch_size=16, distributed=False,
        device_cache=False)
    opt = optimizers.fused_adam(FIT_LR) if fused else optimizers.adam(FIT_LR)
    th = Estimator.from_keras(tm, optimizer=opt, loss=_mae(TA),
                              device="cpu").fit(
        (x, y), epochs=FIT_STEPS, batch_size=16, fused_optimizer=fused)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0,
                               atol=LOSS_FIT_TOL)
    assert th["loss"][-1] < th["loss"][0]


# ---------------------------------------------------------------------------
# a nested Model behind a Lambda head
# ---------------------------------------------------------------------------
def _normalize(A, mean, std):
    """`examples/inception_imagenet.py:105-111`'s normalisation of uint8
    images, cast to float32 inside."""
    if A is TA:
        m, s = torch.from_numpy(mean), torch.from_numpy(std)
        return TA.Lambda(lambda x: (x.float() - m) / s)
    import jax.numpy as jnp
    m, s = jnp.asarray(mean), jnp.asarray(std)
    return JA.Lambda(lambda x: (jnp.asarray(x, jnp.float32) - m) / s)


IMG = (32, 32, 1)


def _nested_lenet(A, Input_, Model_, trunk):
    inp = Input_(shape=IMG)
    h = _normalize(A, MEAN[:1], STD[:1])(inp)
    # LeNet-5 is channels-first, as its Caffe lineage
    h = A.Lambda(lambda t: t.permute(0, 3, 1, 2) if A is TA
                 else t.transpose(0, 3, 1, 2))(h)
    return Model_(inp, trunk(h))


def nested_pair(seed=0):
    tm = _nested_lenet(TA, Input, Model, timage.lenet(
        5, (1, 32, 32), device="cpu"))
    jm = _nested_lenet(JA, JInput, JModel, jimage.lenet(5, (1, 32, 32)))
    params = share(tm, jm, seed=seed)
    return tm, jm, params


def images(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n,) + IMG).astype(
        np.uint8)


def test_nested_model_forward_matches_jax():
    tm, jm, params = nested_pair(seed=13)
    assert [type(l).__name__ for l in tm.ordered_layers()] == [
        "LambdaLayer", "LambdaLayer", "Model"]
    trunk = tm.ordered_layers()[-1]
    assert all(k.startswith(trunk.name + ".") for k in tm.state_dict())
    assert tm.compute_output_shape(None) == (None, 5)
    x = images(6, 14)
    got = tm.predict(x, batch_per_thread=4)
    assert got.shape == (6, 5)
    np.testing.assert_allclose(got, jm.predict(x, batch_per_thread=4),
                               rtol=0, atol=TOL)
    # the nested trunk fed the normalised batch gives the same
    flat = ((x.astype(np.float32) - MEAN[:1]) / STD[:1]).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(
        trunk.apply(torch.from_numpy(flat)).detach().numpy(), got, rtol=0,
        atol=TOL)


def _bn_trunk(L_, In, Model_, dev):
    inp = In(shape=(6,))
    h = L_.Dense(8, **dev)(inp)
    h = L_.BatchNormalization(**dev)(h)
    h = L_.Dropout(0.0)(L_.Activation("relu")(h))
    return Model_(inp, L_.Dense(3, activation="softmax", **dev)(h))


def _bn_nested(A, L_, In, Model_, dev):
    inp = In(shape=(6,))
    h = A.Lambda(lambda t: t * 0.5 + 1.0)(inp)
    return Model_(inp, _bn_trunk(L_, In, Model_, dev)(h))


@pytest.mark.parametrize("kind", ["lenet_uint8", "batchnorm"])
def test_nested_model_fit_matches_jax(kind):
    """3 steps, f32: the losses, and for the BatchNorm trunk the moving
    statistics, which come back from the nested model keyed by path."""
    if kind == "lenet_uint8":
        tm, jm, _ = nested_pair(seed=15)
        x, y = images(8, 16), np.arange(8, dtype=np.int32) % 5
    else:
        tm = _bn_nested(TA, L, Input, Model, {"device": "cpu"})
        jm = _bn_nested(JA, JL, JInput, JModel, {})
        share(tm, jm, seed=17)
        x, y = rand((8, 6), 18), np.arange(8, dtype=np.int32) % 3
    jh = JEstimator.from_keras(jm, optimizer=optax.adam(FIT_LR),
                               loss=CLS_LOSS).fit(
        (x, y), epochs=FIT_STEPS, batch_size=8, distributed=False,
        device_cache=False)
    th = Estimator.from_keras(tm, optimizer="adam", loss=CLS_LOSS,
                              device="cpu").fit(
        (x, y), epochs=FIT_STEPS, batch_size=8, fused_optimizer=True)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=FIT_TOL)
    want = convert.model_params_from_jax(jax.device_get(jm.params),
                                         names(jm), tm)
    for key, value in tm.state_dict().items():
        if "moving" in key:
            np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                       rtol=0, atol=FIT_TOL, err_msg=key)
    if kind == "batchnorm":
        assert any("moving" in k for k in tm.state_dict())


def test_nested_model_bf16_fit_matches_jax():
    """Mixed precision: the Lambda yields float32 from uint8, the nested
    trunk's first convolution meets it with its bf16 weights."""
    tm, jm, _ = nested_pair(seed=19)
    x, y = images(8, 20), np.arange(8, dtype=np.int32) % 5
    jh = JEstimator.from_keras(jm, optimizer=optax.adam(FIT_LR),
                               loss=CLS_LOSS).fit(
        (x, y), epochs=FIT_STEPS, batch_size=8, distributed=False,
        device_cache=False, mixed_precision=True)
    th = Estimator.from_keras(tm, optimizer="adam", loss=CLS_LOSS,
                              device="cpu").fit(
        (x, y), epochs=FIT_STEPS, batch_size=8, mixed_precision=True,
        fused_optimizer=True)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0,
                               atol=BF16_FIT_TOL)
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_nested_model_seeds_its_dropout_sites_from_its_node_seed():
    """The nested model's node gets `site_seed(seed, i)` and splits it
    again for its own nodes: its Dropout draws the same mask as the same
    trunk run alone on that seed."""
    from analytics_zoo_tpu_torch.kernels.philox import site_seed
    trunk = Sequential([L.Dense(16, input_shape=(6,), device="cpu"),
                        L.Dropout(0.5)])
    inp = Input(shape=(6,))
    outer = Model(inp, trunk(TA.Lambda(lambda t: t * 1.0)(inp)))
    outer.ensure_built(seed=21)
    x = torch.from_numpy(rand((4, 6), 22))
    got = outer.apply(x, training=True, seed=99)
    want = trunk.apply(x, training=True, seed=site_seed(99, 1))
    assert torch.equal(got, want)
    assert (got == 0).any()


# ---------------------------------------------------------------------------
# SessionRecommender with its history branch
# ---------------------------------------------------------------------------
SR_ARGS = dict(item_count=30, item_embed=8, rnn_hidden_layers=(6, 4),
               session_length=5, include_history=True,
               mlp_hidden_layers=(8, 6), history_length=4)


def session_inputs(n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 31, (n, 5)).astype(np.int32),
            rs.randint(1, 31, (n, 4)).astype(np.int32)]


def test_session_recommender_history_matches_jax():
    t = trec.SessionRecommender(device="cpu", **SR_ARGS)
    j = jrec.SessionRecommender(**SR_ARGS)
    assert t._config == j._config
    assert [type(l).__name__ for l in t.model.ordered_layers()] == [
        type(l).__name__ for l in j.model._ordered_layers()]
    share(t.model, j.model, seed=23)
    x = session_inputs(7, 24)
    got = t.predict(x, batch_per_thread=4)
    assert got.shape == (7, 30)
    np.testing.assert_allclose(got, j.predict(x, batch_per_thread=4),
                               rtol=0, atol=TOL)


def test_session_recommender_history_fit_matches_jax():
    t = trec.SessionRecommender(device="cpu", **SR_ARGS)
    j = jrec.SessionRecommender(**SR_ARGS)
    share(t.model, j.model, seed=25)
    x = session_inputs(12, 26)
    y = np.random.RandomState(27).randint(0, 30, 12).astype(np.int32)
    jh = JEstimator.from_keras(j.model, optimizer=optax.adam(FIT_LR),
                               loss=CLS_LOSS).fit(
        (x, y), epochs=FIT_STEPS, batch_size=12, distributed=False,
        device_cache=False)
    th = Estimator.from_keras(t.model, optimizer="adam", loss=CLS_LOSS,
                              device="cpu").fit(
        (x, y), epochs=FIT_STEPS, batch_size=12, fused_optimizer=True)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0,
                               atol=LOSS_FIT_TOL)
