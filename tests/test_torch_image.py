"""The port's image-classification slice held against the JAX package on
the CPU: the convolutions, pools and global pools against `jax.lax` (the
JAX layers' own calls), BatchNormalization with its moving statistics,
the `Dropout` layer, the stateful-layer path of the engine and the
trainer, ResNet-18/50, LeNet-5 and Inception-v1 forwards, a 3-step
`Estimator.fit` of ResNet-18, the conversion of weights and Adam state,
serving through `InferenceModel` and `ImageClassifier`.

Both packages take the same weights: the port's, drawn from a seed (with
random BatchNorm statistics where inference reads them), carried to the
JAX tree by `convert`, which matches layers by graph order and transposes
convolution kernels between the port's OIHW and JAX's HWIO. Inputs come
from numpy with a seed.

Tolerances (absolute unless stated):
- convolutions, pools and global pools, f32: 1e-5 (the same sums in
  another order); max pools exact; bf16 global pools 1e-2 (one rounding
  of a bf16 result, 2^-8 relative on values below 4);
- BatchNormalization, f32: outputs and moving-statistic updates 1e-5;
  bf16: outputs 2e-2 relative + 2e-2 (the JAX package rounds the mean,
  the variance, its rsqrt and each product to bf16, six roundings of up
  to 2^-9 relative; `F.batch_norm` rounds once), updates 2e-2;
- model forwards, f32: 1e-4 on the softmax outputs (a few 1e-6 relative
  per layer through up to 174 layers); a training forward and its
  moving-statistic updates 1e-4 for ResNet-18 and 5e-4 for ResNet-50
  (`TRAIN_FORWARD_TOL`);
- the gradient of a training forward of ResNet-18 in float64: 1e-10
  relative (measured 2e-14: no systematic difference between the
  packages);
- the 3-step fit, f32: per-step losses and moving statistics 1e-4,
  parameters within 2·lr·steps with at most 1e-3 of them beyond 1e-5.
  The f32 gradients of the two packages differ by ~1.6e-5 relative
  (rounding through 20 BatchNorms at batch 8); Adam maps that noise in a
  near-zero gradient onto a step of up to ±lr, and ReLUs and max pools
  pass it on. At lr 1e-3 the loss after 3 steps moved up to 4e-3 between
  the packages over five seeds while the float64 gradients agree to
  2e-14; at lr 1e-4 the loss stayed within 2.4e-5 and the moving
  statistics within 2e-5, so the fit runs Adam at lr 1e-4;
- the bf16 fit (mixed precision): per-step losses 5e-2, moving statistics
  0.1, both against the JAX bf16 fit; moving statistics stay float32;
- conversion: exact.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models import image as jimage
from analytics_zoo_tpu.ops import metrics as jmetrics
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input, Model, merge_state
from analytics_zoo_tpu_torch.kernels import LAUNCHES
from analytics_zoo_tpu_torch.kernels import dropout as dr
from analytics_zoo_tpu_torch.kernels import fused_adam as fad
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.models import image as timage
from analytics_zoo_tpu_torch.ops import metrics, optimizers
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel

LOSS = "sparse_categorical_crossentropy"
FIT_LR = 1e-4
FIT_STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def ctx():
    c = zoo.init_orca_context(cluster_mode="local")
    yield c
    zoo.stop_orca_context()


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _names(jmodel):
    return [layer.name for layer in jmodel._ordered_layers()]


def _randomize_bn(model, seed):
    """Random gamma, beta and moving statistics for every BatchNorm, so an
    inference forward reads values other than the initial 1s and 0s."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for layer in model.ordered_layers():
            if isinstance(layer, L.BatchNormalization):
                n = layer.gamma.numel()
                layer.gamma.copy_(torch.from_numpy(
                    rs.uniform(0.5, 1.5, n).astype(np.float32)))
                layer.beta.copy_(torch.from_numpy(
                    rs.uniform(-0.2, 0.2, n).astype(np.float32)))
                layer.moving_mean.copy_(torch.from_numpy(
                    rs.uniform(-0.2, 0.2, n).astype(np.float32)))
                layer.moving_var.copy_(torch.from_numpy(
                    rs.uniform(0.5, 2.0, n).astype(np.float32)))


def _pair(port_model, jax_model, seed=0, randomize=True):
    """Build the port model from `seed` and give the JAX model the same
    weights; returns the JAX tree."""
    port_model.ensure_built(seed=seed)
    if randomize:
        _randomize_bn(port_model, seed + 1)
    return convert.model_params_to_jax(port_model.state_dict(),
                                       _names(jax_model), port_model)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------
# (rank, input shape without batch, filters, window, strides, border,
#  ordering, groups)
CONV_CASES = [
    (2, (9, 9, 3), 4, (3, 3), (1, 1), "same", "tf", 1),
    (2, (9, 9, 3), 4, (3, 3), (2, 2), "same", "tf", 1),     # odd, (1, 1)
    (2, (8, 8, 3), 4, (3, 3), (2, 2), "same", "tf", 1),     # even, (0, 1)
    (2, (16, 16, 3), 8, (7, 7), (2, 2), "same", "tf", 1),   # stem, (2, 3)
    (2, (8, 8, 6), 4, (1, 1), (2, 2), "same", "tf", 1),     # shortcut
    (2, (9, 8, 4), 6, (5, 3), (1, 2), "same", "tf", 1),
    (2, (9, 9, 3), 4, (3, 3), (2, 2), "valid", "tf", 1),
    (2, (3, 8, 9), 5, (3, 3), (2, 1), "same", "th", 1),
    (2, (3, 9, 9), 5, (5, 5), (1, 1), "valid", "th", 1),
    (2, (8, 8, 6), 4, (3, 3), (1, 1), "same", "tf", 2),
    (2, (6, 7, 7), 9, (3, 3), (2, 2), "same", "th", 3),
    (1, (8, 4), 2, (3,), (1,), "same", "tf", 1),
    (1, (8, 4), 3, (4,), (2,), "same", "tf", 1),
    (1, (4, 9), 3, (3,), (2,), "valid", "th", 1),
    (3, (4, 5, 6, 2), 3, (2, 3, 3), (1, 2, 2), "same", "tf", 1),
]
_CONV_CLASSES = {1: (L.Convolution1D, JL.Convolution1D),
                 2: (L.Convolution2D, JL.Convolution2D),
                 3: (L.Convolution3D, JL.Convolution3D)}


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(
    map(str, (c[0], "x".join(map(str, c[1])), c[4], c[5], c[6], c[7]))))
def test_convolution_matches_jax(case):
    rank, shape, filters, window, strides, border, order, groups = case
    tcls, jcls = _CONV_CLASSES[rank]
    kw = dict(subsample=strides, border_mode=border, dim_ordering=order,
              groups=groups, activation="relu")
    t = tcls(filters, *window, input_shape=shape, device="cpu", **kw)
    j = jcls(filters, *window, **kw)
    t.build(torch.Generator().manual_seed(0))
    with torch.no_grad():
        t.bias.copy_(torch.from_numpy(_rand((filters,), 1, 0.1)))
    kernel = convert._oihw_to_hwio(_np(t.kernel), rank)
    x = _rand((2,) + shape, 2)
    want = np.asarray(j.call({"kernel": kernel, "bias": _np(t.bias)}, x))
    got = _np(t(torch.from_numpy(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert t.compute_output_shape((None,) + shape) == \
        j.compute_output_shape((None,) + shape)


def test_conv_kernel_layout_and_known_values():
    """`tests/test_keras_engine.py:104-119`: the 2x2 ones kernel on
    arange(16); the kernel is OIHW, channels_last in memory."""
    c = L.Convolution2D(1, 2, 2, use_bias=False, input_shape=(4, 4, 1),
                        device="cpu")
    with torch.no_grad():
        c.kernel.fill_(1.0)
    assert tuple(c.kernel.shape) == (1, 1, 2, 2)
    assert c.kernel.is_contiguous(memory_format=torch.channels_last)
    x = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    y = c(x)
    assert tuple(y.shape) == (1, 3, 3, 1)
    assert float(y[0, 0, 0, 0].detach()) == 10.0
    assert c.compute_output_shape((None, 4, 4, 1)) == (None, 3, 3, 1)
    c1 = L.Convolution1D(2, 3, border_mode="same", input_shape=(8, 4),
                         device="cpu").build(torch.Generator())
    assert tuple(c1(torch.zeros(2, 8, 4)).shape) == (2, 8, 2)
    assert L.Conv2D is L.Convolution2D and L.Conv1D is L.Convolution1D \
        and L.Conv3D is L.Convolution3D
    with pytest.raises(ValueError, match="groups"):
        L.Convolution2D(4, 3, 3, groups=3, input_shape=(8, 8, 4),
                        device="cpu")


def test_conv_float_input_follows_kernel_dtype_and_integer_input_raises():
    """`tests/test_keras_engine.py:418-445`."""
    c = L.Convolution2D(4, 3, 3, border_mode="same", input_shape=(8, 8, 3),
                        device="cpu").build(torch.Generator())
    c16 = c.to(torch.bfloat16)
    assert c16(torch.zeros(2, 8, 8, 3)).dtype == torch.bfloat16
    with pytest.raises(TypeError):
        c16(torch.zeros(2, 8, 8, 3, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------
POOL_CASES = [
    # (rank, shape, pool, strides, border, ordering)
    (2, (112, 112, 4), (3, 3), (2, 2), "same", "tf"),       # stem, (0, 1)
    (2, (9, 9, 3), (3, 3), (2, 2), "same", "tf"),
    (2, (8, 7, 3), (3, 3), (1, 1), "same", "tf"),           # inception
    (2, (9, 9, 3), (2, 2), None, "valid", "tf"),
    (2, (8, 8, 3), (2, 2), (1, 1), "same", "tf"),
    (2, (3, 9, 8), (3, 2), (2, 2), "same", "th"),
    (2, (3, 8, 8), (2, 2), (2, 2), "valid", "th"),
    (1, (9, 3), (3,), (2,), "same", "tf"),
    (1, (8, 3), (2,), None, "valid", "tf"),
    (1, (3, 8), (3,), (1,), "same", "th"),
]
_POOLS = {(2, "max"): (L.MaxPooling2D, JL.MaxPooling2D),
          (2, "avg"): (L.AveragePooling2D, JL.AveragePooling2D),
          (1, "max"): (L.MaxPooling1D, JL.MaxPooling1D),
          (1, "avg"): (L.AveragePooling1D, JL.AveragePooling1D)}


@pytest.mark.parametrize("reducer", ["max", "avg"])
@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: "-".join(
    map(str, (c[0], "x".join(map(str, c[1])), c[2][0], c[4], c[5]))))
def test_pool_matches_jax(case, reducer):
    rank, shape, pool, strides, border, order = case
    tcls, jcls = _POOLS[(rank, reducer)]
    if rank == 1:
        kw = dict(pool_length=pool[0], stride=strides[0] if strides
                  else None, border_mode=border, dim_ordering=order)
    else:
        kw = dict(pool_size=pool, strides=strides, border_mode=border,
                  dim_ordering=order)
    t, j = tcls(**kw), jcls(**kw)
    x = _rand((2,) + shape, 3)
    want = np.asarray(j.call({}, x))
    got = _np(t(torch.from_numpy(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0 if reducer == "max" else 1e-5)
    assert t.compute_output_shape((None,) + shape) == \
        j.compute_output_shape((None,) + shape)


def test_pool_known_values():
    """`tests/test_keras_engine.py:121-133`."""
    x = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    y = L.MaxPooling2D()(x)
    assert tuple(y.shape) == (1, 2, 2, 1) and float(y[0, 0, 0, 0]) == 5.0
    assert float(L.AveragePooling2D()(x)[0, 0, 0, 0]) == 2.5
    assert tuple(L.GlobalAveragePooling2D()(x).shape) == (1, 1)
    assert tuple(L.GlobalMaxPooling1D()(torch.zeros(2, 5, 3)).shape) == \
        (2, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ["tf", "th"])
@pytest.mark.parametrize("name", ["GlobalMaxPooling2D",
                                  "GlobalAveragePooling2D",
                                  "GlobalMaxPooling1D",
                                  "GlobalAveragePooling1D"])
def test_global_pool_matches_jax(name, order, dtype):
    t, j = getattr(L, name)(dim_ordering=order), \
        getattr(JL, name)(dim_ordering=order)
    shape = (3, 7, 6, 5) if name.endswith("2D") else (3, 9, 5)
    x = _rand(shape, 4, 3.0)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    got = t(xt)
    want = np.asarray(j.call({}, xj)).astype(np.float32)
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 1e-2)
    assert t.compute_output_shape((None,) + shape[1:]) == \
        j.compute_output_shape((None,) + shape[1:])


# ---------------------------------------------------------------------------
# BatchNormalization
# ---------------------------------------------------------------------------
def _bn_pair(shape, axis=-1, momentum=0.99, seed=5):
    t = L.BatchNormalization(axis=axis, momentum=momentum,
                             input_shape=shape, device="cpu")
    rs = np.random.RandomState(seed)
    n = ((None,) + tuple(shape))[axis]
    with torch.no_grad():
        t.gamma.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, n)))
        t.beta.copy_(torch.from_numpy(rs.uniform(-0.5, 0.5, n)))
        t.moving_mean.copy_(torch.from_numpy(rs.uniform(-1, 1, n)))
        t.moving_var.copy_(torch.from_numpy(rs.uniform(0.5, 2, n)))
    params = {k: _np(v) for k, v in t.state_dict().items()}
    return t, JL.BatchNormalization(axis=axis, momentum=momentum), params


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("shape, axis", [((6, 5, 4), -1), ((3, 8), 1),
                                         ((4, 7), -1)])
def test_batchnorm_matches_jax(shape, axis, training):
    t, j, params = _bn_pair(shape, axis)
    x = _rand((4,) + shape, 6, 3.0) + 1.0
    y_j, upd_j = j.call_and_state(params, x, training=training)
    y_t, upd_t = t.call_and_state(torch.from_numpy(x), training=training)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), rtol=0, atol=1e-5)
    assert sorted(upd_t) == sorted(upd_j)
    for k in upd_j:
        np.testing.assert_allclose(_np(upd_t[k]), np.asarray(upd_j[k]),
                                   rtol=0, atol=1e-5)
    if training:   # per-channel normalisation (test_keras_engine.py:93)
        ch = t._norm_axis(x.ndim)
        dims = tuple(d for d in range(x.ndim) if d != ch)
        np.testing.assert_allclose(
            ((_np(y_t) - params["beta"].reshape(
                [-1 if d == ch else 1 for d in range(x.ndim)]))
             .mean(axis=dims)), 0.0, atol=1e-5)


def test_batchnorm_bf16_matches_jax():
    """Mixed precision: bf16 input, parameters and statistics; the update's
    momentum constants round to bf16 as JAX's weak-typed floats do."""
    t, j, params = _bn_pair((6, 5, 4))
    t16 = t.to(torch.bfloat16)
    x = _rand((4, 6, 5, 4), 7, 3.0) + 1.0
    p16 = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()}
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    for training in (True, False):
        y_j, upd_j = j.call_and_state(p16, x16, training=training)
        y_t, upd_t = t16.call_and_state(torch.from_numpy(x).to(
            torch.bfloat16), training=training)
        assert y_t.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(y_t), np.asarray(y_j, np.float32),
                                   rtol=2e-2, atol=2e-2)
        for k in upd_j:
            assert upd_t[k].dtype == torch.bfloat16
            np.testing.assert_allclose(_np(upd_t[k]),
                                       np.asarray(upd_j[k], np.float32),
                                       rtol=0, atol=2e-2)


def test_batchnorm_call_writes_buffers_only_in_training():
    t, j, params = _bn_pair((5, 3), momentum=0.5)
    x = torch.from_numpy(_rand((8, 5, 3), 8) * 5 + 3)
    before = {k: v.clone() for k, v in t.state_dict().items()}
    t(x, training=False)
    assert all(torch.equal(before[k], v) for k, v in t.state_dict().items())
    _, upd = t.call_and_state(x, training=True)
    assert all(torch.equal(before[k], v) for k, v in t.state_dict().items())
    t(x, training=True)
    for k in ("moving_mean", "moving_var"):
        assert torch.equal(getattr(t, k), upd[k])
        assert not torch.equal(getattr(t, k), before[k])
    for k in ("gamma", "beta"):
        assert torch.equal(getattr(t, k), before[k])
    assert [n for n, _ in t.named_parameters()] == ["gamma", "beta"]
    assert [n for n, _ in t.named_buffers()] == ["moving_mean", "moving_var"]


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------
def test_dropout_layer():
    """Exact at rate 0 and outside training; in training, exact against
    the kernel's injected keep mask (the JAX rule `x·1/(1-rate)` where
    kept, else 0); a seed is required."""
    x = torch.from_numpy(_rand((6, 40), 9))
    d0 = L.Dropout(0.0)
    assert torch.equal(d0(x, training=True, seed=1), x)
    d = L.Dropout(0.3)
    assert torch.equal(d(x, training=False, seed=1), x)
    assert torch.equal(d(x), x)
    keep = dr.dropout_keep(x.shape, 11, 0.3)
    scale = np.float32(1.0) / np.float32(0.7)
    want = np.where(keep.numpy(), x.numpy() * scale, 0.0)
    np.testing.assert_array_equal(d(x, training=True, seed=11).numpy(), want)
    with pytest.raises(ValueError, match="seed"):
        d(x, training=True)
    y, upd = d.call_and_state(x, training=True, seed=11)
    assert upd == {} and torch.equal(y, torch.from_numpy(want))


def test_model_hands_dropout_a_seed_per_node():
    inp = Input(shape=(30,))
    out = L.Dropout(0.5)(L.Dense(30, device="cpu")(inp))
    m = Model(inp, out)
    m.ensure_built(seed=0)
    x = torch.from_numpy(_rand((4, 30), 10))
    a = m.apply(x, training=True, seed=3)
    assert torch.equal(a, m.apply(x, training=True, seed=3))
    assert not torch.equal(a, m.apply(x, training=True, seed=4))
    assert 0.3 < float((a == 0).float().mean()) < 0.7
    with pytest.raises(ValueError, match="seed"):
        m.apply(x, training=True)
    assert torch.equal(m.apply(x), m.apply(x, training=False, seed=3))


# ---------------------------------------------------------------------------
# the engine's state path and the models
# ---------------------------------------------------------------------------
def test_apply_and_state_collects_updates_and_apply_writes_them():
    m = timage.resnet(18, 4, (32, 32, 3), device="cpu")
    m.ensure_built(seed=0)
    bns = [l.name for l in m.ordered_layers()
           if isinstance(l, L.BatchNormalization)]
    x = torch.from_numpy(_rand((4, 32, 32, 3), 11))
    before = {k: v.clone() for k, v in m.state_dict().items()}
    out, upd = m.apply_and_state(x, training=True, seed=0)
    assert sorted(upd) == sorted(bns) and len(bns) == 20
    assert all(sorted(v) == ["moving_mean", "moving_var"]
               for v in upd.values())
    assert all(torch.equal(before[k], v) for k, v in m.state_dict().items())
    _, none = m.apply_and_state(x, training=False)
    assert none == {}
    torch.testing.assert_close(m.apply(x, training=True, seed=0), out,
                               rtol=0, atol=0)
    for name, leaves in upd.items():
        for leaf, value in leaves.items():
            assert torch.equal(m.state_dict()[f"{name}.{leaf}"], value)
    merge_state(m, {})   # nothing to write


def test_resnet50_structure_matches_jax():
    """ResNet-50 v1.5 at 224×224, 1000 classes: 174 layers in the JAX
    graph order, 53 convolutions each followed by a BatchNorm, 161
    trainable leaves (25,557,032 parameters) and 53,120 moving-statistic
    values, every leaf the shape of the JAX leaf."""
    t = timage.resnet(50, 1000, (224, 224, 3), device="cpu")
    j = jimage.resnet(50, 1000, (224, 224, 3))
    layers = t.ordered_layers()
    assert [type(l).__name__ for l in layers] == \
        [type(l).__name__ for l in j._ordered_layers()]
    assert len(layers) == 174
    assert sum(isinstance(l, L._ConvND) for l in layers) == 53
    params = list(t.parameters())
    assert len(params) == 161
    assert sum(p.numel() for p in params) == 25_557_032
    assert sum(b.numel() for b in t.buffers()) == 53_120
    shapes = jax.eval_shape(lambda: j.build(jax.random.PRNGKey(0)))
    names = _names(j)
    for key, value in t.state_dict().items():
        layer, leaf = key.split(".")
        want = shapes[names[[l.name for l in layers].index(layer)]][leaf]
        got = tuple(value.shape)
        if leaf == "kernel" and value.dim() == 4:
            got = got[2:] + (got[1], got[0])
        assert got == tuple(want.shape), key


# A training forward normalises every BatchNorm by its batch statistics, at
# batch 8 over as few as 8 values a channel in the last stage: each
# normalisation divides the rounding of its input by a small standard
# deviation. Through 20 BatchNorms (ResNet-18) the outputs agree to 1e-4;
# through 53 (ResNet-50) to 1.3e-4 (3.4e-4 relative): 5e-4.
TRAIN_FORWARD_TOL = {18: 1e-4, 50: 5e-4}


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_forward_matches_jax(depth):
    t = timage.resnet(depth, 10, (32, 32, 3), device="cpu")
    j = jimage.resnet(depth, 10, (32, 32, 3))
    params = _pair(t, j, seed=depth)
    x = _rand((2, 32, 32, 3), 12)
    want = np.asarray(jax.jit(j.apply)(params, x))
    with torch.inference_mode():
        got = _np(t.apply(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    # a training forward: batch statistics and the state updates, at batch
    # 8 (the last stage is 1×1 at 32×32, so a BatchNorm there normalises
    # over the batch alone)
    x = _rand((8, 32, 32, 3), 17)
    want_y, want_upd = jax.jit(functools.partial(
        j.apply_and_state, training=True))(params, x)
    got_y, got_upd = t.apply_and_state(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), rtol=0,
                               atol=TRAIN_FORWARD_TOL[depth])
    to_jax = dict(zip([l.name for l in t.ordered_layers()], _names(j)))
    assert sorted(to_jax[k] for k in got_upd) == sorted(want_upd)
    for name, leaves in got_upd.items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(
                _np(value), np.asarray(want_upd[to_jax[name]][leaf]),
                rtol=0, atol=TRAIN_FORWARD_TOL[depth])


def test_lenet_forward_matches_jax():
    t, j = timage.lenet(10, device="cpu"), jimage.lenet(10)
    params = _pair(t, j, seed=1)
    x = _rand((3, 1, 28, 28), 13)
    with torch.inference_mode():
        got = _np(t.apply(torch.from_numpy(x)))
    np.testing.assert_allclose(got, np.asarray(jax.jit(j.apply)(params, x)),
                               rtol=0, atol=1e-4)


def test_inception_v1_forward_matches_jax():
    t = timage.inception_v1(10, (32, 32, 3), device="cpu")
    j = jimage.inception_v1(10, (32, 32, 3))
    params = _pair(t, j, seed=2)
    x = _rand((2, 32, 32, 3), 14)
    with torch.inference_mode():
        got = _np(t.apply(torch.from_numpy(x)))
    np.testing.assert_allclose(got, np.asarray(jax.jit(j.apply)(params, x)),
                               rtol=0, atol=1e-4)
    # training: the Dropout layer drops (its seed from the model)
    a = t.apply(torch.from_numpy(x), training=True, seed=1)
    b = t.apply(torch.from_numpy(x), training=True, seed=1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bad_depth_and_arch():
    with pytest.raises(ValueError, match="Unsupported depth"):
        timage.resnet(depth=99, device="cpu")
    with pytest.raises(ValueError, match="Unknown arch"):
        timage.ImageClassifier(arch="vgg", device="cpu")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def test_training_gradient_matches_jax_in_float64():
    """The gradient of a training forward (batch statistics, convolutions,
    pools, the dense head) through ResNet-18, in float64: the packages
    compute the same function."""
    t = timage.resnet(18, 4, (32, 32, 3), device="cpu")
    j = jimage.resnet(18, 4, (32, 32, 3))
    t.ensure_built(seed=1)
    t.double()
    rs = np.random.RandomState(1)
    x = rs.standard_normal((8, 32, 32, 3))
    y = rs.randint(0, 4, 8)
    with jax.enable_x64(True):
        params = convert.model_params_to_jax(t.state_dict(), _names(j), t)

        def loss(p):
            out, _ = j.apply_and_state(p, x, training=True)
            return -jnp.mean(jnp.log(out[jnp.arange(8), y]))
        g = jax.device_get(jax.jit(jax.grad(loss))(params))
    out = t.apply(torch.from_numpy(x), training=True)
    (-torch.log(out[torch.arange(8), torch.from_numpy(y)]).mean()).backward()
    want = convert.model_params_from_jax(g, _names(j), t)
    for key, p in t.named_parameters():
        rel = float((p.grad - want[key]).norm() / want[key].norm())
        assert rel <= 1e-10, (key, rel)


def _fit_data():
    rs = np.random.RandomState(0)
    return (rs.standard_normal((8, 32, 32, 3)).astype(np.float32),
            rs.randint(0, 4, 8).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_fit(mixed_precision: bool):
    """The JAX fit of ResNet-18 (32×32, batch 8, 4 classes) from the port's
    weights for seed 3: one batch, 3 epochs = 3 steps, Adam at lr 1e-4,
    host batches (`distributed=False, device_cache=False`)."""
    t = timage.resnet(18, 4, (32, 32, 3), device="cpu")
    j = jimage.resnet(18, 4, (32, 32, 3))
    init = _pair(t, j, seed=3, randomize=False)
    j.params = init
    x, y = _fit_data()
    hist = JEstimator.from_keras(j, optimizer=optax.adam(FIT_LR),
                                 loss=LOSS).fit(
        (x, y), epochs=FIT_STEPS, batch_size=8, distributed=False,
        device_cache=False, mixed_precision=mixed_precision)
    return init, _names(j), hist["loss"], jax.device_get(j.params)


def _port_fit(init, names, optimizer, mixed_precision, fused):
    t = timage.resnet(18, 4, (32, 32, 3), device="cpu")
    t.load_state_dict(convert.model_params_from_jax(init, names, t))
    x, y = _fit_data()
    hist = Estimator.from_keras(t, optimizer=optimizer, loss=LOSS,
                                device="cpu").fit(
        (x, y), epochs=FIT_STEPS, batch_size=8,
        mixed_precision=mixed_precision, fused_optimizer=fused)
    return t, hist["loss"]


@pytest.mark.parametrize("fused", [True, False])
def test_resnet18_fit_matches_jax(fused):
    """`fused=True` is the slice's kernel path (the fused-Adam sweep, its
    plain version on the CPU); `fused=False` the port's plain Adam."""
    init, names, jloss, jparams = _jax_fit(False)
    opt = optimizers.fused_adam(FIT_LR) if fused \
        else optimizers.adam(FIT_LR)
    t, loss = _port_fit(init, names, opt, False, fused)
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-4)
    want = convert.model_params_from_jax(jparams, names, t)
    diffs = []
    for key, value in t.state_dict().items():
        d = (value - want[key]).abs()
        if "moving" in key:
            assert float(d.max()) <= 1e-4, key
            assert value.dtype == torch.float32
        else:
            diffs.append(d)
    assert max(float(d.max()) for d in diffs) <= 2 * FIT_LR * FIT_STEPS
    over = sum(int((d > 1e-5).sum()) for d in diffs)
    assert over <= 1e-3 * sum(d.numel() for d in diffs)
    # the moving statistics moved
    start = convert.model_params_from_jax(init, names, t)
    key = f"{t.ordered_layers()[1].name}.moving_mean"
    assert not torch.equal(t.state_dict()[key], start[key])


def test_resnet18_bf16_fit_matches_jax():
    init, names, jloss, jparams = _jax_fit(True)
    t, loss = _port_fit(init, names, optimizers.fused_adam(FIT_LR), True,
                        True)
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=5e-2)
    want = convert.model_params_from_jax(jparams, names, t)
    for key, value in t.state_dict().items():
        assert value.dtype == torch.float32, key
        if "moving" in key:
            np.testing.assert_allclose(_np(value), _np(want[key]), rtol=0,
                                       atol=0.1, err_msg=key)


def test_evaluate_and_predict_use_moving_stats():
    t = timage.resnet(18, 10, (32, 32, 3), device="cpu")
    j = jimage.resnet(18, 10, (32, 32, 3))
    params = _pair(t, j, seed=4)
    j.params = params
    j.compile("adam", LOSS)
    t.compile("adam", LOSS)
    rs = np.random.RandomState(5)
    x = rs.standard_normal((10, 32, 32, 3)).astype(np.float32)
    y = rs.randint(0, 10, 10).astype(np.int32)
    before = {k: v.clone() for k, v in t.state_dict().items()}
    np.testing.assert_allclose(t.predict(x, batch_per_thread=4),
                               j.predict(x, batch_per_thread=4), rtol=0,
                               atol=1e-4)
    got = t.evaluate(x, y, batch_per_thread=4,
                     metrics=[metrics.Top5Accuracy(), metrics.Loss(t.loss)])
    want = j.evaluate(x, y, batch_per_thread=4,
                      metrics=[jmetrics.Top5Accuracy(), jmetrics.Loss(j.loss)])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5)
    assert all(torch.equal(before[k], v) for k, v in t.state_dict().items())


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------
def test_weights_and_adam_state_round_trip():
    """Weights (HWIO ⇄ OIHW kernels, BatchNorm statistics) and a JAX Adam
    state, whose moving-statistic moments are dropped and come back as
    zeros, cross exactly."""
    _, names, _, jparams = _jax_fit(False)
    t = timage.resnet(18, 4, (32, 32, 3), device="cpu")
    sd = convert.model_params_from_jax(jparams, names, t)
    t.load_state_dict(sd)
    back = convert.model_params_to_jax(t.state_dict(), names, t)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    rs = np.random.RandomState(6)

    def moments(p):
        leaves = {k: (np.zeros_like(np.asarray(v)) if k.startswith("moving")
                      else rs.standard_normal(np.shape(v)).astype(np.float32))
                  for k, v in p.items()}
        return leaves
    mu = {n: moments(p) for n, p in jparams.items()}
    nu = {n: {k: np.abs(v) for k, v in p.items()} for n, p in mu.items()}
    state = (optax.ScaleByAdamState(np.int32(7), mu, nu), optax.EmptyState())
    port = convert.model_opt_state_from_jax(state, names, t, device="cpu")
    assert port.count == 7
    assert sorted(port.mu) == sorted(n for n, _ in t.named_parameters())
    conv = next(l for l in t.ordered_layers() if isinstance(l, L._ConvND))
    assert port.mu[f"{conv.name}.kernel"].shape == conv.kernel.shape
    out = convert.model_opt_state_to_jax(port, names, t)
    assert int(out.count) == 7
    for a, b in ((out.mu, mu), (out.nu, nu)):
        for (pa, la), (pb, lb) in zip(
                jax.tree_util.tree_leaves_with_path(a),
                jax.tree_util.tree_leaves_with_path(b)):
            assert pa == pb
            np.testing.assert_array_equal(la, lb)


# ---------------------------------------------------------------------------
# serving and the wrapper
# ---------------------------------------------------------------------------
def test_inference_model_serves_resnet():
    """`load_keras` of a stateful conv model: f32 against the JAX forward,
    bf16 with the buffers cast as the JAX package casts its whole tree,
    warmup on 4-D records, and padding by repeating the last row is safe
    in eval mode (a padded batch gives each row what it gives alone)."""
    t = timage.resnet(18, 4, (32, 32, 3), device="cpu")
    j = jimage.resnet(18, 4, (32, 32, 3))
    params = _pair(t, j, seed=7)
    t16 = copy.deepcopy(t).to(torch.bfloat16)
    im = InferenceModel(max_batch=4, device="cpu").load_keras(t)
    im16 = InferenceModel(max_batch=4, device="cpu").load_keras(t16)
    assert im.serving_dtype == "float32" and im16.serving_dtype == "bfloat16"
    assert all(b.dtype == torch.bfloat16 for b in t16.buffers())
    for m in (im, im16):
        m.warmup(np.zeros((32, 32, 3), np.float32))
        assert m.warmed_buckets == {1, 2, 4}
        assert set(m.warmup_report) == {f"32x32x3:b{b}" for b in (1, 2, 4)}
    x = _rand((3, 32, 32, 3), 15)
    got = im.predict(x)                    # padded to 4 on the device
    np.testing.assert_allclose(got, np.asarray(jax.jit(j.apply)(params, x)),
                               rtol=0, atol=1e-4)
    alone = np.concatenate([im.predict(x[i:i + 1]) for i in range(3)])
    np.testing.assert_allclose(got, alone, rtol=0, atol=1e-6)
    got16 = im16.predict(x)
    assert got16.dtype == np.float32 and got16.shape == (3, 4)
    np.testing.assert_allclose(got16, got, rtol=0, atol=5e-2)
    np.testing.assert_allclose(im.predict_async(x).result(), got, rtol=0,
                               atol=1e-6)


def test_image_classifier_matches_jax(tmp_path):
    label_map = {0: "cat", 1: "dog", 2: "fish"}
    t = timage.ImageClassifier(depth=18, class_num=3, input_shape=(32, 32, 3),
                               label_map=label_map, device="cpu")
    j = jimage.ImageClassifier(depth=18, class_num=3, input_shape=(32, 32, 3),
                               label_map=label_map)
    j.model.params = _pair(t.model, j.model, seed=8)
    for m in (t, j):
        m.compile("adam", LOSS)

    class Images:
        images = [np.random.RandomState(i).rand(32, 32, 3).astype(np.float32)
                  for i in range(5)]
    got = t.predict_image_set(Images, top_n=2, batch_per_thread=4)
    want = j.predict_image_set(Images, top_n=2, batch_per_thread=4)
    assert len(got) == 5 and all(len(r) == 2 for r in got)
    for gr, wr in zip(got, want):
        assert [lab for lab, _ in gr] == [lab for lab, _ in wr]
        np.testing.assert_allclose([p for _, p in gr], [p for _, p in wr],
                                   rtol=0, atol=1e-4)
    assert isinstance(got[0][0][0], str)
    assert t._config == j._config
    t.save_model(str(tmp_path / "clf"))
    again = timage.ImageClassifier.load_model(str(tmp_path / "clf"),
                                              device="cpu")
    assert again.label_map == t.label_map
    np.testing.assert_array_equal(
        again.predict_image_set(Images, top_n=2, batch_per_thread=4), got)
    lenet = timage.ImageClassifier(class_num=10, input_shape=(1, 28, 28),
                                   arch="lenet", device="cpu")
    assert isinstance(lenet.model.ordered_layers()[0], L.Convolution2D)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_adam_on_a_channels_last_leaf_on_gpu(dtype):
    """A channels_last conv kernel runs through the kernel as it lies, its
    moments in the same layout; a gradient in another layout is copied
    into it first."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (64, 32, 3, 3)
    p = torch.randn(shape, device="cuda", generator=gen).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    opt = optimizers.fused_adam(1e-3)
    state = opt.init({"k": p})
    assert state.mu["k"].stride() == p.stride()
    g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    ref_p, ref_m, ref_v = p.float().clone(), state.mu["k"].clone(), \
        state.nu["k"].clone()
    before = LAUNCHES.get(fad.KERNEL_NAME)
    opt.fused_apply({"k": g}, state, {"k": p})
    torch.cuda.synchronize()
    assert LAUNCHES.get(fad.KERNEL_NAME) == before + 1
    sc = fad._fold_scalars(1, 1e-3, 0.9, 0.999, 1e-8, 0.0)
    want = fad._adam_math(ref_p, ref_m, ref_v, g.float(), *sc, 0.9, 0.999)
    assert torch.equal(p, want[0].to(dtype))
    assert torch.equal(state.mu["k"], want[1])


@pytest.mark.gpu
def test_resnet_forward_and_fit_on_gpu():
    """ResNet-18 on the card: the forward against the CPU's (cuDNN, TF32
    off: 1e-4), and a fused fit launching the fused-Adam kernel once a
    step (one launch sweeps every leaf), with float32 moving statistics
    after a bf16 fit."""
    _need_gpu()
    cpu = timage.resnet(18, 4, (32, 32, 3), device="cpu")
    cpu.ensure_built(seed=0)
    _randomize_bn(cpu, 1)
    gpu = copy.deepcopy(cpu).to("cuda")
    x = _rand((4, 32, 32, 3), 16)
    with torch.inference_mode():
        want = _np(cpu.apply(torch.from_numpy(x)))
        got = gpu.apply(torch.from_numpy(x).cuda()).float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    xs, ys = _fit_data()
    LAUNCHES.reset()
    Estimator.from_keras(gpu, optimizer="adam", loss=LOSS).fit(
        (xs, ys), epochs=2, batch_size=8, mixed_precision=True,
        fused_optimizer=True)
    assert LAUNCHES.get(fad.KERNEL_NAME) == 2 * fad.sweep_launches(
        gpu.parameters()) == 2
    assert all(b.dtype == torch.float32 for b in gpu.buffers())
