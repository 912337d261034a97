"""The port's extended layer set held against the JAX package on the CPU:
every class of `keras/layers_ext.py`'s `__all__`, the six layers
`keras/layers.py` gained (`Reshape`, `Permute`, `RepeatVector`,
`Squeeze`, `ExpandDim`, `Narrow`), `keras2/layers.py`, and
`reset_name_scope`.

Each case builds the JAX layer, draws its parameters anew from a seed
(N(0, 0.5), so zero or one initial values test nothing), carries them to
the port layer through `convert`, and runs both on the same numpy input.
Tolerances (absolute): forward 1e-5 in float32; where the layer has
parameters, the gradient of a fixed random projection of the output with
respect to the parameters and the input, 1e-4.

The random layers (`GaussianNoise`, `GaussianDropout`,
`SpatialDropout1D/2D/3D`, `RReLU`, `GaussianSampler`) cannot match the
JAX draws bit for bit; their parity has three parts: exact in inference
and at a rate of 0, exact against an injected draw (the JAX layer's own
draw handed to the port layer's `apply`), and matching in statistics on
a large input.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import Input as JInput
from analytics_zoo_tpu.keras import Model as JModel
from analytics_zoo_tpu.keras import engine as jengine
from analytics_zoo_tpu.keras import layers as jL
from analytics_zoo_tpu.keras.layers_ext import __all__ as JAX_EXT_NAMES
from analytics_zoo_tpu.keras2 import layers as jK2
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.keras import Input as TInput
from analytics_zoo_tpu_torch.keras import Model as TModel
from analytics_zoo_tpu_torch.keras import engine as tengine
from analytics_zoo_tpu_torch.keras import layers as tL
from analytics_zoo_tpu_torch.keras import layers_ext as text
from analytics_zoo_tpu_torch.keras2 import layers as tK2

TOL = 1e-5
GRAD_TOL = 1e-4
CPU = {"device": "cpu"}


def rand(shape, seed, scale=1.0, positive=False):
    a = np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32) * scale
    return np.abs(a) + 0.1 if positive else a


def _shape_of(x):
    if isinstance(x, (list, tuple)):
        return [(None,) + tuple(np.shape(a)[1:]) for a in x]
    return (None,) + tuple(np.shape(x)[1:])


def _torch(x, grad=False):
    if isinstance(x, (list, tuple)):
        return [_torch(a, grad) for a in x]
    t = torch.as_tensor(np.array(x))
    if grad and t.is_floating_point():
        t.requires_grad_()
    return t


def carry(jl, tl, x, seed):
    """The port layer's parameters drawn from `seed`, N(0, 0.5) (zero or
    one initial values would test nothing), and carried to the JAX tree by
    `convert`; the tree's structure and shapes are held to what the JAX
    layer's `build` makes. Returns the JAX tree."""
    shape = _shape_of(x)
    tl.ensure_parameters(shape)
    state = {k: rand(tuple(v.shape), seed + i, 0.5)
             for i, (k, v) in enumerate(tl.state_dict().items())}
    if not state:
        return {}
    tl.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    params = convert._layer_to_jax(tl, state, jl.name)
    want = jax.eval_shape(lambda: jl.build(jax.random.PRNGKey(0), shape))
    assert jax.tree_util.tree_structure(want) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(params)):
        assert tuple(a.shape) == tuple(np.shape(b))
    return params


def check(jl, tl, x, seed=0, tol=TOL):
    """The JAX and the port layer on `x`; for a layer with parameters,
    also the gradients of a random projection of the output with respect
    to the parameters and the input."""
    params = carry(jl, tl, x, seed)
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    grad = bool(params)
    # one XLA program a case (forward, and the gradients where checked):
    # the JAX side's eager ops would each compile on their own
    want = jax.jit(jl.call)(params, jx)
    tx = _torch(x, grad=grad)
    got = tl.call(tx)
    flat_want = jax.tree_util.tree_leaves(want)
    flat_got = got if isinstance(got, (list, tuple)) else [got]
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=tol)
    if not grad:
        return
    proj = [rand(np.shape(w), 99 + i) for i, w in enumerate(flat_want)]

    def jloss(p, xx):
        out = jax.tree_util.tree_leaves(jl.call(p, xx))
        return sum(jnp.sum(o * w) for o, w in zip(out, proj))
    floats = jnp.issubdtype(jax.tree_util.tree_leaves(jx)[0].dtype,
                            jnp.floating)
    if floats:
        jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jx)
    else:
        jgp, jgx = jax.jit(jax.grad(jloss))(params, jx), []
    loss = sum((o * torch.as_tensor(w)).sum()
               for o, w in zip(flat_got, proj))
    loss.backward()
    want_g = convert._layer_from_jax(tl, jgp, jl.name)
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(
            want_g[name]), rtol=0, atol=GRAD_TOL, err_msg=name)
    for t, g in zip(tx if isinstance(tx, list) else [tx],
                    jax.tree_util.tree_leaves(jgx)):
        got_g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(got_g.numpy(), np.asarray(g), rtol=0,
                                   atol=GRAD_TOL)


def pair(name, *args, params=False, jmod=jL, tmod=tL, **kw):
    jl = getattr(jmod, name)(*args, **kw)
    tl = getattr(tmod, name)(*args, **(dict(kw, **CPU) if params else kw))
    return jl, tl


# (case id, pair arguments[, keywords], input)
X25 = rand((2, 5), 1)
IMG = rand((2, 7, 7, 3), 2)
SEQ = rand((2, 9, 4), 3)
VOL = rand((2, 5, 5, 5, 2), 4)
POS = rand((2, 4, 5), 5, positive=True)

CASES = [
    ("LeakyReLU", ("LeakyReLU", 0.1), X25),
    ("ELU", ("ELU", 0.7), X25),
    ("ThresholdedReLU", ("ThresholdedReLU", 0.5), X25),
    ("PReLU", ("PReLU",), dict(params=True), rand((2, 3, 4), 6)),
    ("SReLU", ("SReLU",), dict(params=True), X25),
    ("Masking", ("Masking", 0.0), None),
    ("Highway", ("Highway",), dict(params=True), rand((3, 6), 7)),
    ("MaxoutDense", ("MaxoutDense", 4), dict(params=True, nb_feature=3),
     rand((3, 6), 8)),
    ("SeparableConvolution2D",
     ("SeparableConvolution2D", 4, 3, 3),
     dict(params=True, border_mode="same", depth_multiplier=2,
          subsample=(2, 2)), IMG),
    ("SeparableConv2D-th", ("SeparableConv2D", 3, 2, 2),
     dict(params=True, dim_ordering="th"), rand((2, 3, 6, 5), 9)),
    ("AtrousConvolution2D", ("AtrousConvolution2D", 4, 3, 3),
     dict(params=True, atrous_rate=(2, 1), border_mode="same"),
     rand((2, 9, 8, 2), 10)),
    ("AtrousConvolution1D", ("AtrousConvolution1D", 3, 3),
     dict(params=True, atrous_rate=2), SEQ),
    ("LocallyConnected1D", ("LocallyConnected1D", 3, 3),
     dict(params=True, subsample_length=2), SEQ),
    ("LocallyConnected2D", ("LocallyConnected2D", 3, 2, 2),
     dict(params=True, subsample=(2, 1)), rand((2, 6, 5, 3), 11)),
    ("Cropping1D", ("Cropping1D", (1, 2)), SEQ),
    ("Cropping2D", ("Cropping2D", ((1, 0), (2, 1))), IMG),
    ("Cropping3D", ("Cropping3D",), VOL),
    ("ZeroPadding1D", ("ZeroPadding1D", 2), SEQ),
    ("ZeroPadding3D", ("ZeroPadding3D", (1, 2, 1)), VOL),
    ("UpSampling1D", ("UpSampling1D", 3), SEQ),
    ("UpSampling3D", ("UpSampling3D", (2, 1, 2)), VOL),
    ("MaxPooling3D", ("MaxPooling3D",), rand((2, 4, 6, 4, 2), 12)),
    ("AveragePooling3D-same", ("AveragePooling3D", (2, 2, 3)),
     dict(border_mode="same"), VOL),
    ("GlobalMaxPooling3D", ("GlobalMaxPooling3D",), VOL),
    ("GlobalAveragePooling3D", ("GlobalAveragePooling3D",), VOL),
    ("ConvLSTM2D-seq", ("ConvLSTM2D", 4, 3),
     dict(params=True, return_sequences=True), rand((2, 3, 5, 5, 2), 13)),
    ("ConvLSTM2D-back-stride", ("ConvLSTM2D", 3, 3),
     dict(params=True, go_backwards=True, subsample=(2, 2)),
     rand((2, 3, 5, 5, 2), 14)),
    ("ConvLSTM3D", ("ConvLSTM3D", 2, 3), dict(params=True),
     rand((1, 2, 4, 4, 4, 2), 15)),
    ("LRN2D", ("LRN2D",), dict(alpha=1e-2), rand((2, 3, 3, 7), 16)),
    ("LRN2D-th", ("LRN2D",), dict(n=3, dim_ordering="th"),
     rand((2, 6, 3, 3), 17)),
    ("WithinChannelLRN2D", ("WithinChannelLRN2D", 3), IMG),
    ("Scale", ("Scale",), dict(params=True), rand((2, 4, 5), 18)),
    ("CAdd", ("CAdd", (1, 5)), dict(params=True), rand((2, 4, 5), 19)),
    ("CMul", ("CMul", (4, 1)), dict(params=True), rand((2, 4, 5), 20)),
    ("AddConstant", ("AddConstant", 1.5), X25),
    ("MulConstant", ("MulConstant", -2.0), X25),
    ("Abs", ("Abs",), X25),
    ("Clamp", ("Clamp", -0.5, 0.5), X25),
    ("HardTanh", ("HardTanh",), rand((2, 5), 21, 2.0)),
    ("Exp", ("Exp",), X25),
    ("Log", ("Log",), POS),
    ("Power", ("Power", 2.5, 0.5, 1.0), POS),
    ("Square", ("Square",), X25),
    ("Sqrt", ("Sqrt",), POS),
    ("Negative", ("Negative",), X25),
    ("Identity", ("Identity",), X25),
    ("HardShrink", ("HardShrink", 0.3), X25),
    ("SoftShrink", ("SoftShrink", 0.3), X25),
    ("Threshold", ("Threshold", 0.1, -2.0), X25),
    ("Softmax", ("Softmax", 1), rand((2, 4, 3), 22)),
    ("BinaryThreshold", ("BinaryThreshold", 0.1), X25),
    ("Mul", ("Mul",), dict(params=True), X25),
    ("Max", ("Max", 2), rand((2, 3, 4), 23)),
    ("Max-indices", ("Max", 1), dict(return_value=False),
     rand((2, 3, 4), 24)),
    ("SelectTable", ("SelectTable", 1), [X25, rand((2, 3), 25)]),
    ("SplitTensor", ("SplitTensor", 2, 2), rand((2, 3, 4), 26)),
    ("Expand", ("Expand", (-1, 3, -1)), rand((2, 1, 4), 27)),
    ("GetShape", ("GetShape",), rand((2, 3, 4), 28)),
    ("ShareConvolution2D", ("ShareConvolution2D", 3, 2, 2),
     dict(params=True, propagate_back=False), IMG),
    ("SparseDense", ("SparseDense", 3), dict(params=True),
     rand((3, 6), 29)),
    ("SparseDense-propagate", ("SparseDense", 3),
     dict(params=True, propagate_back=True), rand((3, 6), 30)),
    ("SparseEmbedding", ("SparseEmbedding", 10, 4), dict(params=True),
     np.asarray([[0, 3, 9], [1, 0, 0]], np.int32)),
    ("Reshape", ("Reshape", (2, -1)), rand((2, 3, 4), 31)),
    ("Permute", ("Permute", (2, 1)), rand((2, 3, 4), 32)),
    ("RepeatVector", ("RepeatVector", 3), X25),
    ("Squeeze", ("Squeeze", 2), rand((2, 3, 1), 33)),
    ("ExpandDim", ("ExpandDim", 1), rand((2, 3), 34)),
    ("Narrow", ("Narrow", 1, 1, 2), rand((2, 4, 3), 35)),
]


def _masking_input():
    x = rand((2, 4, 3), 36)
    x[0, 1] = 0.0
    x[1, 3] = 0.0
    return x


def _cases():
    for case in CASES:
        cid, args, *rest = case
        kw, x = rest if len(rest) == 2 else ({}, rest[0])
        if cid == "Masking":
            x = _masking_input()
        yield pytest.param(args, kw, x, id=cid)


@pytest.mark.parametrize("args, kw, x", list(_cases()))
def test_layer_matches_jax(args, kw, x):
    jl, tl = pair(*args, **kw)
    check(jl, tl, x)


def test_every_layers_ext_name_has_a_twin():
    assert sorted(text.__all__) == sorted(JAX_EXT_NAMES)
    for name in JAX_EXT_NAMES + ["Reshape", "Permute", "RepeatVector",
                                 "Squeeze", "ExpandDim", "Narrow",
                                 "LayerNorm"]:
        assert hasattr(tL, name), name
    jax_k2 = {n for n in dir(jK2) if not n.startswith("_")
              and n[0].isupper() or n in ("add", "multiply", "average",
                                          "maximum", "concatenate")}
    assert jax_k2 - {"Optional", "Sequence", "Union", "Layer"} <= \
        set(dir(tK2))


# ---------------------------------------------------------------------------
# Deconvolution2D and ResizeBilinear, the layers with their own semantics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k, s, mode", [
    (3, 1, "valid"), (3, 1, "same"), (3, 2, "valid"), (3, 2, "same"),
    (4, 2, "same"), (2, 2, "valid"), (2, 3, "valid"), (2, 3, "same")])
def test_deconvolution2d_matches_jax(k, s, mode):
    jl, tl = pair("Deconvolution2D", 3, k, k, params=True,
                  subsample=(s, s), border_mode=mode)
    check(jl, tl, rand((2, 5, 4, 2), 40 + k + s))


def test_deconvolution2d_th_ordering_and_alias():
    assert tL.Conv2DTranspose is tL.Deconvolution2D
    jl, tl = pair("Deconvolution2D", 2, 3, 2, params=True,
                  subsample=(2, 1), border_mode="same", dim_ordering="th")
    check(jl, tl, rand((2, 3, 4, 5), 50))


@pytest.mark.parametrize("out_hw", [(3, 5), (7, 9), (8, 2)])
@pytest.mark.parametrize("align", [False, True])
def test_resize_bilinear_matches_jax(out_hw, align):
    """Down- and up-sampling, both grids; shrinking without aligned
    corners antialiases, as `jax.image.resize` does."""
    jl, tl = pair("ResizeBilinear", *out_hw, align_corners=align)
    check(jl, tl, rand((2, 6, 5, 2), 51))


# ---------------------------------------------------------------------------
# keras2
# ---------------------------------------------------------------------------
K2_CASES = [
    ("Dense", ("Dense", 3), dict(params=True, kernel_initializer="uniform"),
     rand((3, 5), 60)),
    ("Conv1D", ("Conv1D", 3, 2), dict(params=True, strides=2,
                                      padding="same"), SEQ),
    ("Conv2D-first", ("Conv2D", 3, (2, 3)),
     dict(params=True, data_format="channels_first"),
     rand((2, 3, 6, 5), 61)),
    ("MaxPooling1D", ("MaxPooling1D", 2), SEQ),
    ("AveragePooling1D", ("AveragePooling1D", 3, 1, "same"), SEQ),
    ("MaxPooling2D", ("MaxPooling2D",), IMG),
    ("AveragePooling2D", ("AveragePooling2D", 2, 1, "same"), IMG),
    ("GlobalMaxPooling2D", ("GlobalMaxPooling2D",), IMG),
    ("GlobalAveragePooling2D-first", ("GlobalAveragePooling2D",),
     dict(data_format="channels_first"), IMG),
    ("GlobalMaxPooling1D", ("GlobalMaxPooling1D",), SEQ),
    ("GlobalAveragePooling1D", ("GlobalAveragePooling1D",), SEQ),
    ("GlobalMaxPooling3D", ("GlobalMaxPooling3D",), VOL),
    ("GlobalAveragePooling3D", ("GlobalAveragePooling3D",), VOL),
    ("Add", ("Add",), [X25, rand((2, 5), 62)]),
    ("Multiply", ("Multiply",), [X25, rand((2, 5), 63)]),
    ("Average", ("Average",), [X25, rand((2, 5), 64)]),
    ("Maximum", ("Maximum",), [X25, rand((2, 5), 65)]),
    ("Subtract", ("Subtract",), [X25, rand((2, 5), 66)]),
    ("Minimum", ("Minimum",), [X25, rand((2, 5), 67), rand((2, 5), 68)]),
    ("Concatenate", ("Concatenate", 1), [rand((2, 3, 4), 69),
                                         rand((2, 2, 4), 70)]),
    ("Dot", ("Dot", -1), [X25, rand((2, 5), 71)]),
    ("Dot-normalize-axes", ("Dot", (1, 2)), dict(normalize=True),
     [rand((2, 3, 4), 72), rand((2, 5, 3), 73)]),
    ("Activation", ("Activation", "relu"), X25),
    ("Dropout", ("Dropout", 0.3), X25),
    ("Flatten", ("Flatten",), IMG),
    ("Softmax", ("Softmax",), X25),
    ("Cropping1D", ("Cropping1D", (2, 1)), SEQ),
    ("LocallyConnected1D", ("LocallyConnected1D", 3, 2),
     dict(params=True, strides=2), SEQ),
]


def _k2_cases():
    for case in K2_CASES:
        cid, args, *rest = case
        kw, x = rest if len(rest) == 2 else ({}, rest[0])
        yield pytest.param(args, kw, x, id=cid)


@pytest.mark.parametrize("args, kw, x", list(_k2_cases()))
def test_keras2_layer_matches_jax(args, kw, x):
    jl, tl = pair(*args, jmod=jK2, tmod=tK2, **kw)
    check(jl, tl, x)


def test_keras2_functional_graph_matches_jax():
    """add / multiply / average / maximum / concatenate in one functional
    graph, the JAX tree carried across by `convert`."""
    def graph(K, inp, dev):
        a, b = inp
        d1 = K.Dense(4, **dev)(a)
        d2 = K.Dense(4, **dev)(b)
        merged = [K.add([d1, d2]), K.multiply([d1, d2]),
                  K.average([d1, d2]), K.maximum([d1, d2])]
        return K.Dense(2, **dev)(K.concatenate(merged, axis=-1))
    ji = [JInput(shape=(5,)), JInput(shape=(3,))]
    ti = [TInput(shape=(5,)), TInput(shape=(3,))]
    jm = JModel(ji, graph(jK2, ji, {}))
    tm = TModel(ti, graph(tK2, ti, CPU))
    x = [rand((4, 5), 80), rand((4, 3), 81)]
    jm.ensure_built(x)
    leaves, tree = jax.tree_util.tree_flatten(jm.params)
    jm.params = jax.tree_util.tree_unflatten(
        tree, [rand(np.shape(a), 82 + i, 0.5) for i, a in enumerate(leaves)])
    names = [l.name for l in jm._ordered_layers()]
    tm.load_state_dict(convert.model_params_from_jax(jm.params, names, tm))
    want = jax.jit(jm.apply)(jm.params, [jnp.asarray(a) for a in x])
    np.testing.assert_allclose(tm.predict(x), np.asarray(want), rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# the random layers
# ---------------------------------------------------------------------------
RANDOM = [
    ("GaussianNoise", (0.7,), lambda k, s: jax.random.normal(k, s)),
    ("GaussianDropout", (0.3,), lambda k, s: jax.random.normal(k, s)),
    ("RReLU", (0.1, 0.4),
     lambda k, s: jax.random.uniform(k, s, jnp.float32, 0.1, 0.4)),
    ("SpatialDropout1D", (0.4,),
     lambda k, s: jax.random.bernoulli(k, 0.6, (s[0], 1, s[2]))),
    ("SpatialDropout2D", (0.4,),
     lambda k, s: jax.random.bernoulli(k, 0.6, (s[0], 1, 1, s[3]))),
    ("SpatialDropout3D", (0.4,),
     lambda k, s: jax.random.bernoulli(k, 0.6, (s[0], 1, 1, 1, s[4]))),
]
RANDOM_SHAPES = {"SpatialDropout1D": (3, 4, 5), "SpatialDropout2D":
                 (3, 4, 4, 5), "SpatialDropout3D": (2, 3, 3, 3, 4)}


@pytest.mark.parametrize("name, args, jdraw", RANDOM,
                         ids=[r[0] for r in RANDOM])
def test_random_layer_parity(name, args, jdraw):
    """Exact in inference, at rate 0 and against the JAX layer's own draw
    injected; the same statistics in training."""
    jl, tl = pair(name, *args)
    shape = RANDOM_SHAPES.get(name, (3, 7))
    x = rand(shape, 90)
    want = np.asarray(jl.call({}, jnp.asarray(x)))
    np.testing.assert_allclose(tl.call(torch.as_tensor(x)).numpy(), want,
                               rtol=0, atol=TOL)
    if name != "RReLU":
        np.testing.assert_array_equal(want, x)
        zero_j, zero_t = pair(name, 0.0)
        np.testing.assert_array_equal(zero_t.call(torch.as_tensor(x),
                                                  training=True,
                                                  seed=3).numpy(), x)
        np.testing.assert_array_equal(np.asarray(zero_j.call(
            {}, jnp.asarray(x), training=True, rng=jax.random.PRNGKey(3))),
            x)
    key = jax.random.PRNGKey(7)
    draw = jdraw(key, shape)
    want = jl.call({}, jnp.asarray(x), training=True, rng=key)
    got = tl.apply(torch.as_tensor(x), torch.as_tensor(np.array(draw)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    with pytest.raises(ValueError, match="seed"):
        tl.call(torch.as_tensor(x), training=True)
    _same_statistics(name, tl)


STAT_SHAPES = {"SpatialDropout1D": (64, 3, 64),
               "SpatialDropout2D": (64, 2, 3, 64),
               "SpatialDropout3D": (64, 2, 2, 2, 64)}
# the mean and standard deviation of the layer's output on ones (RReLU:
# on minus ones) under the JAX layer's distribution
STATS = {"GaussianNoise": (1.0, 0.7),
         "GaussianDropout": (1.0, np.sqrt(0.3 / 0.7)),
         "RReLU": (-0.25, 0.3 / np.sqrt(12.0))}


def _same_statistics(name, tl):
    """The port layer's training output on a large input against the JAX
    layer's distribution: the noise's mean and spread, or the kept share
    of whole feature maps; one seed reproduces a draw, another changes
    it."""
    shape = STAT_SHAPES.get(name, (400, 500))
    x = torch.full(shape, -1.0 if name == "RReLU" else 1.0)
    out = tl.call(x, training=True, seed=11).numpy()
    assert not np.array_equal(out, tl.call(x, training=True,
                                           seed=12).numpy())
    np.testing.assert_array_equal(out, tl.call(x, training=True,
                                               seed=11).numpy())
    if name in STATS:
        mean, std = STATS[name]
        assert abs(out.mean() - mean) < 0.01 * std * 2
        assert abs(out.std() - std) < 0.01 * std
        return
    maps = out.reshape(shape[0], -1, shape[-1])
    # every (sample, channel) map is whole: all kept (x / 0.6) or all zero
    assert np.all(maps.min(axis=1) == maps.max(axis=1))
    assert abs(np.mean(maps[:, 0] > 0) - 0.6) < 0.04


def test_gaussian_sampler_parity():
    jl, tl = pair("GaussianSampler")
    mean, log_var = rand((3, 4), 91), rand((3, 4), 92, 0.5)
    xs = [torch.as_tensor(mean), torch.as_tensor(log_var)]
    np.testing.assert_array_equal(tl.call(xs).numpy(), mean)
    key = jax.random.PRNGKey(5)
    want = jl.call({}, [jnp.asarray(mean), jnp.asarray(log_var)],
                   training=True, rng=key)
    eps = jax.random.normal(key, mean.shape)
    np.testing.assert_allclose(tl.apply(xs, torch.as_tensor(
        np.array(eps))).numpy(), np.asarray(want), rtol=0, atol=TOL)
    # N(0, 1) scaled by exp(log 4 / 2) = 2
    big = [torch.zeros(500, 400), torch.full((500, 400), np.log(4.0))]
    draw = tl.call(big, training=True, seed=4).numpy()
    assert abs(draw.std() - 2.0) < 0.02 and abs(draw.mean()) < 0.02


def test_random_layers_draw_in_a_model_from_its_seed():
    """A functional model hands each random node its own site seed: one
    step seed reproduces the draws, another changes them."""
    inp = TInput(shape=(6,))
    h = tL.GaussianNoise(0.5)(inp)
    out = tL.RReLU()(tL.Dense(4, **CPU)(h))
    m = TModel(inp, out)
    m.ensure_built(seed=0)
    x = torch.as_tensor(rand((5, 6), 93))
    a = m.apply(x, training=True, seed=21)
    np.testing.assert_array_equal(a.detach().numpy(), m.apply(
        x, training=True, seed=21).detach().numpy())
    assert not torch.equal(a, m.apply(x, training=True, seed=22))
    assert torch.equal(m.apply(x), m.apply(x))


# ---------------------------------------------------------------------------
# names and layers inside models
# ---------------------------------------------------------------------------
def test_reset_name_scope():
    tengine.reset_name_scope()
    jengine.reset_name_scope()
    assert tL.Dense(3, **CPU).name == jL.Dense(3).name == "dense_1"
    assert tL.Dense(3, **CPU).name == "dense_2"
    tengine.reset_name_scope()
    assert tL.Dense(3, **CPU).name == "dense_1"
    assert tL.Highway(**CPU).name == "highway_1"


def test_ext_layers_in_a_sequential_fit():
    """A stack of layers_ext layers trains through the port's fit, the
    loss falling, with the parameters created from `input_shape`."""
    from analytics_zoo_tpu_torch.keras.engine import Sequential
    from analytics_zoo_tpu_torch.ops import optimizers
    m = Sequential([
        tL.Convolution2D(4, 3, 3, input_shape=(6, 6, 2), **CPU),
        tL.SReLU(**CPU), tL.SeparableConvolution2D(4, 3, 3, **CPU),
        tL.SpatialDropout2D(0.1), tL.Flatten(), tL.Highway(**CPU),
        tL.MaxoutDense(3, **CPU)])
    m.compile(optimizers.adam(1e-2), "mse")
    x, y = rand((8, 6, 6, 2), 94), rand((8, 3), 95)
    hist = m.fit(x, y, batch_size=8, nb_epoch=4, device_cache=False)
    assert hist["loss"][-1] < hist["loss"][0]


def test_channel_helpers_round_trip():
    x = torch.as_tensor(rand((2, 3, 4, 5), 96))
    for r, order in itertools.product((2,), ("th", "tf")):
        y = tL._to_channels_last(x, order, r)
        assert torch.equal(tL._from_channels_last(y, order, r), x)
    assert tL._to_channels_last(x, "th", 2).shape == (2, 4, 5, 3)
