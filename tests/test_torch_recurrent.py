"""The port's recurrent layers and `Sequential` held against the JAX
package on the CPU: `SimpleRNN`, `LSTM`, `GRU` (reset before and after),
`Bidirectional` (four merge modes), `TimeDistributed`, `WordEmbedding`,
`ZeroPadding2D`, `UpSampling2D`, the initializers, and `Sequential` (a
list, nested, as a node of a functional `Model`, built from a sample
batch).

Each layer runs inside a one-layer `Sequential` on both sides: the JAX
package builds the weights, every leaf is replaced by seeded random values
(so the biases are not zero and a gate-order slip shows), and `convert`
carries them to the port. Inputs come from numpy with a seed. Sizes are
small: T <= 8, widths <= 16.

Tolerances (absolute):
- forwards in float32: 1e-5 (the same sums in another order: the port adds
  the bias to the input product before the recurrent product, JAX after;
  `hard_sigmoid` is x/6 + 1/2 here, (x + 3)/6 there);
- forwards with bfloat16 parameters: 2e-2 (h and c round to bf16 at every
  step in both packages, at other places);
- gradients of LSTM and GRU against `jax.grad`: 1e-4;
- padding, up-sampling and the initializers' checks as stated there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import Input as JInput
from analytics_zoo_tpu.keras import Model as JModel
from analytics_zoo_tpu.keras import Sequential as JSequential
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.keras import Input, Model, Sequential
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.kernels import dropout as dr
from analytics_zoo_tpu_torch.kernels.philox import site_seed

B, T, F_IN, H = 3, 6, 5, 7
TOL = 1e-5
BF16_TOL = 2e-2
GRAD_TOL = 1e-4

# (name, JAX class, port class, constructor keywords)
CELLS = [("simple_rnn", JL.SimpleRNN, L.SimpleRNN, {}),
         ("lstm", JL.LSTM, L.LSTM, {}),
         ("gru", JL.GRU, L.GRU, {}),
         ("gru_reset_after", JL.GRU, L.GRU, {"reset_after": True})]


def names(jmodel):
    """The JAX model's layer names in graph order, a nested Sequential as
    (name, [its names]), as `convert` takes them."""
    return [(l.name, names(l)) if hasattr(l, "_ordered_layers") else l.name
            for l in jmodel._ordered_layers()]


def randomize(tree, seed, scale=0.5):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rs.standard_normal(np.shape(a)) * scale).astype(
            np.float32), tree)


def pair(jlayers, tlayers, in_shape, seed=0):
    """Build both stacks on `in_shape` (batch excluded); the JAX weights,
    randomized, carried to the port. Returns (JAX model, its tree, port
    model)."""
    j = JSequential(jlayers)
    params = randomize(j.build(jax.random.PRNGKey(seed),
                               (None,) + tuple(in_shape)), seed + 1)
    t = Sequential(tlayers)
    t.ensure_parameters((None,) + tuple(in_shape))
    t.load_state_dict(convert.model_params_from_jax(params, names(j), t))
    return j, params, t


def x_of(shape, seed=5):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def port_out(t, x, **kw):
    with torch.no_grad():
        return t.apply(torch.from_numpy(x), **kw).float().numpy()


# ---------------------------------------------------------------------------
# recurrent layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("go_backwards", [False, True])
def test_recurrent_forward_matches_jax(cell, return_sequences, go_backwards):
    _, jcls, tcls, kw = cell
    opts = dict(return_sequences=return_sequences, go_backwards=go_backwards,
                **kw)
    j, params, t = pair([jcls(H, **opts)], [tcls(H, device="cpu", **opts)],
                        (T, F_IN))
    x = x_of((B, T, F_IN))
    want = np.asarray(j.apply(params, x))
    got = port_out(t, x)
    assert got.shape == want.shape == ((B, T, H) if return_sequences
                                       else (B, H))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_recurrent_bf16_params_match_jax(cell):
    """bf16 parameters on both sides: the input follows them and so does
    the carry, every step."""
    _, jcls, tcls, kw = cell
    j, params, t = pair([jcls(H, return_sequences=True, **kw)],
                        [tcls(H, return_sequences=True, device="cpu", **kw)],
                        (T, F_IN))
    params16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                      params)
    t = t.to(torch.bfloat16)
    x = x_of((B, T, F_IN))
    want = np.asarray(j.apply(params16, x)).astype(np.float32)
    with torch.no_grad():
        out = t.apply(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=BF16_TOL)


@pytest.mark.parametrize("cell", CELLS[1:], ids=[c[0] for c in CELLS[1:]])
@pytest.mark.parametrize("go_backwards", [False, True])
def test_recurrent_gradients_match_jax(cell, go_backwards):
    """d(sum(out · w)) for every parameter and for the input, against
    `jax.grad` of the JAX layer."""
    _, jcls, tcls, kw = cell
    opts = dict(return_sequences=True, go_backwards=go_backwards, **kw)
    j, params, t = pair([jcls(H, **opts)], [tcls(H, device="cpu", **opts)],
                        (T, F_IN))
    x = x_of((B, T, F_IN))
    w = x_of((B, T, H), seed=6)

    def loss(p, xx):
        return jnp.sum(j.apply(p, xx) * w)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    (t.apply(xt) * torch.from_numpy(w)).sum().backward()
    want = convert.model_params_from_jax(gp, names(j), t)
    assert sorted(want) == sorted(n for n, _ in t.named_parameters())
    for key, p in t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[key].numpy(), rtol=0,
                                   atol=GRAD_TOL, err_msg=key)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=GRAD_TOL)


def test_recurrent_parameters_layout():
    """JAX's leaves and shapes: kernel [F, n·H], recurrent [H, n·H], bias
    [n·H]; reset_after adds recurrent_bias. Built from a seed, the
    recurrent kernel is orthogonal (rows) and the biases zero."""
    for cls, n, extra in ((L.SimpleRNN, 1, {}), (L.LSTM, 4, {}),
                          (L.GRU, 3, {"reset_after": True})):
        layer = cls(H, input_shape=(T, F_IN), device="cpu", **extra)
        layer.build(torch.Generator().manual_seed(0))
        shapes = {k: tuple(v.shape) for k, v in layer.state_dict().items()}
        want = {"kernel": (F_IN, n * H), "recurrent": (H, n * H),
                "bias": (n * H,)}
        if extra:
            want["recurrent_bias"] = (n * H,)
        assert shapes == want
        r = layer.recurrent.detach()
        torch.testing.assert_close(r @ r.T, torch.eye(H), rtol=0, atol=1e-5)
        assert not layer.bias.any()


@pytest.mark.parametrize("mode", ["concat", "sum", "mul", "ave"])
@pytest.mark.parametrize("return_sequences", [False, True])
def test_bidirectional_matches_jax(mode, return_sequences):
    j, params, t = pair(
        [JL.Bidirectional(JL.LSTM(H, return_sequences=return_sequences),
                          merge_mode=mode)],
        [L.Bidirectional(L.LSTM(H, return_sequences=return_sequences,
                                device="cpu"), merge_mode=mode)],
        (T, F_IN))
    layer = t.ordered_layers()[0]
    assert layer.backward_layer.go_backwards and \
        not layer.forward_layer.go_backwards
    assert {k.split(".")[1] for k in t.state_dict()} == {
        "forward_layer", "backward_layer"}
    x = x_of((B, T, F_IN))
    want = np.asarray(j.apply(params, x))
    got = port_out(t, x)
    assert got.shape == want.shape
    assert t.compute_output_shape((None, T, F_IN)) == \
        j.compute_output_shape((None, T, F_IN))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="merge_mode"):
        L.Bidirectional(L.LSTM(H, device="cpu"), merge_mode="max")


@pytest.mark.parametrize("inner", ["dense", "conv1d"])
def test_time_distributed_matches_jax(inner):
    """The inner layer on every step; its leaves sit at the wrapper's own
    level in the JAX tree (a conv kernel transposed on the way)."""
    if inner == "dense":
        jl, tl, shape = JL.Dense(4), L.Dense(4, device="cpu"), (T, F_IN)
    else:
        jl = JL.Convolution1D(4, 3, activation="relu")
        tl = L.Convolution1D(4, 3, activation="relu", device="cpu")
        shape = (T, 8, 2)
    j, params, t = pair([JL.TimeDistributed(jl)], [L.TimeDistributed(tl)],
                        shape)
    assert set(params[names(j)[0]]) == set(
        k.split(".")[-1] for k in t.state_dict())
    x = x_of((B,) + shape)
    want = np.asarray(j.apply(params, x))
    got = port_out(t, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    back = convert.model_params_to_jax(t.state_dict(), names(j), t)
    for leaf, value in params[names(j)[0]].items():
        np.testing.assert_array_equal(back[names(j)[0]][leaf], value)


@pytest.mark.parametrize("order", ["tf", "th"])
def test_zero_padding_and_up_sampling_match_jax(order):
    shape = (4, 5, 3)
    x = x_of((2,) + shape)
    for jl, tl in ((JL.ZeroPadding2D((1, 2), dim_ordering=order),
                    L.ZeroPadding2D((1, 2), dim_ordering=order)),
                   (JL.UpSampling2D((2, 3), dim_ordering=order),
                    L.UpSampling2D((2, 3), dim_ordering=order))):
        want = np.asarray(jl.call({}, jnp.asarray(x)))
        got = tl(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert tl.compute_output_shape((None,) + shape) == \
            jl.compute_output_shape((None,) + shape) == \
            (None,) + want.shape[1:]


def test_word_embedding_is_frozen_and_matches_jax():
    matrix = x_of((11, 4))
    j, params, t = pair([JL.WordEmbedding(matrix)],
                        [L.WordEmbedding(matrix, device="cpu")], (T,))
    layer = t.ordered_layers()[0]
    assert not layer.trainable and layer.embeddings.requires_grad
    ids = np.random.RandomState(3).randint(0, 11, (B, T)).astype(np.float32)
    # a fresh build fills the given matrix
    fresh = L.WordEmbedding(matrix, device="cpu").build(
        torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(fresh.embeddings.detach().numpy(), matrix)
    out = t.apply(torch.from_numpy(ids))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(j.apply(params, ids)), rtol=0,
                               atol=0)
    # no gradient reaches the table (JAX: stop_gradient)
    assert not out.requires_grad


# ---------------------------------------------------------------------------
# Sequential
# ---------------------------------------------------------------------------
def test_nested_sequential_matches_jax_and_converts():
    """A Sequential inside a Sequential: state-dict keys nest under the
    inner stack's name, and the nested JAX tree crosses both ways."""
    ji = JSequential([JL.LSTM(6, return_sequences=True), JL.Dense(4)])
    j = JSequential([JL.Dense(5, input_shape=(T, 3)), ji, JL.GRU(4)])
    params = randomize(j.build(jax.random.PRNGKey(0), (None, T, 3)), 1)
    ti = Sequential([L.LSTM(6, return_sequences=True, device="cpu"),
                     L.Dense(4, device="cpu")])
    t = Sequential([L.Dense(5, input_shape=(T, 3), device="cpu")])
    assert t.input_shape == (None, T, 3)
    t.add(ti).add(L.GRU(4, device="cpu"))
    keys = list(t.state_dict())
    assert f"{ti.name}.{ti.layers[0].name}.recurrent" in keys
    assert len(keys) == 2 + 5 + 3
    t.load_state_dict(convert.model_params_from_jax(params, names(j), t))
    x = x_of((B, T, 3))
    np.testing.assert_allclose(port_out(t, x), np.asarray(j.apply(params, x)),
                               rtol=0, atol=TOL)
    assert t.compute_output_shape((None, T, 3)) == (None, 4)
    back = convert.model_params_to_jax(t.state_dict(), names(j), t)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_sequential_as_a_node_of_a_model_matches_jax():
    """A Sequential called on a `Node` of a functional graph."""
    ji = JSequential([JL.GRU(6, return_sequences=True), JL.SimpleRNN(5)])
    jin = JInput((T, 3))
    j = JModel(jin, JL.Dense(2, activation="softmax")(ji(jin)))
    params = randomize(j.build(jax.random.PRNGKey(2), (None, T, 3)), 3)
    ti = Sequential([L.GRU(6, return_sequences=True, device="cpu"),
                     L.SimpleRNN(5, device="cpu")])
    tin = Input((T, 3))
    mid = ti(tin)
    assert mid.shape == (None, 5) and ti._params_created
    t = Model(tin, L.Dense(2, activation="softmax", device="cpu")(mid))
    t.load_state_dict(convert.model_params_from_jax(params, names(j), t))
    x = x_of((B, T, 3))
    np.testing.assert_allclose(port_out(t, x), np.asarray(j.apply(params, x)),
                               rtol=0, atol=TOL)


def test_sequential_built_from_a_sample_batch():
    """No input_shape on the first layer: the parameters wait for
    `ensure_built(sample)`; the port's weights carried to JAX give its
    forward."""
    t = Sequential([L.LSTM(5, device="cpu"), L.Dense(2, device="cpu")])
    assert t.input_shape is None and not t._params_created
    assert list(t.state_dict()) == []
    with pytest.raises(ValueError, match="no input_shape"):
        t.ensure_built()
    x = x_of((B, T, 3))
    t.ensure_built(x, seed=4)
    assert t.built and [tuple(v.shape) for v in t.state_dict().values()] == [
        (3, 20), (5, 20), (20,), (5, 2), (2,)]
    j = JSequential([JL.LSTM(5), JL.Dense(2)])
    j.ensure_built(x)
    params = convert.model_params_to_jax(t.state_dict(), names(j), t)
    np.testing.assert_allclose(port_out(t, x), np.asarray(j.apply(params, x)),
                               rtol=0, atol=TOL)


def test_sequential_hands_dropout_a_seed_per_layer():
    """Layer i of a training forward gets `site_seed(seed, i)`."""
    t = Sequential([L.Dense(8, input_shape=(4,), device="cpu"),
                    L.Dropout(0.5)])
    t.ensure_built(seed=0)
    x = torch.from_numpy(x_of((6, 4)))
    with torch.no_grad():
        dense = t.layers[0](x)
        got = t.apply(x, training=True, seed=11)
    keep = dr.dropout_keep(dense.shape, site_seed(11, 1), 0.5)
    torch.testing.assert_close(got, torch.where(keep, dense * 2.0, 0.0))
    with pytest.raises(ValueError, match="already"):
        t.add(t.layers[0])


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["glorot_uniform", "glorot_normal",
                                  "he_normal", "he_uniform", "lecun_normal",
                                  "uniform", "normal", "ones", "zeros"])
def test_initializer_moments_match_jax(name):
    """Mean, standard deviation and 99th percentile of the magnitude of a
    120 x 160 draw against the JAX initializer's (12 / sqrt(n) of a std on
    the mean, 5% on the others: sampling noise at n = 19,200 is below a
    third of that), and for the bounded ones (uniform, truncated normal)
    the largest magnitude, 5%."""
    shape = (120, 160)
    got = L.get_init(name)(torch.Generator().manual_seed(0), shape).numpy()
    want = np.asarray(JL.get_init(name)(jax.random.PRNGKey(0), shape,
                                        jnp.float32))
    assert got.shape == shape and got.dtype == np.float32
    n = got.size
    sd = max(want.std(), 1e-12)
    assert abs(got.mean() - want.mean()) <= 12 * sd / np.sqrt(n) + 1e-7
    assert got.std() == pytest.approx(want.std(), rel=0.05, abs=1e-7)
    assert np.percentile(np.abs(got), 99) == pytest.approx(
        np.percentile(np.abs(want), 99), rel=0.05, abs=1e-7)
    if name != "normal":
        assert np.abs(got).max() == pytest.approx(np.abs(want).max(),
                                                  rel=0.05)


@pytest.mark.parametrize("shape", [(8, 32), (32, 8), (2, 3, 8)])
def test_orthogonal_initializer_matches_jax(shape):
    """Orthonormal rows when the matrix (the last axis the columns) is
    wide, orthonormal columns when tall, as the JAX initializer gives."""
    got = L.get_init("orthogonal")(torch.Generator().manual_seed(0),
                                   shape).numpy()
    want = np.asarray(JL.get_init("orthogonal")(jax.random.PRNGKey(0),
                                                shape, jnp.float32))
    for a in (got, want):
        assert a.shape == shape
        m = a.reshape(-1, shape[-1])
        gram = m @ m.T if m.shape[0] < m.shape[1] else m.T @ m
        np.testing.assert_allclose(gram, np.eye(len(gram)), rtol=0,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="2D"):
        L.get_init("orthogonal")(torch.Generator(), (4,))
