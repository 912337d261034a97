"""The port's int8 serving path held against the JAX package on the CPU:
the quantizers, `int8_matmul`, `dequantize_rows` and the weight-only int8
convolution; the quantized trees of a Dense model, an Embedding + Conv1D
model, a nested conv `Model` and a tiny `BERTClassifier` (2 blocks,
hidden 64, seq 16, stacked and not) through `convert` both ways; served
int8 outputs; `save_quantized` / `load_quantized` across the packages; the
checkpoint sidecar of `fit_keras(int8_sidecar=True)`; and the quality gate
of `Estimator.evaluate(quantize="int8")`.

Inputs are made with numpy from a seed; the port's weights are its own
`ensure_built` draws, carried to the JAX model by `convert`.

Tolerances: the quantizers, the int8 product, the row dequantization, the
int8 convolution (against the JAX layer run eagerly), the trees and the
artifacts are bitwise (0). Served outputs: 1e-3 max abs with the same
top-1 on every row (the worst seen here 1.6e-4, the Embedding + Conv1D
model; Dense and BERT 3e-8 and 1.5e-8): f32 rounding in a LayerNorm, a
GELU or a softmax can move a value across an int8 rounding boundary. The
Conv2D models (flat and nested) are held against the JAX package's served
(jitted) output at 1e-2 only: XLA's jitted bf16 convolution differs from
its own eager one by one bf16 ulp (1.5e-2 on a conv output near 2), and
the port's convolution matches the eager one bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from analytics_zoo_tpu.keras import Input as JInput
from analytics_zoo_tpu.keras import Model as JModel
from analytics_zoo_tpu.keras import Sequential as JSequential
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.learn import checkpoint as jckpt
from analytics_zoo_tpu.models.bert import BERTClassifier as JClassifier
from analytics_zoo_tpu.serving import quantization as JQ
from analytics_zoo_tpu.serving.inference_model import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input, Model, Sequential
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
from analytics_zoo_tpu_torch.learn.estimator import (Estimator,
                                                     QuantizationQualityError)
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from analytics_zoo_tpu_torch.observability.registry import get_registry
from analytics_zoo_tpu_torch.observability.roofline import (
    RooflineAccountant, count_cost)
from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry
from analytics_zoo_tpu_torch.serving import quantization as Q
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel
from analytics_zoo_tpu_torch.utils import roofline as peaks

SERVE_TOL = 1e-3
CONV2D_SERVE_TOL = 1e-2
BERT_CFG = dict(vocab=64, hidden_size=64, n_block=2, n_head=4, seq_len=16,
                intermediate_size=128)
CPU = {"device": "cpu"}


def names(jmodel):
    return [(l.name, names(l)) if hasattr(l, "_ordered_layers") else l.name
            for l in jmodel._ordered_layers()]


# ---------------------------------------------------------------------------
# models: the same architecture in both packages, the port's weights
# ---------------------------------------------------------------------------
def _dense(L_, S, dev):
    return S([L_.Dense(32, activation="relu", input_shape=(16,), **dev),
              L_.Dense(4, activation="softmax", **dev)])


def _conv_embedding(L_, S, dev):
    return S([L_.Embedding(500, 8, input_shape=(12,), **dev),
              L_.Convolution1D(16, 3, activation="relu", **dev),
              L_.GlobalMaxPooling1D(),
              L_.Dense(3, activation="softmax", **dev)])


def _conv2d(L_, S, dev):
    return S([L_.Convolution2D(4, 3, 3, border_mode="same",
                               input_shape=(8, 8, 3), **dev),
              L_.Activation("relu"), L_.Flatten(),
              L_.Dense(5, activation="softmax", **dev)])


def _nested(L_, S, dev, In=None, M=None):
    """A conv trunk (Conv2D, MaxPooling, Dense) nested as a layer, then a
    Dense head."""
    t_in = In(shape=(8, 8, 3))
    h = L_.Convolution2D(4, 3, 3, activation="relu", **dev)(t_in)
    h = L_.Flatten()(L_.MaxPooling2D(pool_size=(2, 2))(h))
    trunk = M(t_in, L_.Dense(6, activation="relu", **dev)(h))
    inp = In(shape=(8, 8, 3))
    return M(inp, L_.Dense(3, activation="softmax", **dev)(trunk(inp)))


MODELS = {
    "dense": (_dense, lambda rs: rs.randn(9, 16).astype(np.float32)),
    "conv_embedding": (_conv_embedding,
                       lambda rs: rs.randint(0, 500, (9, 12)).astype(
                           np.int32)),
    "nested": (_nested, lambda rs: rs.randn(9, 8, 8, 3).astype(np.float32)),
    "conv2d": (_conv2d, lambda rs: rs.randn(9, 8, 8, 3).astype(np.float32)),
}


def model_pair(kind, seed=3):
    build, _ = MODELS[kind]
    if kind == "nested":
        t = build(L, None, CPU, Input, Model)
        j = build(JL, None, {}, JInput, JModel)
    else:
        t, j = build(L, Sequential, CPU), build(JL, JSequential, {})
    t.ensure_built(seed=seed)
    j.params = convert.model_params_to_jax(t.state_dict(), names(j), t)
    return t, j


def model_input(kind, seed=0):
    return MODELS[kind][1](np.random.RandomState(seed))


def bert_pair(stacked=False, seed=1):
    tm = BERTClassifier(3, device="cpu", **BERT_CFG)
    tm.ensure_built(seed=seed)
    jm = JClassifier(3, stacked=stacked, **BERT_CFG)
    jm.params = convert.params_to_jax(tm.state_dict(), stacked=stacked)
    return tm, jm


def bert_input(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, BERT_CFG["vocab"], (5, 16)).astype(np.int32)
    lens = np.array([16, 9, 3, 12, 16])
    return [ids, (np.arange(16)[None] < lens[:, None]).astype(np.int32)]


def assert_trees_equal(got, want):
    """Same keys, dtypes and values, leaf for leaf."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k])
    else:
        want, got = np.asarray(want), np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def assert_states_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# compute paths, bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(5, 13), (3, 7, 64), (1, 768)])
def test_quantize_activations_matches_jax(shape):
    x = np.random.RandomState(len(shape)).randn(*shape).astype(
        np.float32) * 3
    jq, js = JQ.quantize_activations(jnp.asarray(x))
    tq, ts = Q.quantize_activations(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)


@pytest.mark.parametrize("shape,axes", [
    ((64, 32), (0,)),            # a Dense / raw kernel, per out channel
    ((2, 64, 32), (1,)),         # a stacked encoder's [L, in, out]
    ((3, 3, 4, 8), (0, 1, 2)),   # an HWIO conv kernel
    ((50, 8), (1,)),             # an embedding table, per row
])
def test_quantize_tensor_matches_jax(shape, axes):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    w[0] = 0.0                   # an all-zero channel takes the eps scale
    q, s = Q._quantize_tensor(w, axes)
    jq, js = JQ._quantize_tensor(w, axes)
    assert_trees_equal(q, jq)
    assert_trees_equal(s, js)


@pytest.mark.parametrize("shape,n", [((5, 13), 6), ((3, 7, 64), 10),
                                     ((1, 768), 2)])
def test_int8_matmul_matches_jax(shape, n):
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    q, s = JQ._quantize_tensor(rs.randn(shape[-1], n).astype(np.float32),
                               (0,))
    want = np.asarray(JQ.int8_matmul(jnp.asarray(x), jnp.asarray(q),
                                     jnp.asarray(s)))
    got = Q.int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                        torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dequantize_rows_matches_jax():
    rs = np.random.RandomState(2)
    q, s = JQ._quantize_tensor(rs.randn(20, 5).astype(np.float32), (1,))
    ids = rs.randint(0, 20, (3, 4))
    want = np.asarray(JQ.dequantize_rows(jnp.asarray(q), jnp.asarray(s),
                                         jnp.asarray(ids)))
    got = Q.dequantize_rows(torch.from_numpy(q), torch.from_numpy(s),
                            torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.gpu
def test_card_int8_matmul_is_bitwise_the_cpus():
    """On the card the activation scale, the quantized activations and the
    dequantized product are the CPU's, bit for bit (a divisor given as a
    Python number would be a reciprocal multiply there, one ulp off for
    some abs-max values); with an unaligned weight and a short batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch._int_mm on CUDA)")
    g = torch.Generator().manual_seed(7)
    for shape, n in [((4, 512, 768), 2304), ((3, 768), 2)]:
        for _ in range(20):
            x = torch.randn(shape, generator=g) * 3
            w_q = torch.randint(-127, 128, (shape[-1], n), dtype=torch.int8,
                                generator=g)
            w_scale = torch.rand(n, generator=g) * 1e-3
            want = Q.int8_matmul(x, w_q, w_scale)
            got = Q.int8_matmul(x.cuda(), w_q.cuda(), w_scale.cuda())
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m,k,n", [(1, 13, 2), (16, 8, 8), (17, 24, 10),
                                   (3, 768, 2)])
def test_int8_mm_pads_odd_shapes(m, k, n):
    """`_int_mm`'s rules on the card (more than 16 rows, K and N multiples
    of 8) are met by zero padding, which is exact; a weight that needs
    padding is padded once per tensor, column-major, an aligned one is
    used as it is."""
    g = torch.Generator().manual_seed(m * k * n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g)
    got = Q.int8_mm(a, w)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, a.int() @ w.int())
    op = Q._mm_operand(w)
    assert op.shape[0] % 8 == 0 and op.shape[1] % 8 == 0
    if k % 8 == 0 and n % 8 == 0:
        assert op is w and not hasattr(w, "_int8_operand")
        return
    assert op.stride(0) == 1                      # column-major
    assert Q._mm_operand(w) is op                 # cached on the tensor
    w.neg_()                                      # an in-place write
    assert Q._mm_operand(w) is not op
    assert torch.equal(Q.int8_mm(a, w), a.int() @ w.int())


@pytest.mark.parametrize("kind", ["conv1d", "conv2d"])
def test_int8_conv_matches_jax_layer(kind):
    """The layer's weight-only int8 convolution (kernel OIHW here, HWIO in
    the JAX tree) against the JAX layer run eagerly, bias and activation
    included."""
    rs = np.random.RandomState(4)
    if kind == "conv1d":
        t = L.Convolution1D(6, 3, activation="relu", input_shape=(10, 5),
                            **CPU)
        j = JL.Convolution1D(6, 3, activation="relu")
        x = rs.randn(4, 10, 5).astype(np.float32)
    else:
        t = L.Convolution2D(6, 3, 3, activation="relu", border_mode="same",
                            subsample=(2, 2), input_shape=(9, 9, 3), **CPU)
        j = JL.Convolution2D(6, 3, 3, activation="relu", border_mode="same",
                             subsample=(2, 2))
        x = rs.randn(4, 9, 9, 3).astype(np.float32)
    net = Sequential([t])
    net.ensure_built(seed=5)
    with torch.no_grad():
        t.bias.copy_(torch.randn(6) * 0.1)
    sub = convert.model_params_to_jax(net.state_dict(), [j.name], net)[
        j.name]
    jq = {k: v for k, v in sub.items() if k != "kernel"}
    jq["kernel_q"], jq["kernel_scale"] = JQ._quantize_tensor(
        sub["kernel"], tuple(range(sub["kernel"].ndim - 1)))
    want = np.asarray(j.call(jq, jnp.asarray(x)))
    q = Q.quantize_model_params(net)
    with torch.no_grad():
        got = q.apply(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError, match="float"):
        Q.int8_conv(torch.zeros(1, 3, 4, 4, dtype=torch.uint8),
                    q.state_dict()[f"{t.name}.kernel_q"],
                    q.state_dict()[f"{t.name}.kernel_scale"], F.conv2d)


# ---------------------------------------------------------------------------
# quantized trees through convert
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["dense", "conv_embedding", "nested"])
def test_quantized_tree_crosses_convert(kind):
    t, j = model_pair(kind)
    jq = JQ.quantize_model_params(j, jax.device_get(j.params))
    q = Q.quantize_model_params(t)
    # port → JAX: the int8 module's state is the JAX package's tree
    assert_trees_equal(convert.model_params_to_jax(q.state_dict(),
                                                   names(j), q), jq)
    # JAX → port: the JAX tree is the int8 module's state
    assert_states_equal(convert.model_params_from_jax(jq, names(j), t),
                        q.state_dict())
    kinds = {k.rsplit(".", 1)[1] for k in q.state_dict()}
    assert {"kernel_q", "kernel_scale"} <= kinds and "kernel" not in kinds


@pytest.mark.parametrize("stacked", [False, True])
def test_bert_quantized_tree_crosses_convert(stacked):
    tm, jm = bert_pair(stacked)
    jq = JQ.quantize_model_params(jm, jm.params)
    q = Q.quantize_model_params(tm)
    assert_trees_equal(convert.params_to_jax(q.state_dict(),
                                             stacked=stacked), jq)
    assert_states_equal(convert.params_from_jax(jq), q.state_dict())
    sd = q.state_dict()
    assert sd["bert.blocks.1.attn.qkv_kernel_q"].dtype == torch.int8
    assert sd["bert.blocks.1.ffn_in_kernel_scale"].shape == (128,)
    assert sd["cls_kernel_q"].shape == (64, 3)
    # the embeddings are raw parameters, not an Embedding layer: f32
    assert sd["bert.word_embeddings"].dtype == torch.float32


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["dense", "conv_embedding", "bert"])
def test_served_int8_matches_jax(kind):
    if kind == "bert":
        t, j = bert_pair()
        x = bert_input()
    else:
        t, j = model_pair(kind)
        x = model_input(kind)
    want = np.asarray(JInferenceModel().load_keras(
        j, quantize="int8").predict(x))
    im = InferenceModel(device="cpu").load_keras(t, quantize="int8")
    assert im.serving_dtype == "int8"
    got = im.predict(x)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= SERVE_TOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("kind", ["conv2d", "nested"])
def test_served_int8_conv2d_within_a_bf16_ulp_of_jax(kind):
    t, j = model_pair(kind)
    x = model_input(kind)
    want = np.asarray(JInferenceModel().load_keras(
        j, quantize="int8").predict(x))
    got = InferenceModel(device="cpu").load_keras(
        t, quantize="int8").predict(x)
    assert np.abs(got - want).max() <= CONV2D_SERVE_TOL


def test_f32_model_is_untouched_and_int8_is_smaller():
    t, _ = model_pair("dense")
    before = {k: v.clone() for k, v in t.state_dict().items()}
    q = Q.quantize_model_params(t)
    assert q is not t
    assert_states_equal(t.state_dict(), before)
    f32 = sum(v.numel() * v.element_size() for v in before.values())
    im = InferenceModel(device="cpu").load_keras(t, quantize="int8")
    assert im.weight_bytes() < 0.5 * f32
    # an int8 state loads onto the f32 architecture as a structural copy
    im2 = InferenceModel(device="cpu").load_keras(t, params=q.state_dict())
    assert im2.serving_dtype == "int8"
    x = model_input("dense")
    np.testing.assert_array_equal(im2.predict(x), im.predict(x))
    assert_states_equal(t.state_dict(), before)


def test_int8_gemm_weights_are_held_column_major():
    """The int8 modules hold every `[in, out]` GEMM weight column-major
    (`_int_mm`'s fast layout on the card), in one copy: through the
    quantized twin, a replica pool and a same-structure swap. Embedding
    tables stay row-major."""
    tm, _ = bert_pair()
    q = Q.quantize_model_params(tm)
    im = InferenceModel(device="cpu", num_replicas=2,
                        devices=["cpu", "cpu"]).load_keras(q)
    try:
        assert im.swap_params(Q.quantize_model_params(
            bert_pair(seed=5)[0]).state_dict()) == "same"
        for net in [q] + [r.params for r in im._replicas]:
            state = net.state_dict()
            gemm = [k for k, v in state.items()
                    if k.endswith("_q") and v.dim() == 2]
            assert "bert.blocks.0.attn.qkv_kernel_q" in gemm
            assert "cls_kernel_q" in gemm
            for k in gemm:
                assert state[k].stride(0) == 1, k
        x = bert_input()
        im.predict(x)
        # only the padded classifier (N = 3) gets a copy of its own
        cached = [k for k, v in im.current_params().state_dict(
            keep_vars=True).items() if hasattr(v, "_int8_operand")]
        assert cached == ["cls_kernel_q"]
    finally:
        im.close()
    t, _ = model_pair("conv_embedding")
    state = Q.quantize_model_params(t).state_dict()
    emb = [k for k in state if k.endswith("embeddings_q")]
    assert emb and all(state[k].is_contiguous() for k in emb)


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------
def test_port_artifact_loads_in_jax(tmp_path):
    t, j = model_pair("conv_embedding")
    path = str(tmp_path / "q")
    Q.save_quantized(t, path)
    _, jfresh = model_pair("conv_embedding", seed=9)
    got = JQ.load_quantized(jfresh, path)
    want = JQ.quantize_model_params(j, jax.device_get(j.params))
    assert_trees_equal(got, {n: want[m] for n, m in zip(
        names(jfresh), names(j))})
    f32 = sum(np.asarray(v).nbytes for sub in j.params.values()
              for v in sub.values())
    assert os.path.getsize(path + ".npz") < 0.5 * f32


def test_jax_artifact_loads_in_the_port(tmp_path):
    t, j = model_pair("nested")
    path = str(tmp_path / "q.npz")
    JQ.save_quantized(j, path)
    fresh, _ = model_pair("nested", seed=9)
    q = Q.load_quantized(fresh, path)
    assert_states_equal(q.state_dict(), _renamed(
        Q.quantize_model_params(t).state_dict(), t, fresh))
    x = model_input("nested")
    np.testing.assert_array_equal(
        InferenceModel(device="cpu").load_quantized(fresh, path).predict(x),
        InferenceModel(device="cpu").load_keras(t, quantize="int8").predict(
            x))


def _renamed(state, src, dst):
    """`src`'s state keyed by `dst`'s layer names (same architecture)."""
    tree = convert.state_to_jax(state, src)
    return convert.state_from_jax(dst._remap_loaded(tree), dst)


# ---------------------------------------------------------------------------
# checkpoint sidecars
# ---------------------------------------------------------------------------
def _trained(tmp_path, epochs=4, **fit_kw):
    """A port Dense classifier fitted with checkpoints under `tmp_path`
    (keep 3); returns the model, the data and the run directory."""
    t, j = model_pair("dense")
    rs = np.random.RandomState(1)
    x = rs.randn(64, 16).astype(np.float32)
    y = rs.randint(0, 4, 64).astype(np.int32)
    t.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
    t.set_checkpoint(str(tmp_path))
    t.fit(x, y, batch_size=16, nb_epoch=epochs, **fit_kw)
    run_dir = ckpt.list_checkpoints(str(tmp_path))[0][0]
    return t, j, x, y, run_dir


def test_fit_writes_sidecars_that_serving_prefers(tmp_path, monkeypatch):
    counter = get_registry().counter("quantized_checkpoints_total")
    before = counter.value()
    t, j, x, _, run_dir = _trained(tmp_path, int8_sidecar=True)
    assert counter.value() - before == 4          # one per saved version
    versions = sorted(v for _, v in ckpt.list_checkpoints(str(tmp_path)))
    assert versions == [8, 12, 16]                # keep=3: version 4 GC'd
    files = os.listdir(run_dir)
    assert "model.4.int8.npz" not in files
    for v in versions:
        assert ckpt.verify_pytree(Q.sidecar_path(run_dir, v))
        assert ckpt.verify_publish_marker(run_dir, v)
    # the sidecar is the JAX package's pass over the same checkpoint
    jtree = JQ.quantize_model_params(j, j._remap_loaded(
        jckpt.load_pytree(os.path.join(run_dir, "model.16"))))
    assert_states_equal(
        convert.state_from_jax(t._remap_loaded(Q.load_int8_sidecar(
            run_dir, 16)), t),
        convert.model_params_from_jax(jtree, names(j), t))
    at_load = InferenceModel(device="cpu").load_keras(
        t, quantize="int8").predict(x)
    calls = []
    real = Q.quantize_model_params
    monkeypatch.setattr(Q, "quantize_model_params",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    im = InferenceModel(device="cpu").load_checkpoint(t, str(tmp_path),
                                                      quantize="int8")
    assert im.serving_dtype == "int8" and not calls   # the sidecar served
    np.testing.assert_array_equal(im.predict(x), at_load)
    # a torn sidecar costs a calibration, not the serve
    npz = Q.sidecar_path(run_dir, 16) + ".npz"
    with open(npz, "r+b") as fh:
        fh.truncate(os.path.getsize(npz) // 2)
    assert Q.load_int8_sidecar(run_dir, 16) is None
    im = InferenceModel(device="cpu").load_checkpoint(t, str(tmp_path),
                                                      quantize="int8")
    assert calls
    np.testing.assert_array_equal(im.predict(x), at_load)


def test_load_checkpoint_matches_jax(tmp_path):
    """The JAX `load_checkpoint` and the port's on one checkpoint
    directory (written by the port), f32 and int8 at load."""
    t, j, x, _, _ = _trained(tmp_path, epochs=1)
    fresh, jfresh = model_pair("dense", seed=11)
    for quantize, tol in ((None, 1e-6), ("int8", SERVE_TOL)):
        want = np.asarray(JInferenceModel().load_checkpoint(
            jfresh, str(tmp_path), quantize=quantize).predict(x))
        got = InferenceModel(device="cpu").load_checkpoint(
            fresh, str(tmp_path), quantize=quantize).predict(x)
        assert np.abs(got - want).max() <= tol
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_failed_sidecar_leaves_the_version_unpublished(tmp_path,
                                                      monkeypatch):
    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(Q, "write_int8_sidecar", broken)
    _, _, _, _, run_dir = _trained(tmp_path, epochs=1, int8_sidecar=True)
    assert ckpt.checkpoint_intact(run_dir, 4)
    assert not ckpt.verify_publish_marker(run_dir, 4)


def test_emergency_checkpoint_gets_a_sidecar(tmp_path):
    with faults.injected("trainer.step", faults.Fault(
            mode="raise", match=lambda c: c["iteration"] == 6)):
        with pytest.raises(faults.FaultError):
            _trained(tmp_path, epochs=2, int8_sidecar=True)
    run_dir, version = ckpt.list_checkpoints(str(tmp_path))[0]
    assert version == 6
    assert ckpt.read_checkpoint_meta(run_dir, 6)["emergency"]
    assert Q.load_int8_sidecar(run_dir, 6) is not None


# ---------------------------------------------------------------------------
# the quality gate, and int8 in the roofline
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def estimator_data():
    rs = np.random.RandomState(1)
    centers = rs.randn(4, 16).astype(np.float32) * 3
    y = rs.randint(0, 4, 256)
    x = centers[y] + rs.randn(256, 16).astype(np.float32)
    t, _ = model_pair("dense")
    t.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
    t.fit(x, y.astype(np.int32), batch_size=64, nb_epoch=5)
    return t, x, y.astype(np.int32)


def test_quality_gate_passes_and_reports_the_baseline(estimator_data):
    t, x, y = estimator_data
    before = {k: v.clone() for k, v in t.state_dict().items()}
    res = Estimator(t, device="cpu").evaluate(
        (x, y), metrics=["accuracy"], quantize="int8",
        quality_tolerance=0.05)
    assert set(res) == {"accuracy", "baseline_accuracy"}
    assert abs(res["accuracy"] - res["baseline_accuracy"]) <= 0.05
    assert_states_equal(t.state_dict(), before)     # f32 untouched


@pytest.mark.parametrize("baseline", [1.5, float("nan")])
def test_quality_gate_refuses(estimator_data, baseline):
    """A drift past the tolerance, and a NaN metric (which compares False
    either way), are refused."""
    t, x, y = estimator_data
    with pytest.raises(QuantizationQualityError, match="quality gate"):
        Estimator(t, device="cpu").evaluate(
            (x, y), metrics=["accuracy"], quantize="int8",
            quality_tolerance=0.1, baseline_metrics={"accuracy": baseline})


@pytest.mark.parametrize("entry", ["evaluate", "load_keras",
                                   "load_checkpoint"])
def test_bad_quantize_mode_rejected(estimator_data, entry, tmp_path):
    t, x, y = estimator_data
    with pytest.raises(ValueError, match="int8"):
        if entry == "evaluate":
            Estimator(t, device="cpu").evaluate((x, y), quantize="int4")
        elif entry == "load_keras":
            InferenceModel(device="cpu").load_keras(t, quantize="int4")
        else:
            InferenceModel(device="cpu").load_checkpoint(
                t, str(tmp_path), quantize="int4")


def test_roofline_counts_int8_gemms_at_the_int8_peak(monkeypatch):
    a = torch.ones(32, 64, dtype=torch.int8)
    w = torch.ones(64, 16, dtype=torch.int8)
    _, cost = count_cost(Q.int8_mm, a, w)
    assert cost.int8_flops == 2 * 32 * 64 * 16 == cost.flops
    acct = RooflineAccountant(MetricsRegistry())
    acct.account("serving", cost.flops, cost.bytes, 1e-6,
                 int8_flops=cost.int8_flops)
    int8_peak = peaks.peak_flops("cpu", torch.int8)
    assert int8_peak == 1979e12
    assert acct.snapshot("serving")["mfu"] == pytest.approx(
        cost.flops / 1e-6 / int8_peak)
    # a measured bf16 bound scales the int8 rate by the same factor
    from analytics_zoo_tpu_torch.observability import roofline
    monkeypatch.setitem(roofline._session, "tflops", 500.0)
    assert acct.snapshot("serving")["mfu"] == pytest.approx(
        cost.flops / 1e-6 / (int8_peak * 500e12 / 989e12))
