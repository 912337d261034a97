"""The port's model persistence held against the JAX package on the CPU:
`learn/checkpoint.save_pytree` / `load_pytree` and their CRC check,
`utils/crc.crc32c`, `KerasNet.save_weights` / `load_weights`,
`ZooModel.save_model` / `load_model`, `summary`, and
`InferenceModel.load_zoo_model`. An artifact saved by either package
loads in the other: a `WideAndDeep` and a functional model with a
`Lambda` head and a nested convolutional trunk (BatchNorm statistics,
conv kernels HWIO in the artifact, OIHW in the port).

The JAX models are built after a few throwaway layers, so their
auto-generated layer names differ from the port models' (names count per
process and per package): every load goes through the positional remap.

Tolerances: predictions after a load across packages 1e-6 (the same
weights, two frameworks' kernels); a port → port reload bitwise; pytrees,
CRCs and summaries exact.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.keras import Input as JInput
from analytics_zoo_tpu.keras import Model as JModel
from analytics_zoo_tpu.keras import Sequential as JSequential
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.learn import checkpoint as jckpt
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.ops import autograd as JA
from analytics_zoo_tpu.utils import crc as jcrc
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input, Model, Sequential
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
from analytics_zoo_tpu_torch.models import NeuralCF, WideAndDeep
from analytics_zoo_tpu_torch.ops import autograd as TA
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel
from analytics_zoo_tpu_torch.utils.crc import crc32c

TOL = 1e-6
WND = dict(class_num=5, wide_base_dims=(6, 3), wide_cross_dims=(10,),
           indicator_dims=(4, 3), embed_in_dims=(50, 50),
           embed_out_dims=(8, 6), continuous_cols=("age",),
           hidden_layers=(16, 8))
IMG = (12, 12, 3)
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


def bump_jax_names():
    """Advance the JAX package's name counters, so its next layers' names
    differ from the port's."""
    for _ in range(5):
        JL.Dense(1)
        JL.Embedding(2, 1)
        JL.Select(1, 0)
        JL.Flatten()
        JL.Merge()
        JL.Activation("relu")
        JL.Convolution2D(1, 1, 1)
        JL.BatchNormalization()
        JL.MaxPooling2D()
        JA.Lambda(lambda t: t)
        JModel(JInput((1,)), JL.Dense(1)(JInput((1,))))


def wnd_inputs(n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.rand(n, 19) < 0.2).astype(np.float32),
            (rs.rand(n, 7) < 0.3).astype(np.float32),
            rs.randint(1, 51, (n, 2)).astype(np.int32),
            rs.standard_normal((n, 1)).astype(np.float32)]


def wnd_pair(seed):
    t = WideAndDeep(device="cpu", **WND)
    bump_jax_names()
    j = jrec.WideAndDeep(**WND)
    t.model.ensure_built(seed=seed)
    j.model.params = convert.model_params_to_jax(
        t.model.state_dict(), names(j.model), t.model)
    assert [l.name for l in t.model.ordered_layers()] != [
        l.name for l in j.model._ordered_layers()]
    return t, j


def _normalize(A):
    if A is TA:
        m, s = torch.from_numpy(MEAN), torch.from_numpy(STD)
        return TA.Lambda(lambda x: (x.float() - m) / s)
    import jax.numpy as jnp
    m, s = jnp.asarray(MEAN), jnp.asarray(STD)
    return JA.Lambda(lambda x: (jnp.asarray(x, jnp.float32) - m) / s)


def _nested(A, L_, In, Model_, dev):
    """uint8 image → normalisation Lambda → a nested conv trunk (conv, BN,
    relu, pool, two dense layers)."""
    t_in = In(shape=IMG)
    h = L_.Convolution2D(4, 3, 3, border_mode="same", **dev)(t_in)
    h = L_.Activation("relu")(L_.BatchNormalization(**dev)(h))
    h = L_.Flatten()(L_.MaxPooling2D(pool_size=(2, 2))(h))
    h = L_.Dense(6, activation="relu", **dev)(h)
    trunk = Model_(t_in, L_.Dense(3, activation="softmax", **dev)(h))
    inp = In(shape=IMG)
    return Model_(inp, trunk(_normalize(A)(inp)))


def nested_pair(seed):
    t = _nested(TA, L, Input, Model, {"device": "cpu"})
    bump_jax_names()
    j = _nested(JA, JL, JInput, JModel, {})
    t.ensure_built(seed=seed)
    # random moving statistics, so inference reads them
    with torch.no_grad():
        for name, b in t.named_buffers():
            b.copy_(torch.rand(b.shape) + (0.5 if "var" in name else -0.5))
    j.params = convert.model_params_to_jax(t.state_dict(), names(j), t)
    return t, j


def images(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n,) + IMG).astype(
        np.uint8)


# ---------------------------------------------------------------------------
# pytrees and CRCs
# ---------------------------------------------------------------------------
def _tree():
    rs = np.random.RandomState(0)
    return {"dense_1": {"kernel": rs.rand(3, 2).astype(np.float32),
                        "bias": np.zeros(2, np.float32)},
            "flatten_1": {},
            "seq": [np.arange(4, dtype=np.int32), [],
                    {"x": np.float32(2.5)}],
            "bf16": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
    else:
        want = want.float().numpy() if isinstance(want, torch.Tensor) \
            else np.asarray(want)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_pytree_round_trip_both_ways(tmp_path):
    tree = _tree()
    ckpt.save_pytree(str(tmp_path / "port"), tree)
    assert sorted(os.listdir(tmp_path)) == ["port.npz",
                                            "port.structure.json"]
    _assert_tree_equal(ckpt.load_pytree(str(tmp_path / "port")), tree)
    # the JAX package reads the port's artifact, and the reverse
    _assert_tree_equal(jckpt.load_pytree(str(tmp_path / "port")), tree)
    jtree = dict(tree, bf16=np.array([1.5, -2.0], np.float32))
    jckpt.save_pytree(str(tmp_path / "jax.npz"), jtree)
    _assert_tree_equal(ckpt.load_pytree(str(tmp_path / "jax.npz")), jtree)
    with open(tmp_path / "port.structure.json") as fh:
        meta = json.load(fh)
    with open(tmp_path / "port.npz", "rb") as fh:
        raw = fh.read()
    assert meta["npz_crc32c"] == crc32c(raw)
    assert meta["npz_bytes"] == len(raw)
    ckpt.save_pytree(str(tmp_path / "empty"), {})
    assert ckpt.load_pytree(str(tmp_path / "empty")) == {}


def test_truncated_artifact_raises(tmp_path):
    path = str(tmp_path / "w")
    ckpt.save_pytree(path, _tree())
    with open(path + ".npz", "r+b") as fh:
        fh.truncate(os.path.getsize(path + ".npz") // 2)
    with pytest.raises(ckpt.CorruptCheckpointError, match="corrupt"):
        ckpt.load_pytree(path)
    with pytest.raises(jckpt.CorruptCheckpointError):
        jckpt.load_pytree(path)
    # a write cut before its commit point (the npz truncated after its CRC
    # was taken): the sidecar still commits, and the load refuses it
    with faults.injected("checkpoint.write", faults.Fault(
            mode="truncate", keep_fraction=0.5)):
        ckpt.save_pytree(str(tmp_path / "torn"), _tree())
    with pytest.raises(ckpt.CorruptCheckpointError):
        ckpt.load_pytree(str(tmp_path / "torn"))
    # a write that fails leaves no file behind
    with faults.injected("checkpoint.write", faults.Fault(mode="raise")):
        with pytest.raises(faults.FaultError):
            ckpt.save_pytree(str(tmp_path / "failed"), _tree())
    assert not any(n.startswith("failed") for n in os.listdir(tmp_path))


@pytest.mark.parametrize("n", [0, 1, 7, 255, 4096, 65536, 200003,
                               (1 << 20) + 5])
def test_crc32c_matches_jax(n):
    data = np.random.RandomState(n).randint(0, 256, n).astype(
        np.uint8).tobytes()
    assert crc32c(data) == jcrc.crc32c(data)
    assert crc32c(data, 12345) == jcrc.crc32c(data, 12345)
    if n == 0:
        assert crc32c(b"123456789") == 0xE3069283   # the CRC-32C check value


# ---------------------------------------------------------------------------
# artifacts across the packages
# ---------------------------------------------------------------------------
def test_jax_saved_wide_and_deep_loads_in_the_port(tmp_path):
    t, j = wnd_pair(seed=1)
    j.save_model(str(tmp_path / "wnd"))
    assert sorted(os.listdir(tmp_path / "wnd")) == [
        "config.json", "weights.layers.json", "weights.npz",
        "weights.structure.json"]
    fresh = WideAndDeep.load_model(str(tmp_path / "wnd"), device="cpu")
    x = wnd_inputs(9, 2)
    np.testing.assert_allclose(fresh.predict(x, batch_per_thread=4),
                               j.predict(x, batch_per_thread=4), rtol=0,
                               atol=TOL)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, dict(zip(fresh.model.state_dict(),
                                       t.model.state_dict().values()))[k])


def test_port_saved_wide_and_deep_loads_in_jax(tmp_path):
    t, _ = wnd_pair(seed=3)
    t.save_model(str(tmp_path / "wnd"))
    with open(tmp_path / "wnd" / "config.json") as fh:
        assert json.load(fh) == {"class": "WideAndDeep",
                                 "config": t._config}
    bump_jax_names()
    j = jrec.WideAndDeep.load_model(str(tmp_path / "wnd"))
    x = wnd_inputs(9, 4)
    np.testing.assert_allclose(j.predict(x, batch_per_thread=4),
                               t.predict(x, batch_per_thread=4), rtol=0,
                               atol=TOL)


def test_jax_saved_nested_model_loads_in_the_port(tmp_path):
    t, j = nested_pair(seed=5)
    path = str(tmp_path / "nested")
    j.save_weights(path)
    fresh = _nested(TA, L, Input, Model, {"device": "cpu"})
    fresh.load_weights(path)
    x = images(7, 6)
    np.testing.assert_allclose(fresh.predict(x, batch_per_thread=4),
                               j.predict(x, batch_per_thread=4), rtol=0,
                               atol=TOL)
    for a, b in zip(fresh.state_dict().values(), t.state_dict().values()):
        assert torch.equal(a, b)


def test_port_saved_nested_model_loads_in_jax(tmp_path):
    t, _ = nested_pair(seed=7)
    path = str(tmp_path / "nested")
    t.save_weights(path)
    with open(path + ".layers.json") as fh:
        assert json.load(fh) == [l.name for l in t.ordered_layers()]
    bump_jax_names()
    j = _nested(JA, JL, JInput, JModel, {})
    j.load_weights(path)
    x = images(7, 8)
    np.testing.assert_allclose(j.predict(x, batch_per_thread=4),
                               t.predict(x, batch_per_thread=4), rtol=0,
                               atol=TOL)
    # the tree the JAX package reads is the one the port's convert gives
    want = convert.model_params_to_jax(t.state_dict(), names(j), t)
    got = jax.device_get(j.params)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_port_reload_is_bitwise(tmp_path):
    t, _ = wnd_pair(seed=9)
    t.save_model(str(tmp_path / "wnd"))
    with pytest.raises(FileExistsError):
        t.save_model(str(tmp_path / "wnd"))
    t.save_model(str(tmp_path / "wnd"), over_write=True)
    fresh = WideAndDeep.load_model(str(tmp_path / "wnd"), device="cpu")
    x = wnd_inputs(9, 10)
    np.testing.assert_array_equal(fresh.predict(x, batch_per_thread=4),
                                  t.predict(x, batch_per_thread=4))
    tn, _ = nested_pair(seed=11)
    tn.save_weights(str(tmp_path / "nested.npz"))
    again = _nested(TA, L, Input, Model, {"device": "cpu"})
    again.load_weights(str(tmp_path / "nested.npz"))
    for a, b in zip(again.state_dict().values(), tn.state_dict().values()):
        assert torch.equal(a, b)
    tree = again.load_weights_tree(str(tmp_path / "nested.npz"))
    assert list(tree) == [l.name for l in again.ordered_layers()]


def test_load_errors(tmp_path):
    t, _ = wnd_pair(seed=12)
    t.save_model(str(tmp_path / "wnd"))
    with pytest.raises(ValueError, match="not NeuralCF"):
        NeuralCF.load_model(str(tmp_path / "wnd"), device="cpu")
    with pytest.raises(ValueError, match="not NeuralCF"):
        from analytics_zoo_tpu.models.recommendation import \
            NeuralCF as JNeuralCF
        JNeuralCF.load_model(str(tmp_path / "wnd"))
    other = WideAndDeep(device="cpu", **dict(WND, hidden_layers=(16,)))
    with pytest.raises(ValueError, match="layers"):
        other.model.load_weights(str(tmp_path / "wnd" / "weights"))
    unbuilt = WideAndDeep(device="cpu", **WND)
    with pytest.raises(ValueError, match="no parameters"):
        unbuilt.model.save_weights(str(tmp_path / "nothing"))
    with pytest.raises(NotImplementedError, match="queue 1"):
        t.save_model_encrypted(str(tmp_path / "e"), "s", "salt")
    t.set_checkpoint(str(tmp_path))
    assert t.model._checkpoint_path == str(tmp_path)
    t.set_tensorboard(str(tmp_path) + "/", "app")
    assert t.model._tensorboard_dir == f"{tmp_path}/app"


def test_inference_model_load_zoo_model(tmp_path):
    t, _ = wnd_pair(seed=13)
    t.save_model(str(tmp_path / "wnd"))
    im = InferenceModel(max_batch=8, device="cpu").load_zoo_model(
        WideAndDeep, str(tmp_path / "wnd"))
    x = wnd_inputs(11, 14)
    np.testing.assert_array_equal(im.predict(x),
                                  t.predict(x, batch_per_thread=8))
    nested, _ = nested_pair(seed=15)
    served = InferenceModel(max_batch=4, device="cpu").load_keras(nested)
    served.warmup(np.zeros(IMG, np.uint8))
    x = images(3, 16)
    np.testing.assert_allclose(served.predict(x), nested.predict(
        x, batch_per_thread=4), rtol=0, atol=TOL)


def test_inference_model_pads_in_the_input_dtype():
    """A uint8 batch is uploaded and padded to its bucket as uint8 (an int
    input of a multi-input model keeps its dtype too), as the JAX package
    keeps the input's dtype."""
    seen = []

    def fn(_, x):
        seen.append([t.dtype for t in x] if isinstance(x, list)
                    else [x.dtype])
        first = x[0] if isinstance(x, list) else x
        return first.reshape(first.shape[0], -1)[:, :1].float()
    im = InferenceModel(max_batch=4, device="cpu").load_fn(
        fn, torch.nn.Linear(1, 1))
    out = im.predict(images(3, 19))
    assert out.shape == (3, 1) and seen[-1] == [torch.uint8]
    im.predict([images(3, 20), np.ones((3, 2), np.int32)])
    assert seen[-1] == [torch.uint8, torch.int32]


# ---------------------------------------------------------------------------
# summary
# ---------------------------------------------------------------------------
def _named(L_, In, Model_, A, dev):
    """A model whose layers and models are all named."""
    t_in = In(shape=(6,))
    h = L_.Dense(5, name="hidden", **dev)(t_in)
    h = L_.BatchNormalization(name="norm", **dev)(h)
    trunk = Model_(t_in, L_.Dense(3, name="head", **dev)(h), name="trunk")
    inp = In(shape=(6,))
    h = A.Lambda(lambda x: x * 2.0, name="twice")(inp)
    emb_in = In(shape=(2,))
    e = L_.Flatten(name="flat")(L_.Embedding(10, 2, name="table", **dev)(
        L_.Select(1, 0, name="pick")(emb_in)))
    out = L_.merge([trunk(h), L_.Dense(3, name="side", **dev)(e)],
                   mode="sum", name="join")
    return Model_([inp, emb_in], out, name="named_model")


def test_summary_matches_jax(capsys):
    t = _named(L, Input, Model, TA, {"device": "cpu"})
    j = _named(JL, JInput, JModel, JA, {})
    empty = t.summary()
    assert "Total params: 0" in empty
    t.ensure_built(seed=17)
    j.params = convert.model_params_to_jax(t.state_dict(), names(j), t)
    capsys.readouterr()
    text = t.summary()
    assert capsys.readouterr().out.strip() == text
    assert text == j.summary()
    rows = t._summary_rows()
    assert rows == [(name, shape, int(count))
                    for name, shape, count in j._summary_rows()]
    counts = dict((r[0].split(" ")[0], r[2]) for r in rows)
    assert counts["trunk"] == 6 * 5 + 5 + 4 * 5 + 5 * 3 + 3
    assert counts["table"] == 20 and counts["twice"] == 0
    seq = Sequential([L.Dense(4, input_shape=(3,), name="s1",
                              device="cpu")], name="seq")
    jseq = JSequential([JL.Dense(4, input_shape=(3,), name="s1")],
                       name="seq")
    seq.ensure_built()
    jseq.params = convert.model_params_to_jax(seq.state_dict(),
                                              names(jseq), seq)
    assert seq.summary() == jseq.summary()
    w, _ = wnd_pair(seed=18)
    total = sum(v.numel() for v in w.model.state_dict().values())
    assert w.summary().endswith(f"Total params: {total}")
