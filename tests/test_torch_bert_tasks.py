"""The port's BERT task slice held against the JAX package on the CPU:
`BERTNER` and `BERTSQuAD`, `compile(loss=[...])` (one loss per output,
summed) and its two ValueErrors, a tuple `predict`, `BERT(remat=True)`,
and `load_tf_checkpoint` through the port's own TF bundle reader
(`utils/tf_checkpoint.py`).

Sizes: 2 blocks, hidden 32, 2 heads, seq 16, intermediate 64, vocab 64.
Both packages start from the JAX `build`'s weights (carried by `convert`)
and see the same batches (the JAX fit with `distributed=False,
device_cache=False`). The JAX side takes its jnp paths. Dropout is 0 for
every comparison across packages (dropout bits cannot match across
frameworks); remat is held against the port's own plain run with dropout
on, bit for bit. Tolerances: logits 1e-5 (f32, ~1e-7 seen); 3-step loss
curves 1e-4, as the BERT classifier's (`test_torch_training.py`).

The checkpoint tests write a TF1-named bundle with TensorFlow
(`tf.raw_ops.SaveV2`, the writer Google's checkpoints come from), so they
skip where TensorFlow is missing; the port reads it without TensorFlow.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models import bert as jbert
from analytics_zoo_tpu.ops import objectives as jobj
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.kernels import LAUNCHES
from analytics_zoo_tpu_torch.kernels import dropout as dr
from analytics_zoo_tpu_torch.kernels import flash_attention as fa
from analytics_zoo_tpu_torch.kernels import fused_adam as fad
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.models import bert as tbert
from analytics_zoo_tpu_torch.ops import objectives, optimizers
from analytics_zoo_tpu_torch.utils import tf_checkpoint

TINY = dict(vocab=64, hidden_size=32, n_block=2, n_head=2, seq_len=16,
            intermediate_size=64)
NO_DROP = dict(hidden_drop=0.0, attn_drop=0.0)
LOGIT_TOL = 1e-5
LOSS_TOL = 1e-4
LR, BATCH, TAGS = 1e-3, 4, 9
TASKS = {"ner": (jbert.BERTNER, tbert.BERTNER, (TAGS,)),
         "squad": (jbert.BERTSQuAD, tbert.BERTSQuAD, ())}


@pytest.fixture(scope="module", autouse=True)
def ctx():
    c = zoo.init_orca_context(cluster_mode="local")
    yield c
    zoo.stop_orca_context()


def _inputs(n, seed=0):
    rs = np.random.RandomState(seed)
    T = TINY["seq_len"]
    lens = rs.randint(6, T + 1, n)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    segs = (np.arange(T)[None, :] >= 5).astype(np.int32) * \
        np.ones((n, 1), np.int32)
    return [rs.randint(0, TINY["vocab"], (n, T)).astype(np.int32), segs, mask]


def _labels(task, n, seed=1):
    rs = np.random.RandomState(seed)
    T = TINY["seq_len"]
    if task == "ner":
        return rs.randint(0, TAGS, (n, T)).astype(np.int32)
    start = rs.randint(5, 10, n).astype(np.int32)
    return [start, (start + rs.randint(0, 5, n)).astype(np.int32)]


def _pair(task, seed=3, **kw):
    """(JAX model with built params, port model with the same weights);
    `kw` (dropout rates, `remat`) goes to both."""
    J, P, args = TASKS[task]
    jm = J(*args, use_flash=True, **TINY, **kw)
    jm.params = jax.device_get(jm.build(jax.random.PRNGKey(seed)))
    tm = P(*args, use_flash=True, device="cpu", **TINY, **kw)
    tm.load_state_dict(convert.params_from_jax(jm.params))
    return jm, tm


def _losses(task):
    """The compile losses of each package: one per output for SQuAD."""
    j = jobj.get("sparse_categorical_crossentropy", from_logits=True)
    t = objectives.get("sparse_categorical_crossentropy", from_logits=True)
    return ([j, j], [t, t]) if task == "squad" else (j, t)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_logits_match_jax(task):
    jm, tm = _pair(task, **NO_DROP)
    x = _inputs(5)
    want = jax.tree_util.tree_leaves(jm.apply(jm.params, x))
    with torch.inference_mode():
        got = tm([torch.from_numpy(a) for a in x])
    got = list(got) if isinstance(got, tuple) else [got]
    assert len(got) == len(want) == (2 if task == "squad" else 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_fit_loss_curve_matches_jax(task):
    """3 steps (3 epochs of one batch) through Estimator.fit on both
    packages; SQuAD compiles a list of two losses."""
    jloss, tloss = _losses(task)
    jm, tm = _pair(task, **NO_DROP)
    data = {"x": _inputs(BATCH), "y": _labels(task, BATCH)}
    jh = JEstimator.from_keras(jm, optimizer=optax.adamw(LR),
                               loss=jloss).fit(
        data, epochs=3, batch_size=BATCH, distributed=False,
        device_cache=False)
    th = Estimator.from_keras(tm, optimizer=optimizers.adamw(LR), loss=tloss,
                              device="cpu").fit(data, epochs=3,
                                                batch_size=BATCH)
    assert len(th["loss"]) == 3
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=LOSS_TOL)


def test_multi_output_loss_errors_match_jax():
    """The two ValueErrors of a list-of-losses compile, in both packages:
    fewer outputs than losses, and one label array for two outputs."""
    _, tm = _pair("squad")
    jm, _ = _pair("ner")
    jloss, tloss = _losses("squad")
    tm.compile("adam", tloss)
    jm.compile("adam", jloss)
    y = np.zeros((2,), np.int32)
    pred = np.zeros((2, 16), np.float32)
    for loss, conv in ((tm.loss, torch.from_numpy), (jm.loss, np.asarray)):
        with pytest.raises(ValueError, match="got 2 losses but the model "
                                             "produces 1 output"):
            loss([conv(y), conv(y)], conv(pred))
        with pytest.raises(ValueError, match="needs a list of 2 label"):
            loss(conv(y), (conv(pred), conv(pred)))
    x = _inputs(BATCH)
    with pytest.raises(ValueError, match="needs a list of 2 label"):
        Estimator(tm, device="cpu").fit({"x": x, "y": _labels("ner", BATCH)
                                         [:, 0]}, batch_size=BATCH)


def test_tuple_predict_concatenates_per_output():
    """A two-output predict in batches (the last one padded) gives one
    array per output, as the JAX predict does."""
    jm, tm = _pair("squad", **NO_DROP)
    x = _inputs(7)
    want = jm.predict(x, batch_per_thread=3)
    got = tm.predict(x, batch_per_thread=3)
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == (7, TINY["seq_len"])
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=LOGIT_TOL)
    ev = Estimator.from_keras(tm, optimizer="adam", loss=_losses("squad")[1],
                              device="cpu").evaluate(
        {"x": x, "y": _labels("squad", 7)}, batch_per_thread=3)
    assert np.isfinite(list(ev.values())).all()


def _fit_state(tm, task, mixed_precision, seed=0):
    h = Estimator.from_keras(tm, optimizer=optimizers.fused_adam(LR),
                             loss=_losses(task)[1], device="cpu").fit(
        {"x": _inputs(2 * BATCH), "y": _labels(task, 2 * BATCH)}, epochs=2,
        batch_size=BATCH, mixed_precision=mixed_precision,
        fused_optimizer=True, seed=seed)
    return h["loss"], {k: v.detach().clone()
                       for k, v in tm.state_dict().items()}


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_remat_is_bitwise_the_plain_step(mixed_precision):
    """Dropout 0.1 everywhere: the recompute draws the same masks from
    the same integer seeds, and reads the block's bf16 casts under mixed
    precision, so losses and parameters are bitwise those of the plain
    fit."""
    runs = []
    for remat in (False, True):
        _, tm = _pair("squad", remat=remat)
        runs.append(_fit_state(tm, "squad", mixed_precision))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1 and np.isfinite(l0).all()
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_remat_matches_jax_remat():
    jm, tm = _pair("squad", remat=True, **NO_DROP)
    jloss, tloss = _losses("squad")
    data = {"x": _inputs(BATCH), "y": _labels("squad", BATCH)}
    jh = JEstimator.from_keras(jm, optimizer=optax.adamw(LR),
                               loss=jloss).fit(
        data, epochs=3, batch_size=BATCH, distributed=False,
        device_cache=False)
    th = Estimator.from_keras(tm, optimizer=optimizers.adamw(LR), loss=tloss,
                              device="cpu").fit(data, epochs=3,
                                                batch_size=BATCH)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=LOSS_TOL)


def _count(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("remat", [False, True])
def test_launch_count_under_remat(monkeypatch, remat):
    """One step: the flash forward runs once a block, twice under remat
    (the recompute), the backward once; the dropout passes of the
    blocks' forwards run again too (2 a block), the embedding's does
    not."""
    fwd = _count(monkeypatch, fa, "flash_attention_fwd")
    bwd = _count(monkeypatch, fa, "flash_attention_bwd")
    drops = _count(monkeypatch, dr, "dropout_apply")
    _, tm = _pair("squad", remat=remat)
    n = TINY["n_block"]
    Estimator.from_keras(tm, optimizer=optimizers.fused_adam(LR),
                         loss=_losses("squad")[1], device="cpu").fit(
        {"x": _inputs(BATCH), "y": _labels("squad", BATCH)},
        batch_size=BATCH, fused_optimizer=True)
    assert len(fwd) == (2 if remat else 1) * n and len(bwd) == n
    assert len(drops) == 2 * (2 * n + 1) + (2 * n if remat else 0)


@pytest.mark.gpu
def test_remat_launches_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    jm, _ = _pair("squad")
    n = TINY["n_block"]
    for remat in (False, True):
        tm = tbert.BERTSQuAD(use_flash=True, remat=remat, **TINY)
        tm.load_state_dict(convert.params_from_jax(jm.params))
        LAUNCHES.reset()
        h = Estimator.from_keras(tm, optimizer=optimizers.fused_adam(LR),
                                 loss=_losses("squad")[1]).fit(
            {"x": _inputs(BATCH), "y": _labels("squad", BATCH)},
            batch_size=BATCH, mixed_precision=True, fused_optimizer=True)
        assert np.isfinite(h["loss"]).all()
        k = 2 if remat else 1
        assert LAUNCHES.snapshot() == {
            fa.KERNEL_NAME: k * n, fa.BWD_DKV_NAME: n, fa.BWD_DQ_NAME: n,
            dr.KERNEL_NAME: 2 * (2 * n + 1) + (k - 1) * 2 * n,
            fad.KERNEL_NAME: fad.sweep_launches(tm.parameters())}


# ---------------------------------------------------------------------------
# TF1 checkpoints
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _tf1_variables(tree, n_block):
    """The TF1 names and arrays of a JAX BERT tree (Google's layout: q, k
    and v apart), plus the entries a real checkpoint carries and the model
    never reads."""
    v = {"bert/embeddings/word_embeddings": tree["word_embeddings"],
         "bert/embeddings/position_embeddings": tree["position_embeddings"],
         "bert/embeddings/token_type_embeddings":
             tree["token_type_embeddings"],
         "bert/embeddings/LayerNorm/gamma": tree["emb_ln"]["gamma"],
         "bert/embeddings/LayerNorm/beta": tree["emb_ln"]["beta"],
         "bert/pooler/dense/kernel": tree["pooler_kernel"],
         "bert/pooler/dense/bias": tree["pooler_bias"]}
    for i in range(n_block):
        b = tree[f"bert_block{i}"]
        base = f"bert/encoder/layer_{i}"
        q, k, vv = np.split(np.asarray(b["attn"]["qkv_kernel"]), 3, axis=1)
        qb, kb, vb = np.split(np.asarray(b["attn"]["qkv_bias"]), 3)
        for name, kern, bias in (("query", q, qb), ("key", k, kb),
                                 ("value", vv, vb)):
            v[f"{base}/attention/self/{name}/kernel"] = kern
            v[f"{base}/attention/self/{name}/bias"] = bias
        v[f"{base}/attention/output/dense/kernel"] = b["attn"]["out_kernel"]
        v[f"{base}/attention/output/dense/bias"] = b["attn"]["out_bias"]
        v[f"{base}/attention/output/LayerNorm/gamma"] = b["ln1"]["gamma"]
        v[f"{base}/attention/output/LayerNorm/beta"] = b["ln1"]["beta"]
        v[f"{base}/intermediate/dense/kernel"] = b["ffn_in_kernel"]
        v[f"{base}/intermediate/dense/bias"] = b["ffn_in_bias"]
        v[f"{base}/output/dense/kernel"] = b["ffn_out_kernel"]
        v[f"{base}/output/dense/bias"] = b["ffn_out_bias"]
        v[f"{base}/output/LayerNorm/gamma"] = b["ln2"]["gamma"]
        v[f"{base}/output/LayerNorm/beta"] = b["ln2"]["beta"]
    out = {k: np.ascontiguousarray(np.asarray(a, np.float32))
           for k, a in v.items()}
    out["global_step"] = np.asarray(1000, np.int64)
    for name in ("bert/pooler/dense/kernel", "bert/pooler/dense/bias"):
        out[name + "/adam_m"] = np.zeros_like(out[name])
        out[name + "/adam_v"] = np.ones_like(out[name])
    return out


def _save(tf, prefix, variables):
    names = sorted(variables)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[variables[n] for n in names])
    return prefix


@pytest.fixture(scope="module")
def google_ckpt(tf, tmp_path_factory):
    """A TF1-named checkpoint of a BERT built from another seed than the
    models under test."""
    src, _ = _pair("ner", seed=11)
    prefix = str(tmp_path_factory.mktemp("bert_ckpt") / "bert_model.ckpt")
    return _save(tf, prefix, _tf1_variables(src.params["bert"],
                                            TINY["n_block"]))


@pytest.mark.parametrize("task", sorted(TASKS))
def test_load_tf_checkpoint_equals_jax_bitwise(google_ckpt, task):
    """The JAX `load_tf_checkpoint` (through TensorFlow's reader) and the
    port's (through its own) give bitwise the same encoder weights, and the
    loaded models the same logits; the head keeps its own weights."""
    jm, tm = _pair(task, **NO_DROP)
    head = {k: v.clone() for k, v in tm.state_dict().items()
            if not k.startswith("bert.")}
    jm.load_tf_checkpoint(google_ckpt)
    tm.load_tf_checkpoint(google_ckpt)
    want = convert.params_from_jax(jax.device_get(jm.params))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert all(torch.equal(got[k], v) for k, v in head.items())
    x = _inputs(3)
    jl = jax.tree_util.tree_leaves(jm.apply(jm.params, x))
    with torch.inference_mode():
        tl = tm([torch.from_numpy(a) for a in x])
    tl = tl if isinstance(tl, tuple) else (tl,)
    for g, w in zip(tl, jl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LOGIT_TOL)


def test_reader_matches_tensorflow(tf, google_ckpt, tmp_path):
    """Every entry, names and shapes, against `tf.train.load_checkpoint`;
    the dtypes the port takes (f32, int32, int64, bf16, f16, f64, int8,
    uint8, bool) read exactly, bf16 as float32; a directory with a
    `checkpoint` state file resolves to its prefix."""
    theirs = tf.train.load_checkpoint(google_ckpt)
    ours = tf_checkpoint.load_checkpoint(google_ckpt)
    assert ours.get_variable_to_shape_map() == \
        theirs.get_variable_to_shape_map()
    for name in theirs.get_variable_to_shape_map():
        assert np.array_equal(ours.get_tensor(name), theirs.get_tensor(name))
    rs = np.random.RandomState(0)
    kinds = {"f32": rs.randn(3, 5).astype(np.float32),
             "i32": rs.randint(-9, 9, (7,)).astype(np.int32),
             "i64": np.asarray(2 ** 40, np.int64),
             "f64": rs.randn(2, 2),
             "f16": rs.randn(4).astype(np.float16),
             "i8": rs.randint(-9, 9, (4,)).astype(np.int8),
             "u8": rs.randint(0, 255, (4,)).astype(np.uint8),
             "b": rs.rand(5) > 0.5}
    names = sorted(kinds) + ["bf16"]
    bf16 = tf.cast(rs.randn(6).astype(np.float32), tf.bfloat16)
    prefix = str(tmp_path / "model.ckpt-7")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[kinds[n] for n in sorted(kinds)] + [bf16])
    (tmp_path / "checkpoint").write_text(
        'model_checkpoint_path: "model.ckpt-7"\n')
    r = tf_checkpoint.load_checkpoint(str(tmp_path))
    for n, a in kinds.items():
        got = r.get_tensor(n)
        assert got.dtype == a.dtype and np.array_equal(got, a), n
    got = r.get_tensor("bf16")
    assert got.dtype == np.float32
    assert np.array_equal(got, tf.cast(bf16, tf.float32).numpy())


def test_reader_and_import_errors(tf, google_ckpt, tmp_path):
    """KeyError for a missing variable (reader and import, as the JAX
    import raises), ValueError for shapes that do not fit the model (both
    packages), DataLossError on a flipped byte, TypeError on a string
    tensor, ValueError on a file that is not a bundle."""
    r = tf_checkpoint.load_checkpoint(google_ckpt)
    with pytest.raises(KeyError):
        r.get_tensor("bert/nope")
    part = _tf1_variables(_pair("ner", seed=5)[0].params["bert"],
                          TINY["n_block"])
    del part["bert/encoder/layer_1/output/dense/bias"]
    short = _save(tf, str(tmp_path / "short" / "ckpt"), part)
    jm, tm = _pair("ner")
    for load in (jm.load_tf_checkpoint, tm.load_tf_checkpoint):
        with pytest.raises(KeyError, match="layer_1/output/dense/bias"):
            load(short)
    wide_j, _ = _pair("ner")
    wide = dict(TINY, intermediate_size=96)
    wj = jbert.BERTNER(TAGS, **wide)
    wj.params = jax.device_get(wj.build(jax.random.PRNGKey(2)))
    other = _save(tf, str(tmp_path / "wide" / "ckpt"),
                  _tf1_variables(wj.params["bert"], TINY["n_block"]))
    for load in (wide_j.load_tf_checkpoint, tm.load_tf_checkpoint):
        with pytest.raises(ValueError, match="shapes do not match"):
            load(other)
    # a flipped byte in the tensor data, then in the index
    flip = _save(tf, str(tmp_path / "flip" / "ckpt"),
                 {"w": np.arange(8, dtype=np.float32)})
    data = flip + ".data-00000-of-00001"
    raw = bytearray(open(data, "rb").read())
    raw[5] ^= 0xFF
    open(data, "wb").write(bytes(raw))
    with pytest.raises(tf_checkpoint.DataLossError, match="checksum"):
        tf_checkpoint.load_checkpoint(flip).get_tensor("w")
    index = bytearray(open(flip + ".index", "rb").read())
    index[3] ^= 0xFF
    open(flip + ".index", "wb").write(bytes(index))
    with pytest.raises(tf_checkpoint.DataLossError, match="CRC"):
        tf_checkpoint.load_checkpoint(flip)
    strings = _save(tf, str(tmp_path / "str" / "ckpt"),
                    {"s": np.asarray([b"a", b"bc"])})
    with pytest.raises(TypeError, match="DT_STRING"):
        tf_checkpoint.load_checkpoint(strings).get_tensor("s")
    bogus = tmp_path / "bogus.index"
    bogus.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="not a TF bundle"):
        tf_checkpoint.load_checkpoint(str(tmp_path / "bogus"))
    with pytest.raises(FileNotFoundError):
        tf_checkpoint.load_checkpoint(str(tmp_path / "absent"))
