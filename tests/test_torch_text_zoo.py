"""The port's text zoo held against the JAX package on the CPU: the CRF ops
(`ops/crf.py`), `NER` with its CRF head, `SequenceTagger` / `POSTagger`,
`IntentEntity`, `KNRM` on the port's copy of `Ranker`, `Seq2seq` with
`infer`, `TransformerLayer`, and the trainer's cached entry (a fitted model
that is deleted is freed without a garbage collection).

Both packages take the same weights: the port's, drawn from a seed,
carried to the JAX tree by `convert`. Inputs come from numpy with a seed;
sizes are small. Tolerances (absolute):
- forwards, CRF log-likelihoods, losses and Viterbi scores in float32:
  1e-5; Viterbi paths equal; CRF gradients 1e-5;
- 3-step fits (Adam at lr 1e-2, one batch an epoch, dropout at rate 0,
  since dropout bits differ between the frameworks; the JAX fit with host
  batches, `distributed=False, device_cache=False`): per-step losses and
  the parameters after the fit, 1e-4.
The JAX package's own `TestCRFOps` cases run against the port's
functions (their module's `crf` rebound), and its `TestRanker` cases
against the port's `Ranker`.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu as zoo
import test_textmodels as jax_cases
from analytics_zoo_tpu.keras import transformer as jtr
from analytics_zoo_tpu.models import common as jcommon
from analytics_zoo_tpu.models import seq2seq as js2s
from analytics_zoo_tpu.models import textmatching as jtm
from analytics_zoo_tpu.models import textmodels as jtxt
from analytics_zoo_tpu.ops import crf as jcrf
from analytics_zoo_tpu.ops import objectives as jobj
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import transformer as ttr
from analytics_zoo_tpu_torch.models import common as tcommon
from analytics_zoo_tpu_torch.models import seq2seq as ts2s
from analytics_zoo_tpu_torch.models import textmatching as ttm
from analytics_zoo_tpu_torch.models import textmodels as ttxt
from analytics_zoo_tpu_torch.ops import crf as tcrf
from analytics_zoo_tpu_torch.ops import objectives as tobj
from analytics_zoo_tpu_torch.ops import optimizers

TOL = 1e-5
FIT_TOL = 1e-4
FIT_LR = 1e-2
FIT_STEPS = 3
N, S, W, WV, CV = 8, 6, 5, 50, 20


@pytest.fixture(scope="module", autouse=True)
def ctx():
    c = zoo.init_orca_context(cluster_mode="local")
    yield c
    zoo.stop_orca_context()


def names(jmodel):
    return [(l.name, names(l)) if hasattr(l, "_ordered_layers") else l.name
            for l in jmodel._ordered_layers()]


def share(t, j, sample, seed=0):
    """Build the port model from `seed`; give the JAX model the same
    weights."""
    t.model.ensure_built(sample, seed=seed)
    j.model.params = convert.model_params_to_jax(
        t.model.state_dict(), names(j.model), t.model)
    return j.model.params


def rand(shape, seed, scale=1.0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32) * scale


def text_data(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, WV, (N, S)).astype(np.int32),
            rs.randint(0, CV, (N, S, W)).astype(np.int32)]


def no_dropout(*models):
    for m in models:
        for layer in m.model._ordered_layers() if hasattr(
                m.model, "_ordered_layers") else m.model.ordered_layers():
            if type(layer).__name__ == "Dropout":
                layer.rate = 0.0


def fit_both(t, j, x, y, tloss, jloss):
    """The same 3-step fit on both packages; returns both histories."""
    j.model.compile(optax.adam(FIT_LR), jloss)
    jh = j.model.fit(x, y, batch_size=len(y), nb_epoch=FIT_STEPS,
                     distributed=False, device_cache=False)
    t.model.compile(optimizers.adam(FIT_LR), tloss)
    th = t.model.fit(x, y, batch_size=len(y), nb_epoch=FIT_STEPS,
                     device_cache=False)
    return th, jh


def same_fit(t, j, th, jh, to_port):
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=FIT_TOL)
    want = to_port(jax.device_get(j.model.params))
    for key, value in t.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=0,
                                   atol=FIT_TOL, err_msg=key)


def graph_params(t, j):
    return lambda tree: convert.model_params_from_jax(tree, names(j.model),
                                                      t.model)


# ---------------------------------------------------------------------------
# the CRF ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    "TestCRFOps.test_log_likelihood_matches_enumeration",
    "TestCRFOps.test_viterbi_matches_enumeration",
    "TestCRFOps.test_masked_likelihood_ignores_padding"])
def test_jax_crf_cases_run_on_the_port(case, monkeypatch):
    monkeypatch.setattr(jax_cases, "crf", tcrf)
    cls, meth = case.split(".")
    getattr(getattr(jax_cases, cls)(), meth)()


def test_crf_loss_trains_transitions():
    """The JAX case's gradient, by autograd: nonzero for the transitions,
    and equal to `jax.grad`'s for both arguments."""
    rs = np.random.RandomState(3)
    em = rs.randn(4, 6, 3).astype(np.float32)
    tags = rs.randint(0, 3, (4, 6))
    tr0 = np.zeros((3, 3), np.float32)
    tem = torch.tensor(em, requires_grad=True)
    ttr0 = torch.tensor(tr0, requires_grad=True)
    tcrf.crf_loss(tem, tags, ttr0).backward()
    assert torch.any(ttr0.grad != 0)
    gem, gtr = jax.jit(jax.grad(lambda e, t: jcrf.crf_loss(e, tags, t),
                                argnums=(0, 1)))(em, tr0)
    np.testing.assert_allclose(tem.grad.numpy(), np.asarray(gem), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(ttr0.grad.numpy(), np.asarray(gtr), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_crf_matches_jax(masked):
    rs = np.random.RandomState(4)
    em = rs.randn(5, 7, 4).astype(np.float32)
    tr = rs.randn(4, 4).astype(np.float32)
    tags = rs.randint(0, 4, (5, 7))
    mask = None
    if masked:
        mask = np.ones((5, 7), np.float32)
        mask[0, 4:] = 0
        mask[3, 2:] = 0
    ll = tcrf.crf_log_likelihood(em, tags, tr, mask)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jax.jit(
        jcrf.crf_log_likelihood)(em, tags, tr, mask)), rtol=0, atol=TOL)
    assert float(tcrf.crf_loss(em, tags, tr, mask)) == \
        pytest.approx(-float(ll.mean()), abs=1e-7)
    tpath, tscore = tcrf.viterbi_decode(em, tr, mask)
    jpath, jscore = jax.jit(jcrf.viterbi_decode)(em, tr, mask)
    np.testing.assert_array_equal(tpath.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore), rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# Ranker: the JAX TestRanker cases on both classes, and the two agree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ranker", [tcommon.Ranker, jcommon.Ranker],
                         ids=["port", "jax"])
def test_ranker_hand_examples(ranker):
    assert ranker.ndcg_score([2, 1, 0], [0.9, 0.5, 0.1], k=3) == \
        pytest.approx(1.0)
    assert ranker.ndcg_score([1, 0], [0.1, 0.9], k=1) == 0.0
    assert ranker.ndcg_score([0, 0], [0.5, 0.4], k=2) == 0.0
    with pytest.raises(ValueError):
        ranker.ndcg_score([1], [1.0], k=0)
    assert ranker.ndcg_score([1, 0], [0.1, 0.9], k=2) == \
        pytest.approx(np.log(2) / np.log(3))
    assert ranker.map_score([1, 0, 1], [0.9, 0.5, 0.2]) == \
        pytest.approx((1.0 + 2.0 / 3.0) / 2)
    assert ranker.map_score([0, 0], [0.9, 0.1]) == 0.0
    rs = np.random.RandomState(5)
    for _ in range(5):
        y, p = rs.randint(0, 3, 9), rs.randn(9)
        for k in (1, 3, 9):
            assert ranker.ndcg_score(y, p, k) == \
                jcommon.Ranker.ndcg_score(y, p, k)
        assert ranker.map_score(y, p) == jcommon.Ranker.map_score(y, p)


# ---------------------------------------------------------------------------
# NER, SequenceTagger, IntentEntity
# ---------------------------------------------------------------------------
NER_ARGS = dict(num_entities=4, word_vocab_size=WV, char_vocab_size=CV,
                word_length=W, word_emb_dim=8, char_emb_dim=4,
                tagger_lstm_dim=6)


def ner_pair(**kw):
    args = dict(NER_ARGS, **kw)
    return ttxt.NER(device="cpu", **args), jtxt.NER(**args)


def test_ner_forward_crf_and_decode_match_jax():
    t, j = ner_pair()
    x = text_data(1)
    share(t, j, x, seed=1)
    assert t._config == j._config
    got = t.predict(x, batch_per_thread=N)
    assert got.shape == (N, S, 4)
    np.testing.assert_allclose(got, np.asarray(j.predict(
        x, batch_per_thread=N)), rtol=0, atol=TOL)
    tr = np.random.RandomState(2).randn(4, 4)
    t.transitions = tr
    j.transitions = tr
    tags = np.random.RandomState(3).randint(0, 4, (N, S)).astype(np.int32)
    assert abs(t.crf_loss(x, tags) - j.crf_loss(x, tags)) < TOL
    np.testing.assert_array_equal(t.decode(x), j.decode(x))
    with pytest.raises(ValueError, match="crf_mode"):
        ttxt.NER(3, 10, 10, crf_mode="wild", device="cpu")


def test_ner_three_step_fit_matches_jax():
    """sparse categorical cross-entropy from logits over the emissions,
    as the JAX `TestNER.test_forward_and_fit` trains."""
    t, j = ner_pair()
    no_dropout(t, j)
    x = text_data(4)
    share(t, j, x, seed=5)
    y = np.random.RandomState(6).randint(0, 4, (N, S)).astype(np.int32)
    th, jh = fit_both(t, j, x, y,
                      tobj.get("sparse_categorical_crossentropy",
                               from_logits=True),
                      jobj.get("sparse_categorical_crossentropy",
                               from_logits=True))
    same_fit(t, j, th, jh, graph_params(t, j))


TAGGER_ARGS = dict(num_pos_labels=5, num_chunk_labels=3, word_vocab_size=WV,
                   word_length=W, feature_size=6)


@pytest.mark.parametrize("chars", [True, False])
def test_sequence_tagger_matches_jax(chars):
    args = dict(TAGGER_ARGS, char_vocab_size=CV if chars else None)
    t = ttxt.POSTagger(device="cpu", **args)
    j = jtxt.SequenceTagger(**args)
    assert ttxt.POSTagger is ttxt.SequenceTagger
    x = text_data(7) if chars else text_data(7)[0]
    share(t, j, x, seed=8)
    got = t.predict(x, batch_per_thread=N)
    want = j.predict(x, batch_per_thread=N)
    for g, w, width in zip(got, want, (5, 3)):
        assert g.shape == (N, S, width)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL)
    if not chars:
        return
    no_dropout(t, j)
    rs = np.random.RandomState(9)
    y = [rs.randint(0, 5, (N, S)).astype(np.int32),
         rs.randint(0, 3, (N, S)).astype(np.int32)]
    loss = ["sparse_categorical_crossentropy"] * 2
    th, jh = fit_both(t, j, x, y, loss, loss)
    same_fit(t, j, th, jh, graph_params(t, j))


def test_intent_entity_matches_jax():
    args = dict(num_intents=3, num_entities=4, word_vocab_size=WV,
                char_vocab_size=CV, word_length=W, word_emb_dim=6,
                char_emb_dim=4, char_lstm_dim=3, tagger_lstm_dim=5)
    t, j = ttxt.IntentEntity(device="cpu", **args), jtxt.IntentEntity(**args)
    x = text_data(10)
    share(t, j, x, seed=11)
    got = t.predict(x, batch_per_thread=N)
    want = j.predict(x, batch_per_thread=N)
    assert got[0].shape == (N, 3) and got[1].shape == (N, S, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL)
    no_dropout(t, j)
    rs = np.random.RandomState(12)
    y = [rs.randint(0, 3, (N,)).astype(np.int32),
         rs.randint(0, 4, (N, S)).astype(np.int32)]
    loss = ["sparse_categorical_crossentropy"] * 2
    th, jh = fit_both(t, j, x, y, loss, loss)
    same_fit(t, j, th, jh, graph_params(t, j))


# ---------------------------------------------------------------------------
# KNRM
# ---------------------------------------------------------------------------
KNRM_ARGS = dict(text1_length=4, text2_length=6, vocab_size=WV,
                 embed_size=8, kernel_num=5, sigma=0.3)


@pytest.mark.parametrize("mode", ["ranking", "classification"])
def test_knrm_matches_jax(mode):
    t = ttm.KNRM(device="cpu", target_mode=mode, **KNRM_ARGS)
    j = jtm.KNRM(target_mode=mode, **KNRM_ARGS)
    assert t._config == j._config
    rs = np.random.RandomState(13)
    x = rs.randint(1, WV, (N, 10)).astype(np.int32)
    x[:, 6] = x[:, 1]       # an exact match for the exact-match kernel
    share(t, j, x, seed=14)
    np.testing.assert_allclose(t.predict(x), j.predict(x), rtol=0,
                               atol=TOL)
    queries = [(rs.randint(1, WV, (5, 10)).astype(np.int32),
                (rs.rand(5) > 0.5).astype(np.float32)) for _ in range(3)]
    assert t.evaluate_ndcg(queries, k=3) == pytest.approx(
        j.evaluate_ndcg(queries, k=3), abs=TOL)
    assert t.evaluate_map(queries) == pytest.approx(j.evaluate_map(queries),
                                                    abs=TOL)
    if mode == "classification":
        return
    y = rs.rand(N, 1).astype(np.float32)
    th, jh = fit_both(t, j, x, y, "mse", "mse")
    same_fit(t, j, th, jh, graph_params(t, j))
    with pytest.raises(ValueError, match="kernel_num"):
        ttm.KNRM(4, 6, WV, kernel_num=1, device="cpu")


# ---------------------------------------------------------------------------
# Seq2seq
# ---------------------------------------------------------------------------
def seq_data(seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(4, 5, 3).astype(np.float32),
            rs.randn(4, 6, 2).astype(np.float32)]


@pytest.mark.parametrize("rnn, bridge, gen", [
    ("lstm", "dense", 2), ("gru", None, None), ("simplernn", "dense", 2)])
def test_seq2seq_matches_jax(rnn, bridge, gen):
    hidden = ([5, 4], [6, 3]) if bridge else ([4], [4])
    args = dict(rnn_type=rnn, encoder_hidden=hidden[0],
                decoder_hidden=hidden[1], bridge=bridge,
                generator_units=gen)
    t, j = ts2s.Seq2seq(device="cpu", **args), js2s.Seq2seq(**args)
    x = seq_data(15)
    if gen is None:
        x[1] = np.random.RandomState(16).randn(4, 6, 4).astype(np.float32)
    t.model.ensure_built(x, seed=17)
    tree = convert.seq2seq_params_to_jax(t.model.state_dict())
    want = jax.eval_shape(lambda: j.model.build(
        jax.random.PRNGKey(0), [(None, 5, 3), (None,) + x[1].shape[1:]]))
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(want)
    j.model.params = tree
    for k, v in convert.seq2seq_params_from_jax(tree).items():
        assert torch.equal(v, t.model.state_dict()[k])
    got = t.predict(x, batch_per_thread=4)
    np.testing.assert_allclose(got, j.predict(x, batch_per_thread=4),
                               rtol=0, atol=TOL)
    start = x[1][:, 0]
    np.testing.assert_allclose(t.infer(x[0], start, max_seq_len=4),
                               j.infer(x[0], start, max_seq_len=4), rtol=0,
                               atol=TOL)
    if rnn != "lstm":
        return
    y = np.random.RandomState(18).randn(4, 6, gen).astype(np.float32)
    th, jh = fit_both(t, j, x, y, "mse", "mse")
    same_fit(t, j, th, jh, convert.seq2seq_params_from_jax)
    with pytest.raises(ValueError, match="same number"):
        ts2s.Seq2seq(encoder_hidden=[3], decoder_hidden=[3, 3],
                     device="cpu")


# ---------------------------------------------------------------------------
# TransformerLayer
# ---------------------------------------------------------------------------
def test_transformer_layer_matches_jax():
    """In a functional model, converted by position: the forward (plain and
    `use_flash`) against JAX, and the dropout sites drawing from the
    model's seed."""
    kw = dict(vocab=30, seq_len=6, n_block=2, hidden_size=8, n_head=2)
    jl = jtr.TransformerLayer(**kw)
    ids = np.random.RandomState(19).randint(0, 30, (3, 6)).astype(np.int32)
    want = None
    for flash in (False, True):
        inp = Input(shape=(6,))
        m = Model(inp, ttr.TransformerLayer(use_flash=flash, device="cpu",
                                            **kw)(inp))
        if want is None:
            state = {k: torch.as_tensor(rand(tuple(v.shape), 20 + i, 0.3))
                     for i, (k, v) in enumerate(m.state_dict().items())}
            jparams = convert.model_params_to_jax(state, [jl.name], m)
            shapes = jax.eval_shape(lambda: jl.build(jax.random.PRNGKey(0),
                                                     (None, 6)))
            assert jax.tree_util.tree_structure(jparams[jl.name]) == \
                jax.tree_util.tree_structure(shapes)
            want = np.asarray(jax.jit(jl.call)(jparams[jl.name],
                                               jnp.asarray(ids)))
        m.load_state_dict(convert.model_params_from_jax(jparams, [jl.name],
                                                        m))
        np.testing.assert_allclose(m.predict(ids), want, rtol=0, atol=TOL)
    x = torch.as_tensor(ids)
    a = m.apply(x, training=True, seed=3)
    assert torch.equal(a, m.apply(x, training=True, seed=3))
    assert not torch.equal(a, m.apply(x, training=True, seed=4))
    assert m.compute_output_shape((None, 6)) == (None, 6, 8)


# ---------------------------------------------------------------------------
# the trainer's cache and a deleted model
# ---------------------------------------------------------------------------
def _fitted_model():
    m = ttxt.NER(device="cpu", **NER_ARGS)
    x = text_data(21)
    y = np.random.RandomState(22).randint(0, 4, (N, S)).astype(np.int32)
    m.compile(optimizers.fused_adam(1e-3), tobj.get(
        "sparse_categorical_crossentropy", from_logits=True))
    m.fit(x, y, batch_size=N, nb_epoch=1, fused_optimizer=True)
    assert m.model.__dict__.get("_train_cache") is not None
    return [weakref.ref(o) for o in (m.model, m.model._train_cache[1],
                                     m.model.ordered_layers()[0])]


def test_deleted_fitted_model_is_freed_without_a_collection():
    """The trainer caches its entry on the model and the entry holds the
    model weakly, and a graph's node order holds no cycle, so a deleted
    model, its programs and its layers go by reference count. (One fit
    runs first: the first dispatch mode of a process keeps its frames
    inside torch, once.)"""
    _fitted_model()
    gc.collect()
    gc.disable()
    try:
        assert [r() for r in _fitted_model()] == [None, None, None]
    finally:
        gc.enable()


@pytest.mark.parametrize("module", [
    "keras.layers", "keras.layers_ext", "keras.transformer", "keras.engine",
    "keras2.layers", "ops.crf", "models.common", "models.textmodels",
    "models.seq2seq", "models.textmatching"])
def test_every_public_name_has_a_twin(module):
    """Each class and function the JAX module defines has a port twin of
    the same name."""
    import importlib
    import inspect
    jmod = importlib.import_module("analytics_zoo_tpu." + module)
    tmod = importlib.import_module("analytics_zoo_tpu_torch." + module)
    names = [n for n, o in vars(jmod).items()
             if (inspect.isclass(o) or inspect.isfunction(o))
             and o.__module__ == jmod.__name__]
    assert names and [n for n in names if not hasattr(tmod, n)] == []
