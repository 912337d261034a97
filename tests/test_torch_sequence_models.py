"""The port's recurrent models held against the JAX package on the CPU:
`AnomalyDetector` with `unroll`, `detect_anomalies` and
`ThresholdDetector`, `TextClassifier` (cnn, lstm and gru encoders, with and
without pretrained embeddings), `SessionRecommender`; 3-step
`Estimator.fit` loss curves, `ZooModel.fit`, serving through
`InferenceModel`, and the conversion of these models' trees.

Both packages take the same weights: the port's, drawn from a seed,
carried to the JAX tree by `convert`. Inputs come from numpy with a seed.
Sizes are small (T <= 8, widths <= 16 apart from TextClassifier's fixed
Dense(128) head).

Tolerances (absolute):
- model outputs in float32: 1e-5;
- 3-step fits in float32 (Adam at lr 1e-3, one batch an epoch, dropout at
  rate 0, since dropout bits differ between the frameworks; the JAX fit
  with host batches, `distributed=False, device_cache=False`): per-step
  losses 1e-4, parameters within 1e-4;
- the bf16 fit (mixed precision): per-step losses 5e-2 against the JAX
  bf16 fit;
- bf16 serving against f32 serving: 5e-2;
- the frozen `WordEmbedding` table after a fit: bit-identical;
- conversion, `unroll`, `detect_anomalies`, `ThresholdDetector`: exact.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models import anomalydetection as jad
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.models import textclassification as jtc
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.kernels import LAUNCHES
from analytics_zoo_tpu_torch.kernels import dropout as dr
from analytics_zoo_tpu_torch.kernels import fused_adam as fad
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.models import anomalydetection as tad
from analytics_zoo_tpu_torch.models import recommendation as trec
from analytics_zoo_tpu_torch.models import textclassification as ttc
from analytics_zoo_tpu_torch.ops import optimizers
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel

TOL = 1e-5
FIT_TOL = 1e-4
BF16_FIT_TOL = 5e-2
BF16_SERVE_TOL = 5e-2
FIT_LR = 1e-3
FIT_STEPS = 3
SEQ, VOCAB, EMBED, ENC = 8, 20, 8, 12
AD_SHAPE, AD_HIDDEN = (8, 3), (4, 8, 5)
CLS_LOSS = "sparse_categorical_crossentropy"


@pytest.fixture(scope="module", autouse=True)
def ctx():
    c = zoo.init_orca_context(cluster_mode="local")
    yield c
    zoo.stop_orca_context()


def names(jmodel):
    return [(l.name, names(l)) if hasattr(l, "_ordered_layers") else l.name
            for l in jmodel._ordered_layers()]


def share(t, j, seed=0):
    """Build the port model from `seed`; give the JAX model the same
    weights."""
    t.model.ensure_built(seed=seed)
    j.model.params = convert.model_params_to_jax(
        t.model.state_dict(), names(j.model), t.model)
    return j.model.params


def rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def ids(shape, seed, low=0, high=VOCAB):
    return np.random.RandomState(seed).randint(low, high, shape).astype(
        np.int32)


def text_pair(encoder, pretrained=False, **kw):
    weights = rand((VOCAB, EMBED), 9) if pretrained else None
    args = dict(class_num=4, embedding_dim=EMBED, vocab_size=VOCAB,
                sequence_length=SEQ, encoder=encoder, encoder_output_dim=ENC,
                embedding_weights=weights, **kw)
    return ttc.TextClassifier(device="cpu", **args), jtc.TextClassifier(**args)


def anomaly_pair(dropouts=(0.2, 0.2, 0.2)):
    return (tad.AnomalyDetector(AD_SHAPE, AD_HIDDEN, dropouts, device="cpu"),
            jad.AnomalyDetector(AD_SHAPE, AD_HIDDEN, dropouts))


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------
def test_anomaly_detector_matches_jax():
    t, j = anomaly_pair()
    share(t, j, seed=1)
    assert [type(l).__name__ for l in t.model.layers] == [
        type(l).__name__ for l in j.model.layers]
    assert [l.return_sequences for l in t.model.layers
            if isinstance(l, L.LSTM)] == [True, True, False]
    assert t._config == j._config
    x = rand((5,) + AD_SHAPE, 2)
    got = t.predict(x, batch_per_thread=4)
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got, j.predict(x, batch_per_thread=4), rtol=0,
                               atol=TOL)
    one = tad.AnomalyDetector(AD_SHAPE, (6,), (0.1,), device="cpu")
    assert [type(l).__name__ for l in one.model.layers] == [
        "LSTM", "Dropout", "Dense"]
    with pytest.raises(ValueError, match="lengths"):
        tad.AnomalyDetector(AD_SHAPE, (4, 5), (0.2,), device="cpu")


@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
@pytest.mark.parametrize("pretrained", [False, True])
def test_text_classifier_matches_jax(encoder, pretrained):
    t, j = text_pair(encoder, pretrained)
    share(t, j, seed=2)
    assert t._config == j._config
    first = t.model.layers[0]
    assert isinstance(first, L.WordEmbedding) == pretrained
    assert first.trainable != pretrained
    x = ids((6, SEQ), 3)
    got = t.predict(x, batch_per_thread=4)
    assert got.shape == (6, 4)
    np.testing.assert_allclose(got, j.predict(x, batch_per_thread=4), rtol=0,
                               atol=TOL)


def test_text_classifier_arguments():
    with pytest.raises(ValueError, match="embedding_weights"):
        ttc.TextClassifier(4, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        ttc.TextClassifier(4, EMBED, VOCAB, encoder="rnn", device="cpu")
    t = ttc.TextClassifier(4, EMBED, VOCAB, encoder="lstm", pretrained=True,
                           device="cpu")
    assert isinstance(t.model.layers[0], L.WordEmbedding)
    assert t._config["pretrained"]


def test_session_recommender_matches_jax():
    args = dict(item_count=30, item_embed=8, rnn_hidden_layers=(6, 4),
                session_length=5)
    t = trec.SessionRecommender(device="cpu", **args)
    j = jrec.SessionRecommender(**args)
    share(t, j, seed=3)
    assert t._config == j._config
    sessions = ids((7, 5), 4, low=1, high=31)
    got = t.predict(sessions, batch_per_thread=4)
    assert got.shape == (7, 30)
    np.testing.assert_allclose(got, j.predict(sessions, batch_per_thread=4),
                               rtol=0, atol=TOL)
    for zero_based in (True, False):
        mine = t.recommend_for_session(sessions, 3, zero_based)
        theirs = j.recommend_for_session(sessions, 3, zero_based)
        for a, b in zip(mine, theirs):
            assert [i for i, _ in a] == [i for i, _ in b]
            np.testing.assert_allclose([p for _, p in a], [p for _, p in b],
                                       rtol=0, atol=TOL)


def test_session_recommender_history_is_not_ported():
    """The history branch is ported now (its parity with the JAX package
    is in `test_torch_autograd.py`): it builds two inputs, and the
    argument checks stay."""
    t = trec.SessionRecommender(30, session_length=5, include_history=True,
                                history_length=4, device="cpu")
    assert len(t.model.inputs) == 2
    with pytest.raises(ValueError, match="history_length"):
        trec.SessionRecommender(30, session_length=5, include_history=True,
                                device="cpu")
    with pytest.raises(ValueError, match="session_length"):
        trec.SessionRecommender(30, device="cpu")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _no_dropout(*models):
    for m in models:
        for layer in m.model.layers:
            if type(layer).__name__ == "Dropout":
                layer.rate = 0.0


def _fit_case(kind):
    """(port model, JAX model, x, y, loss) for a 3-step fit from shared
    weights, dropout at rate 0."""
    if kind == "anomaly":
        t, j = anomaly_pair()
        x, y, loss = rand((16,) + AD_SHAPE, 5), rand((16,), 6), "mse"
    else:
        t, j = text_pair("lstm", pretrained=True)
        x, y, loss = ids((16, SEQ), 7), ids((16,), 8, high=4), CLS_LOSS
    _no_dropout(t, j)
    share(t, j, seed=4)
    return t, j, x, y, loss


def _jax_fit(j, x, y, loss, mixed_precision=False):
    hist = JEstimator.from_keras(j.model, optimizer=optax.adam(FIT_LR),
                                 loss=loss).fit(
        (x, y), epochs=FIT_STEPS, batch_size=len(x), distributed=False,
        device_cache=False, mixed_precision=mixed_precision)
    return hist["loss"], jax.device_get(j.model.params)


@pytest.mark.parametrize("kind", ["anomaly", "text_lstm"])
@pytest.mark.parametrize("fused", [True, False])
def test_three_step_fit_matches_jax(kind, fused):
    """`fused=True` is the slice's kernel path (the fused-Adam sweep, its
    plain version on the CPU), `fused=False` the port's plain Adam."""
    t, j, x, y, loss = _fit_case(kind)
    table = t.model.layers[0].embeddings.detach().clone() \
        if kind == "text_lstm" else None
    jloss, jparams = _jax_fit(j, x, y, loss)
    opt = optimizers.fused_adam(FIT_LR) if fused else optimizers.adam(FIT_LR)
    hist = Estimator.from_keras(t.model, optimizer=opt, loss=loss,
                                device="cpu").fit(
        (x, y), epochs=FIT_STEPS, batch_size=len(x), fused_optimizer=fused)
    np.testing.assert_allclose(hist["loss"], jloss, rtol=0, atol=FIT_TOL)
    assert hist["loss"][-1] < hist["loss"][0]
    want = convert.model_params_from_jax(jparams, names(j.model), t.model)
    for key, value in t.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=0,
                                   atol=FIT_TOL, err_msg=key)
    if table is not None:
        # the frozen table: a zero gradient, which Adam without decay
        # leaves exactly as it was
        assert torch.equal(t.model.layers[0].embeddings.detach(), table)


def test_text_lstm_bf16_fit_matches_jax():
    t, j, x, y, loss = _fit_case("text_lstm")
    jloss, _ = _jax_fit(j, x, y, loss, mixed_precision=True)
    hist = Estimator.from_keras(t.model, optimizer="adam", loss=loss,
                                device="cpu").fit(
        (x, y), epochs=FIT_STEPS, batch_size=len(x), mixed_precision=True,
        fused_optimizer=True)
    np.testing.assert_allclose(hist["loss"], jloss, rtol=0, atol=BF16_FIT_TOL)
    assert all(p.dtype == torch.float32 for p in t.model.parameters())


def test_zoo_model_fit_and_detect_anomalies_match_jax():
    """`unroll` → `ZooModel.fit` → `predict` → `detect_anomalies` on a
    seeded series with injected spikes, beside the JAX package's."""
    rs = np.random.RandomState(10)
    series = np.sin(np.arange(120) / 6.0)[:, None] * np.ones((1, 3)) \
        + 0.05 * rs.standard_normal((120, 3))
    spikes = [40, 77, 101]
    series[spikes, 0] += 4.0
    x, y = tad.unroll(series, AD_SHAPE[0])
    jx, jy = jad.unroll(series, AD_SHAPE[0])
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    t, j = anomaly_pair(dropouts=(0.0, 0.0, 0.0))
    share(t, j, seed=5)
    n = 96
    t.compile("adam", "mse")
    j.compile("adam", "mse")
    th = t.fit(x[:n], y[:n], batch_size=32, nb_epoch=2)
    jh = j.fit(x[:n], y[:n], batch_size=32, nb_epoch=2, distributed=False,
               device_cache=False)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=FIT_TOL)
    pred = t.predict(x, batch_per_thread=32)
    np.testing.assert_allclose(pred, j.predict(x, batch_per_thread=32),
                               rtol=0, atol=FIT_TOL)
    found = tad.detect_anomalies(y, pred, 3)
    np.testing.assert_array_equal(found, jad.detect_anomalies(y, pred, 3))
    assert len(found) == 3


def test_unroll_detect_and_threshold_match_jax():
    rs = np.random.RandomState(11)
    data = rs.standard_normal((30, 2)).astype(np.float32)
    for args in ((data, 5), (data[:, 0], 4, 3)):
        for a, b in zip(tad.unroll(*args), jad.unroll(*args)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="too short"):
        tad.unroll(data[:3], 5)
    truth, pred = rs.standard_normal(50), rs.standard_normal(50)
    np.testing.assert_array_equal(tad.detect_anomalies(truth, pred, 4),
                                  jad.detect_anomalies(truth, pred, 4))
    for kw in ({}, {"ratio": 0.1}, {"threshold": 0.5}):
        mine = tad.ThresholdDetector(**kw).fit(truth, pred)
        theirs = jad.ThresholdDetector(**kw).fit(truth, pred)
        assert mine.threshold == theirs.threshold
        np.testing.assert_array_equal(mine.score(truth, pred),
                                      theirs.score(truth, pred))
    with pytest.raises(ValueError, match="fit"):
        tad.ThresholdDetector().score(truth, pred)


# ---------------------------------------------------------------------------
# serving and conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("encoder", ["lstm", "gru"])
def test_inference_model_serves_text_classifier(encoder):
    """`load_keras` → `warmup` → `predict`: f32 against the JAX forward,
    bf16 against f32; a batch padded to its bucket gives each row what it
    gives alone."""
    t, j = text_pair(encoder)
    params = share(t, j, seed=6)
    t16, _ = text_pair(encoder)
    # layer names count per process: load key by key in order
    t16.model.load_state_dict(dict(zip(t16.model.state_dict(),
                                       t.model.state_dict().values())))
    t16.model.to(torch.bfloat16)
    servers = [InferenceModel(max_batch=4, device="cpu").load_keras(m.model)
               for m in (t, t16)]
    for im in servers:
        im.warmup(np.zeros((SEQ,), np.int32))
        assert im.warmed_buckets == {1, 2, 4}
    assert [im.serving_dtype for im in servers] == ["float32", "bfloat16"]
    x = ids((3, SEQ), 12)
    got = servers[0].predict(x)
    np.testing.assert_allclose(got, np.asarray(j.model.apply(params, x)),
                               rtol=0, atol=TOL)
    alone = np.concatenate([servers[0].predict(x[i:i + 1]) for i in range(3)])
    np.testing.assert_allclose(got, alone, rtol=0, atol=1e-6)
    got16 = servers[1].predict(x)
    assert got16.dtype == np.float32
    np.testing.assert_allclose(got16, got, rtol=0, atol=BF16_SERVE_TOL)


def test_weights_and_adam_state_round_trip():
    """These models' trees (Sequential names, the frozen table, a
    functional model's GRUs) and a JAX Adam state cross exactly."""
    cases = [text_pair("gru", pretrained=True), anomaly_pair(),
             (trec.SessionRecommender(30, 8, (6, 4), session_length=5,
                                      device="cpu"),
              jrec.SessionRecommender(30, 8, (6, 4), session_length=5))]
    rs = np.random.RandomState(13)
    for t, j in cases:
        params = share(t, j, seed=7)
        jnames = names(j.model)
        sd = convert.model_params_from_jax(params, jnames, t.model)
        assert sorted(sd) == sorted(t.model.state_dict())
        for k, v in sd.items():
            assert torch.equal(v, t.model.state_dict()[k])
        back = convert.model_params_to_jax(t.model.state_dict(), jnames,
                                           t.model)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(params)
        mu = jax.tree_util.tree_map(
            lambda a: rs.standard_normal(np.shape(a)).astype(np.float32),
            params)
        nu = jax.tree_util.tree_map(np.abs, mu)
        state = (optax.ScaleByAdamState(np.int32(5), mu, nu),
                 optax.EmptyState())
        port = convert.model_opt_state_from_jax(state, jnames, t.model,
                                                device="cpu")
        assert port.count == 5 and sorted(port.mu) == sorted(sd)
        out = convert.model_opt_state_to_jax(port, jnames, t.model)
        for a, b in ((out.mu, mu), (out.nu, nu)):
            for (pa, la), (pb, lb) in zip(
                    jax.tree_util.tree_leaves_with_path(a),
                    jax.tree_util.tree_leaves_with_path(b)):
                assert pa == pb
                np.testing.assert_array_equal(la, lb)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("encoder", ["lstm", "gru"])
def test_text_classifier_on_gpu(encoder):
    """The forward on the card against the CPU's (1e-5), and a fused bf16
    fit launching the dropout kernel twice a step (forward and backward of
    the one `Dropout`) and the fused-Adam kernel once."""
    _need_gpu()
    cpu, _ = text_pair(encoder, pretrained=True)
    cpu.model.ensure_built(seed=0)
    gpu, _ = text_pair(encoder, pretrained=True)
    gpu.model.to("cuda").load_state_dict(dict(zip(
        gpu.model.state_dict(), cpu.model.state_dict().values())))
    x = ids((4, SEQ), 14)
    np.testing.assert_allclose(gpu.predict(x), cpu.predict(x), rtol=0,
                               atol=TOL)
    table = gpu.model.layers[0].embeddings.detach().clone()
    LAUNCHES.reset()
    Estimator.from_keras(gpu.model, optimizer="adam", loss=CLS_LOSS).fit(
        (ids((16, SEQ), 15), ids((16,), 16, high=4)), epochs=2,
        batch_size=8, mixed_precision=True, fused_optimizer=True)
    assert LAUNCHES.get(dr.KERNEL_NAME) == 2 * 2 * 2
    assert LAUNCHES.get(fad.KERNEL_NAME) == 2 * 2
    assert torch.equal(gpu.model.layers[0].embeddings.detach(), table)
