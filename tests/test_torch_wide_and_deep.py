"""The port's `WideAndDeep` held against the JAX package on the CPU: the
`wide`, `deep` and `wide_n_deep` forwards, a 3-step `Estimator.fit` (fused
Adam on its plain version, and plain Adam), serving through
`InferenceModel`, and the argument errors.

Both packages take the same weights: the port's, drawn from a seed,
carried to the JAX tree by `convert`. Inputs come from numpy with a seed,
at small widths (two embedding columns of 50 ids, hidden 16 and 8), the
column layout of the wide-n-deep app at MovieLens-1M (`PERF.md` §4) cut
down.

Tolerances (absolute): forwards 1e-5; the 3-step f32 fit (Adam at lr
1e-3, one batch an epoch, the JAX fit with host batches): per-step losses
1e-5, parameters 1e-4; serving 1e-6 against `predict`.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.models import WideAndDeep
from analytics_zoo_tpu_torch.ops import optimizers
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel

TOL = 1e-5
FIT_LOSS_TOL = 1e-5
FIT_PARAM_TOL = 1e-4
FIT_LR = 1e-3
FIT_STEPS = 3
LOSS = "sparse_categorical_crossentropy"
COLUMNS = dict(class_num=5, wide_base_dims=(6, 3), wide_cross_dims=(10,),
               indicator_dims=(4, 3), embed_in_dims=(50, 50),
               embed_out_dims=(8, 6), continuous_cols=("age", "hours"),
               hidden_layers=(16, 8))
TYPES = ["wide", "deep", "wide_n_deep"]


@pytest.fixture(scope="module", autouse=True)
def ctx():
    c = zoo.init_orca_context(cluster_mode="local")
    yield c
    zoo.stop_orca_context()


def names(jmodel):
    return [(l.name, names(l)) if hasattr(l, "_ordered_layers") else l.name
            for l in jmodel._ordered_layers()]


def pair(model_type, seed=0, **kw):
    args = dict(COLUMNS, model_type=model_type, **kw)
    t = WideAndDeep(device="cpu", **args)
    j = jrec.WideAndDeep(**args)
    t.model.ensure_built(seed=seed)
    j.model.params = convert.model_params_to_jax(
        t.model.state_dict(), names(j.model), t.model)
    return t, j


def inputs(model_type, n, seed):
    """The model's inputs: wide multi-hot, indicator multi-hot, 1-based
    embedding ids, continuous values."""
    rs = np.random.RandomState(seed)
    wide = (rs.rand(n, 19) < 0.2).astype(np.float32)
    ind = (rs.rand(n, 7) < 0.3).astype(np.float32)
    ids = rs.randint(1, 51, (n, 2)).astype(np.int32)
    con = rs.standard_normal((n, 2)).astype(np.float32)
    return {"wide": wide, "deep": [ind, ids, con],
            "wide_n_deep": [wide, ind, ids, con]}[model_type]


@pytest.mark.parametrize("model_type", TYPES)
def test_forward_matches_jax(model_type):
    t, j = pair(model_type, seed=1)
    assert t._config == j._config
    assert [type(l).__name__ for l in t.model.ordered_layers()] == [
        type(l).__name__ for l in j.model._ordered_layers()]
    assert len(t.model.inputs) == len(j.model.inputs)
    x = inputs(model_type, 7, 2)
    got = t.predict(x, batch_per_thread=4)
    assert got.shape == (7, 5)
    np.testing.assert_allclose(got, j.predict(x, batch_per_thread=4),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=TOL)
    embeds = [l for l in t.model.ordered_layers()
              if isinstance(l, L.Embedding)]
    assert [tuple(e.embeddings.shape) for e in embeds] == (
        [] if model_type == "wide" else [(51, 8), (51, 6)])


def test_uniform_init_and_no_lazy_tables():
    t = WideAndDeep(device="cpu", **COLUMNS)
    t.model.ensure_built(seed=3)
    table = t.model.ordered_layers()[2].embeddings.detach()
    assert isinstance(t.model.ordered_layers()[2], L.Embedding)
    # jax.nn.initializers.uniform(0.05): [0, 0.05)
    assert 0.0 <= float(table.min()) and float(table.max()) < 0.05
    assert not hasattr(t.model, "lazy_embedding_specs")


@pytest.mark.parametrize("model_type", TYPES)
@pytest.mark.parametrize("fused", [True, False])
def test_three_step_fit_matches_jax(model_type, fused):
    """`fused=True` is the card path (the fused-Adam sweep, its plain
    version on the CPU), `fused=False` the port's plain Adam."""
    t, j = pair(model_type, seed=4)
    x = inputs(model_type, 16, 5)
    y = np.random.RandomState(6).randint(0, 5, 16).astype(np.int32)
    jh = JEstimator.from_keras(j.model, optimizer=optax.adam(FIT_LR),
                               loss=LOSS).fit(
        (x, y), epochs=FIT_STEPS, batch_size=16, distributed=False,
        device_cache=False)
    opt = optimizers.fused_adam(FIT_LR) if fused else optimizers.adam(FIT_LR)
    th = Estimator.from_keras(t.model, optimizer=opt, loss=LOSS,
                              device="cpu").fit(
        (x, y), epochs=FIT_STEPS, batch_size=16, fused_optimizer=fused)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0,
                               atol=FIT_LOSS_TOL)
    assert th["loss"][-1] < th["loss"][0]
    want = convert.model_params_from_jax(jax.device_get(j.model.params),
                                         names(j.model), t.model)
    for key, value in t.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=0,
                                   atol=FIT_PARAM_TOL, err_msg=key)


def test_zoo_model_fit_and_evaluate_match_jax():
    t, j = pair("wide_n_deep", seed=7)
    x = inputs("wide_n_deep", 32, 8)
    y = np.random.RandomState(9).randint(0, 5, 32).astype(np.int32)
    for m in (t, j):
        m.compile("adam", LOSS, metrics=["accuracy"])
    th = t.fit(x, y, batch_size=8, nb_epoch=2)
    jh = j.fit(x, y, batch_size=8, nb_epoch=2, distributed=False,
               device_cache=False)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0,
                               atol=FIT_PARAM_TOL)
    te = t.evaluate(x, y, batch_per_thread=8)
    je = j.evaluate(x, y, batch_per_thread=8)
    assert set(te) == set(je)
    for k in te:
        np.testing.assert_allclose(te[k], je[k], rtol=0, atol=FIT_PARAM_TOL)
    np.testing.assert_array_equal(
        t.predict_classes(x, zero_based_label=False),
        j.predict_classes(x, zero_based_label=False))


def test_inference_model_serves_wide_and_deep():
    """Four inputs through `load_keras` (a `ZooModel` as it is) →
    `warmup` → `predict`: a batch padded to its bucket, every input in its
    own dtype, gives each row what `predict` gives."""
    t, _ = pair("wide_n_deep", seed=10)
    im = InferenceModel(max_batch=8, device="cpu").load_keras(t)
    im.warmup([a[0] for a in inputs("wide_n_deep", 1, 11)])
    assert im.warmed_buckets == {1, 2, 4, 8}
    x = inputs("wide_n_deep", 11, 12)
    got = im.predict(x)
    assert got.shape == (11, 5)
    np.testing.assert_allclose(got, t.predict(x, batch_per_thread=4),
                               rtol=0, atol=1e-6)


def test_argument_errors():
    with pytest.raises(TypeError, match="model_type"):
        WideAndDeep(5, model_type="linear", wide_base_dims=(3,),
                    device="cpu")
    with pytest.raises(TypeError, match="model_type"):
        jrec.WideAndDeep(5, model_type="linear", wide_base_dims=(3,))
    # a deep tower without columns: ValueError here, IndexError in the JAX
    # package (ROADMAP.md queue 3)
    with pytest.raises(ValueError, match="deep columns"):
        WideAndDeep(5, model_type="deep", device="cpu")
    with pytest.raises(IndexError):
        jrec.WideAndDeep(5, model_type="deep")
    with pytest.raises(ValueError, match="deep columns"):
        WideAndDeep(5, wide_base_dims=(3,), device="cpu")
    # mismatched embedding columns: ValueError here; the JAX package drops
    # the columns past the shorter list (ROADMAP.md queue 3)
    with pytest.raises(ValueError, match="embed_in_dims"):
        WideAndDeep(5, model_type="deep", embed_in_dims=(5, 6),
                    embed_out_dims=(4,), device="cpu")
    j = jrec.WideAndDeep(5, model_type="deep", embed_in_dims=(5, 6),
                         embed_out_dims=(4,))
    assert sum(type(l).__name__ == "Embedding"
               for l in j.model._ordered_layers()) == 1
    wide = WideAndDeep(5, model_type="wide", device="cpu")
    assert wide.model.ordered_layers()[0].kernel.shape == (0, 5)
    if not torch.cuda.is_available():
        # entry points run on the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            WideAndDeep(**COLUMNS)
