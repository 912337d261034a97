"""The data layer wired into the port's `Estimator`, held against the JAX
package: a small conv model (no dropout) trained 2 epochs through
`Estimator.fit(TPUDataset.from_tfrecord(...))` on a 16×16 TFRecord corpus
in both packages from the same initial weights (the port's copy made by
`convert.model_params_from_jax`, the converter of a layer model's tree;
JAX's fit with `device_cache=False, distributed=False`): the loss curves
and the final weights within 1e-5 (f32). Then a pandas DataFrame fit with
`feature_cols` / `label_cols` and an `XShards` fit, each against JAX's,
and `evaluate` / `predict` over the streamed dataset."""

import numpy as np
import optax
import pandas as pd
import pytest
from torch_data_impls import no_pipeline_threads

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.data import shards as jshards
from analytics_zoo_tpu.data.dataset import TPUDataset as JDataset
from analytics_zoo_tpu.keras import Sequential as JSequential
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.data import shards as tshards
from analytics_zoo_tpu_torch.data import tfrecord as ttfr
from analytics_zoo_tpu_torch.data.dataset import TPUDataset as TDataset
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Sequential
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.ops import optimizers

LR = 1e-3
TOL = 1e-5
LOSS = "sparse_categorical_crossentropy"


@pytest.fixture(scope="module", autouse=True)
def ctx():
    c = zoo.init_orca_context(cluster_mode="local")
    yield c
    zoo.stop_orca_context()


def _conv_pair():
    j = JSequential([
        JL.Convolution2D(4, 3, 3, activation="relu", input_shape=(16, 16, 3)),
        JL.MaxPooling2D((2, 2)), JL.Flatten(),
        JL.Dense(3, activation="softmax")])
    t = Sequential([
        L.Convolution2D(4, 3, 3, activation="relu", input_shape=(16, 16, 3),
                        device="cpu"),
        L.MaxPooling2D((2, 2)), L.Flatten(),
        L.Dense(3, activation="softmax", device="cpu")])
    t.ensure_built(seed=0)
    names = [layer.name for layer in j._ordered_layers()]
    init = convert.model_params_to_jax(t.state_dict(), names, t)
    return j, t, names, init


def _corpus(tmp_path):
    rs = np.random.RandomState(0)
    for s in range(3):
        recs = []
        for _ in range(16):
            label = rs.randint(3)
            img = rs.randint(0, 256, (18, 18, 3)).astype(np.uint8)
            img[..., label] //= 4                 # a learnable colour cue
            recs.append(ttfr.encode_example({
                "image/encoded": img.tobytes(),
                "image/class/label": np.asarray([label], np.int64)}))
        ttfr.write_tfrecord(str(tmp_path / f"train-{s:05d}"), recs)
    return str(tmp_path / "train-*")


def _parse(ex):
    img = np.frombuffer(ex["image/encoded"][0], np.uint8).reshape(18, 18, 3)
    return (img[1:17, 1:17].astype(np.float32) / 255.0,
            np.int32(ex["image/class/label"][0]))


def _state_close(t, names, jparams):
    want = convert.model_params_from_jax(jparams, names, t)
    for key, value in t.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=0, atol=TOL, err_msg=key)


def test_tfrecord_fit_matches_jax(tmp_path):
    pattern = _corpus(tmp_path)
    j, t, names, init = _conv_pair()
    j.params = init

    def ds(cls):
        return cls.from_tfrecord(pattern, _parse, batch_size=8,
                                 shuffle_buffer=16, num_workers=3)

    jh = JEstimator.from_keras(j, optimizer=optax.adam(LR), loss=LOSS).fit(
        ds(JDataset), epochs=2, device_cache=False, distributed=False)
    tds = ds(TDataset)
    est = Estimator.from_keras(t, optimizer=optimizers.adam(LR), loss=LOSS,
                               device="cpu")
    th = est.fit(tds, epochs=2)
    assert len(th["loss"]) == len(jh["loss"]) == 2
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=TOL)
    _state_close(t, names, j.params)
    assert no_pipeline_threads() == []
    # evaluate / predict run over the dataset's materialize()
    x, y = tds.materialize()
    assert x.shape == (48, 16, 16, 3)
    preds = est.predict(tds)
    np.testing.assert_allclose(preds, t.predict(x), rtol=0, atol=1e-6)
    res = est.evaluate(tds, metrics=["accuracy"])
    want = JEstimator.from_keras(j, optimizer=optax.adam(LR), loss=LOSS) \
        .evaluate(ds(JDataset), metrics=["accuracy"])
    assert res["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)


def test_unbuilt_model_built_from_first_sample(tmp_path):
    """A stream builds an unbuilt model from one record (`first_sample`),
    not from a shuffle buffer's fill."""
    pattern = _corpus(tmp_path)
    t = Sequential([L.Flatten(), L.Dense(3, activation="softmax",
                                         device="cpu")])
    ds = TDataset.from_tfrecord(pattern, _parse, batch_size=8)
    calls = []
    first = ds.first_sample
    ds.first_sample = lambda: calls.append(1) or first()
    h = Estimator.from_keras(t, optimizer="adam", loss=LOSS,
                             device="cpu").fit(ds, epochs=1)
    assert calls == [1] and np.isfinite(h["loss"][0])
    assert t.ordered_layers()[1].kernel.shape[-2:] in (
        (768, 3), (3, 768))


def _dense_pair():
    j = JSequential([JL.Dense(8, activation="tanh", input_shape=(5,)),
                     JL.Dense(3, activation="softmax")])
    t = Sequential([L.Dense(8, activation="tanh", input_shape=(5,),
                            device="cpu"),
                    L.Dense(3, activation="softmax", device="cpu")])
    t.ensure_built(seed=1)
    names = [layer.name for layer in j._ordered_layers()]
    j.params = convert.model_params_to_jax(t.state_dict(), names, t)
    return j, t, names


def _table(n=64):
    rs = np.random.RandomState(2)
    a = rs.randn(n, 3).astype(np.float32)
    b = rs.randn(n, 2).astype(np.float32)
    y = (a.sum(1) > b.sum(1)).astype(np.int32) + (a[:, 0] > 1)
    return a, b, y


def test_dataframe_fit_matches_jax():
    a, b, y = _table()
    df = pd.DataFrame({"a": list(a), "b": list(b), "y": y})
    j, t, names = _dense_pair()
    kw = dict(epochs=2, batch_size=16, feature_cols=["ab"],
              label_cols=["y"])
    df["ab"] = list(np.concatenate([a, b], axis=1))
    jh = JEstimator.from_keras(j, optimizer=optax.adam(LR), loss=LOSS).fit(
        df, device_cache=False, distributed=False, **kw)
    est = Estimator.from_keras(t, optimizer=optimizers.adam(LR), loss=LOSS,
                               device="cpu")
    th = est.fit(df, **kw)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=TOL)
    _state_close(t, names, j.params)
    got = est.predict(df, feature_cols=["ab"])
    np.testing.assert_allclose(got, t.predict(np.stack(df["ab"])),
                               rtol=0, atol=1e-6)
    res = est.evaluate(df, feature_cols=["ab"], label_cols=["y"])
    assert np.isfinite(res["loss"])
    with pytest.raises(ValueError, match="needs feature_cols"):
        est.fit(df)


def test_xshards_fit_matches_jax():
    a, b, y = _table()
    x = np.concatenate([a, b], axis=1)
    j, t, names = _dense_pair()
    jh = JEstimator.from_keras(j, optimizer=optax.adam(LR), loss=LOSS).fit(
        jshards.XShards.partition({"x": x, "y": y}, 4), epochs=2,
        batch_size=16, device_cache=False, distributed=False)
    th = Estimator.from_keras(t, optimizer=optimizers.adam(LR), loss=LOSS,
                              device="cpu").fit(
        tshards.XShards.partition({"x": x, "y": y}, 4), epochs=2,
        batch_size=16)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=TOL)
    _state_close(t, names, j.params)


def test_dataset_batch_size_wins_over_fit():
    """A dataset's own batch size wins over `fit(batch_size=...)`, as in
    the JAX `fit` (64 rows at the dataset's 32: 2 steps, not 8)."""
    a, b, y = _table()
    x = np.concatenate([a, b], axis=1)
    _, t, _ = _dense_pair()
    est = Estimator.from_keras(t, optimizer="adam", loss=LOSS, device="cpu")
    steps = []

    def record(state):
        if not state.epoch_finished:
            steps.append(state.iteration)
        return False

    h = est.fit(TDataset.from_ndarrays((x, y), batch_size=32), epochs=1,
                batch_size=8, end_trigger=record)
    assert np.isfinite(h["loss"][0]) and steps == [1, 2]
