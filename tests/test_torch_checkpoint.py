"""The port's fault-tolerant training held against the JAX package on the
CPU: checkpoint integrity (the cases of `tests/test_fault_tolerance.py`'s
`TestCheckpointIntegrity`, run on both packages), auto-resume and the step
watchdog (its `TestAutoResume` and `TestStepWatchdog`, run on the port,
with SGD, plain and fused Adam and a dropout model), publish markers,
triggers in a fit, per-epoch validation, the Estimator's `model_dir` and
retry loop, and checkpoints crossing between the packages.

A resumed fit is bitwise the uninterrupted one (`==` on the losses and
`torch.equal` on the state). Across packages: a JAX-written checkpoint
resumed by the port continues the JAX loss curve within 1e-5; a
port-written one restores in the JAX package leaf for leaf, within 1e-5
of the JAX fit's own checkpoint of the same training (relative 1e-4 for
the moments); validation histories within 1e-5. The JAX fits run with
`distributed=False, device_cache=False`, so both packages see the same
batches.
"""

import glob
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.keras import Sequential as JSequential
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.learn import checkpoint as jckpt
from analytics_zoo_tpu.learn import trainer as jtrainer
from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.common import triggers as tg
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Sequential
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
from analytics_zoo_tpu_torch.learn import trainer
from analytics_zoo_tpu_torch.learn.estimator import Estimator, FailureConfig
from analytics_zoo_tpu_torch.models import WideAndDeep
from analytics_zoo_tpu_torch.observability.registry import get_registry
from analytics_zoo_tpu_torch.ops import optimizers

CROSS_TOL = 1e-5
MOMENT_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def ctx():
    c = zoo.init_orca_context(cluster_mode="local")
    yield c
    zoo.stop_orca_context()


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    """A chaos test must never leak an armed fault into the next test."""
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _counter(name, **labels):
    fam = get_registry().get(name)
    return fam.value(**labels) if fam is not None else 0.0


# ---------------------------------------------------------------------------
# checkpoint integrity: each case on both packages
# ---------------------------------------------------------------------------
PACKAGES = {"port": (ckpt, faults), "jax": (jckpt, jfaults)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _save_two(ck, root):
    mgr = ck.CheckpointManager(str(root))
    p1 = {"w": np.arange(4, dtype=np.float32)}
    p2 = {"w": np.arange(4, dtype=np.float32) * 2}
    mgr.save(1, p1, extra={"epoch": 1})
    mgr.save(2, p2, extra={"epoch": 2})
    return mgr, p1, p2


class TestCheckpointIntegrity:
    def test_roundtrip_with_crc(self, tmp_path, pkg):
        ck, _ = pkg
        tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                "b": [np.ones(2, np.int32), {}]}
        ck.save_pytree(str(tmp_path / "t"), tree)
        loaded = ck.load_pytree(str(tmp_path / "t"))
        np.testing.assert_array_equal(loaded["a"], tree["a"])
        np.testing.assert_array_equal(loaded["b"][0], tree["b"][0])
        assert ck.verify_pytree(str(tmp_path / "t"))

    def test_corrupt_latest_falls_back_to_newest_intact(self, tmp_path, pkg):
        ck, _ = pkg
        mgr, p1, _ = _save_two(ck, tmp_path)
        npz2 = os.path.join(mgr.run_dir, "model.2.npz")
        with open(npz2, "r+b") as fh:          # torn write / bad disk
            fh.truncate(os.path.getsize(npz2) // 2)
        found = ck.latest_checkpoint(str(tmp_path))
        assert found is not None and found[1] == 1
        params, _, meta = ck.load_checkpoint(str(tmp_path))
        np.testing.assert_array_equal(params["w"], p1["w"])
        assert meta["epoch"] == 1

    def test_bitflip_detected_by_crc(self, tmp_path, pkg):
        ck, _ = pkg
        mgr, _, _ = _save_two(ck, tmp_path)
        npz2 = os.path.join(mgr.run_dir, "model.2.npz")
        size = os.path.getsize(npz2)
        with open(npz2, "r+b") as fh:          # same size, flipped bytes
            fh.seek(size // 2)
            fh.write(b"\xff\xff\xff\xff")
        assert ck.latest_checkpoint(str(tmp_path))[1] == 1
        assert not ck.checkpoint_intact(mgr.run_dir, 2)

    def test_truncate_fault_mid_write_falls_back(self, tmp_path, pkg):
        ck, fl = pkg
        mgr = ck.CheckpointManager(str(tmp_path))
        mgr.save(1, {"w": np.ones(3, np.float32)})
        with fl.injected("checkpoint.write", fl.Fault(mode="truncate")):
            mgr.save(2, {"w": np.zeros(3, np.float32)})
        assert ck.latest_checkpoint(str(tmp_path))[1] == 1

    def test_crash_during_save_leaves_no_partial_artifact(self, tmp_path,
                                                          pkg):
        ck, fl = pkg
        with fl.injected("checkpoint.write",
                         fl.Fault(exc=OSError("disk full"))):
            with pytest.raises(OSError):
                ck.save_pytree(str(tmp_path / "m"), {"w": np.ones(3)})
        assert ck.latest_checkpoint(str(tmp_path)) is None
        assert not (tmp_path / "m.npz").exists()

    def test_torn_checkpoint_set_is_invisible(self, tmp_path, pkg):
        """The model artifact commits last: a version whose optimizer and
        meta landed but whose model write crashed does not exist."""
        ck, fl = pkg
        mgr = ck.CheckpointManager(str(tmp_path))
        mgr.save(1, {"w": np.ones(3, np.float32)},
                 opt_state={"m": np.zeros(3, np.float32)},
                 extra={"epoch": 1, "epoch_finished": True})
        with fl.injected("checkpoint.write",
                         fl.Fault(after=1, exc=OSError("yanked disk"))):
            with pytest.raises(OSError):
                mgr.save(2, {"w": np.zeros(3, np.float32)},
                         opt_state={"m": np.ones(3, np.float32)},
                         extra={"epoch": 2, "epoch_finished": True})
        found = ck.find_resume_checkpoint(str(tmp_path))
        assert found is not None and found[1] == 1
        assert ck.latest_checkpoint(str(tmp_path))[1] == 1

    def test_all_corrupt_returns_none(self, tmp_path, pkg):
        ck, _ = pkg
        mgr, _, _ = _save_two(ck, tmp_path)
        for v in (1, 2):
            with open(os.path.join(mgr.run_dir, f"model.{v}.npz"),
                      "r+b") as fh:
                fh.truncate(10)
        assert ck.latest_checkpoint(str(tmp_path)) is None

    def test_keep_retires_old_versions(self, tmp_path, pkg):
        ck, _ = pkg
        mgr = ck.CheckpointManager(str(tmp_path), keep=2)
        for it in (1, 2, 3, 4):
            mgr.save(it, {"w": np.full(2, it, np.float32)},
                     opt_state={"m": np.zeros(2, np.float32)},
                     extra={"epoch": it})
            ck.write_publish_marker(mgr.run_dir, it)
        assert [v for _, v in ck.list_checkpoints(str(tmp_path))] == [4, 3]
        assert sorted(os.listdir(mgr.run_dir)) == sorted(
            f"{stem}.{it}{suffix}" for it in (3, 4)
            for stem, suffixes in (
                ("model", (".npz", ".structure.json", ".meta.json",
                           ".published.json")),
                ("optimMethod-default", (".npz", ".structure.json")))
            for suffix in suffixes)

    def test_publish_markers(self, tmp_path, pkg):
        ck, _ = pkg
        mgr, _, _ = _save_two(ck, tmp_path)
        assert ck.latest_published_checkpoint(str(tmp_path)) is None
        for v in (1, 2):
            ck.write_publish_marker(mgr.run_dir, v, extra={"v": v})
        assert ck.read_publish_marker(mgr.run_dir, 2)["extra"] == {"v": 2}
        cache = {}
        assert ck.latest_published_checkpoint(
            str(tmp_path), verify_cache=cache)[1] == 2
        assert ck.latest_published_checkpoint(
            str(tmp_path), skip_versions=[2])[1] == 1
        with open(os.path.join(mgr.run_dir, "model.2.npz"), "r+b") as fh:
            fh.seek(40)
            fh.write(b"\x00\x01\x02\x03")
        assert not ck.verify_publish_marker(mgr.run_dir, 2)
        assert ck.latest_published_checkpoint(
            str(tmp_path), verify_cache=cache)[1] == 1
        with pytest.raises(ck.CorruptCheckpointError):
            ck.write_publish_marker(mgr.run_dir, 2)
        with pytest.raises(FileNotFoundError):
            ck.write_publish_marker(mgr.run_dir, 7)

    def test_resolve_checkpoint(self, tmp_path, pkg):
        ck, _ = pkg
        mgr, _, p2 = _save_two(ck, tmp_path)
        assert ck.resolve_checkpoint(str(tmp_path)) == (mgr.run_dir, 2)
        assert ck.resolve_checkpoint(str(tmp_path), 1) == (mgr.run_dir, 1)
        assert ck.resolve_checkpoint(mgr.run_dir, 2) == (mgr.run_dir, 2)
        assert ck.read_checkpoint_meta(mgr.run_dir, 2) == {"epoch": 2}
        with pytest.raises(FileNotFoundError):
            ck.resolve_checkpoint(str(tmp_path), 9)
        with pytest.raises(FileNotFoundError):
            ck.load_checkpoint(str(tmp_path / "nothing"))


def test_each_package_reads_the_others_training_artifacts(tmp_path):
    """A checkpoint set written by either manager lists, verifies and loads
    in the other, its publish marker included."""
    for writer, reader in ((ckpt, jckpt), (jckpt, ckpt)):
        root = tmp_path / writer.__name__.split(".")[0]
        mgr = writer.CheckpointManager(str(root))
        opt = [np.int32(3), {"d": {"w": np.ones(2, np.float32)}}, []]
        mgr.save(5, {"d": {"w": np.arange(2, dtype=np.float32)}},
                 opt_state=opt, extra={"epoch": 1, "epoch_finished": True})
        writer.write_publish_marker(mgr.run_dir, 5)
        run_dir, version, meta = reader.find_resume_checkpoint(str(root))
        assert version == 5 and meta["epoch"] == 1
        assert reader.published_intact(run_dir, 5)
        params, tree, _ = reader.load_checkpoint(str(root))
        np.testing.assert_array_equal(params["d"]["w"], [0.0, 1.0])
        assert int(tree[0]) == 3 and tree[2] == []


def test_restore_opt_state_checks_leaves():
    template = (optimizers.FusedAdamState(np.int32(0),
                                          {"a": np.zeros(2, np.float32)},
                                          {"a": np.zeros(2, np.float32)}),
                optimizers.EmptyState())
    a = np.array
    got = ckpt.restore_opt_state(template, [[a(7), {"a": a([1, 2])},
                                             {"a": a([3, 4])}], []])
    assert isinstance(got[0], optimizers.FusedAdamState)
    assert got[0].count == 7 and got[0].count.dtype == np.int32
    np.testing.assert_array_equal(got[0].nu["a"], [3.0, 4.0])
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore_opt_state(template, [[a(7), {"a": a([1, 2])}], []])
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_opt_state(template, [[a(7), {"a": a([1, 2, 3])},
                                           {"a": a([3, 4])}], []])


# ---------------------------------------------------------------------------
# training auto-resume and the step watchdog
# ---------------------------------------------------------------------------
KINDS = ["sgd", "adam", "fused", "dropout"]


def _model(kind="sgd"):
    m = Sequential()
    m.add(L.Dense(8, activation="relu", input_shape=(6,), device="cpu"))
    if kind == "dropout":
        m.add(L.Dropout(0.3))
    m.add(L.Dense(1, device="cpu"))
    m.compile(optimizer=optimizers.sgd(1e-2) if kind == "sgd" else "adam",
              loss="mse")
    return m


def _data(n=128):
    rs = np.random.RandomState(3)
    x = rs.randn(n, 6).astype(np.float32)
    return x, (x @ rs.randn(6, 1)).astype(np.float32)


def _fit(model, x, y, epochs, kind="sgd", **kw):
    kw.setdefault("batch_size", 32)
    kw.setdefault("seed", 7)
    kw.setdefault("fused_optimizer", kind == "fused")
    return trainer.fit_keras(model, x, y, epochs=epochs, **kw)


def _newest_version(root):
    return ckpt.list_checkpoints(str(root))[0]


class TestAutoResume:
    @pytest.mark.parametrize("kind", KINDS)
    def test_bitwise_identical_continuation(self, tmp_path, kind):
        """Kill after epoch 2, relaunch with auto_resume=True: epochs 3-4
        are bitwise the uninterrupted run's, and so is the state."""
        x, y = _data()
        m_full = _model(kind)
        m_full.set_checkpoint(str(tmp_path / "full"))
        hist_full = _fit(m_full, x, y, 4, kind)

        m_a = _model(kind)
        m_a.set_checkpoint(str(tmp_path / "run"))
        _fit(m_a, x, y, 2, kind)              # "killed" at this boundary

        before = _counter("training_resumes_total")
        m_b = _model(kind)
        m_b.set_checkpoint(str(tmp_path / "run"))
        hist_resumed = _fit(m_b, x, y, 4, kind, auto_resume=True)
        assert hist_resumed["loss"] == hist_full["loss"][2:]
        assert _counter("training_resumes_total") == before + 1
        for a, b in zip(m_b.state_dict().values(),
                        m_full.state_dict().values()):
            assert torch.equal(a, b)
        # the final checkpoints (parameters, moments, count, generator)
        _, p_full, meta_full = ckpt.load_checkpoint(str(tmp_path / "full"))
        _, p_res, meta_res = ckpt.load_checkpoint(str(tmp_path / "run"))
        for a, b in zip(jax.tree_util.tree_leaves(p_full),
                        jax.tree_util.tree_leaves(p_res)):
            np.testing.assert_array_equal(a, b)
        assert meta_full == meta_res

    def test_resume_without_checkpoint_trains_fresh(self, tmp_path):
        x, y = _data()
        before = _counter("training_resumes_total")
        m = _model()
        m.set_checkpoint(str(tmp_path / "empty"))
        hist = _fit(m, x, y, 2, auto_resume=True)
        assert len(hist["loss"]) == 2
        assert _counter("training_resumes_total") == before

    def test_resume_requires_checkpoint_path(self):
        x, y = _data()
        with pytest.raises(ValueError, match="set_checkpoint"):
            _fit(_model(), x, y, 1, auto_resume=True)

    @pytest.mark.parametrize("kind", ["sgd", "fused"])
    def test_resume_skips_corrupt_latest(self, tmp_path, kind):
        """The newest checkpoint is torn on disk: resume falls back to the
        previous intact one and still continues bitwise."""
        x, y = _data()
        hist_full = _fit(_model(kind), x, y, 3, kind)
        m_a = _model(kind)
        m_a.set_checkpoint(str(tmp_path))
        _fit(m_a, x, y, 2, kind)
        newest = sorted(
            glob.glob(str(tmp_path / "*" / "model.*.npz")),
            key=lambda p: int(p.rsplit(".", 2)[-2]))[-1]
        with open(newest, "r+b") as fh:
            fh.truncate(os.path.getsize(newest) // 3)
        m_b = _model(kind)
        m_b.set_checkpoint(str(tmp_path))
        hist_resumed = _fit(m_b, x, y, 3, kind, auto_resume=True)
        assert hist_resumed["loss"] == hist_full["loss"][1:]

    @pytest.mark.parametrize("kind", ["sgd", "fused", "dropout"])
    def test_mid_epoch_kill_resumes_from_boundary(self, tmp_path, kind):
        """A step fault kills the run mid-epoch 3 (the emergency checkpoint
        is mid-epoch); resume takes the newest epoch-boundary checkpoint,
        so the continuation stays bitwise."""
        x, y = _data()
        hist_full = _fit(_model(kind), x, y, 4, kind)
        m_a = _model(kind)
        m_a.set_checkpoint(str(tmp_path))
        faults.inject(
            "trainer.step",
            faults.Fault(exc=RuntimeError("chip fell over"),
                         match=lambda c: c.get("iteration", 0) >= 9))
        with pytest.raises(RuntimeError, match="chip fell over"):
            _fit(m_a, x, y, 4, kind)           # dies mid-epoch 3
        faults.clear("trainer.step")
        run_dir, newest = _newest_version(tmp_path)
        meta = ckpt.read_checkpoint_meta(run_dir, newest)
        assert newest == 9 and meta["emergency"] is True
        assert meta["epoch_finished"] is False
        assert ckpt.find_resume_checkpoint(str(tmp_path))[1] == 8

        m_b = _model(kind)
        m_b.set_checkpoint(str(tmp_path))
        hist_resumed = _fit(m_b, x, y, 4, kind, auto_resume=True)
        assert hist_resumed["loss"] == hist_full["loss"][2:]

    def test_resume_refuses_a_toggled_fused_layout(self, tmp_path):
        x, y = _data()
        m_a = _model("adam")
        m_a.set_checkpoint(str(tmp_path))
        _fit(m_a, x, y, 1, "adam")
        m_b = _model("adam")
        m_b.set_checkpoint(str(tmp_path))
        with pytest.raises(ValueError, match="toggled"):
            _fit(m_b, x, y, 2, "fused", auto_resume=True)

    def test_restored_state_is_bitwise_the_saved_state(self, tmp_path):
        """`restore_training_state` reads back exactly what the fit wrote:
        parameters, moments, count and the generator's state."""
        x, y = _data()
        m_a = _model("dropout")
        m_a.set_checkpoint(str(tmp_path))
        _fit(m_a, x, y, 2, "dropout", fused_optimizer=True)
        m_b = _model("dropout")
        m_b.ensure_built(x, seed=99)
        opt = optimizers.as_fused(m_b.optimizer, "adam")
        fresh = opt.init(dict(m_b.named_parameters()))
        gen = torch.Generator().manual_seed(0)
        state, meta = trainer.restore_training_state(
            m_b, opt, fresh, gen, str(tmp_path))
        run_dir, version, _ = ckpt.find_resume_checkpoint(str(tmp_path))
        params, tree, _ = ckpt.load_checkpoint(run_dir, version)
        assert meta["iteration"] == version == 8 and state.count == 8
        for a, b in zip(m_b.state_dict().values(), m_a.state_dict().values()):
            assert torch.equal(a, b)
        got = convert.opt_layout_to_jax(opt, state, m_b)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)
        want = torch.Generator().manual_seed(7)
        torch.randint(0, 2 ** 62, (8,), generator=want)
        assert torch.equal(gen.get_state(), want.get_state())


def _advance_to_digit_boundary(counters, make):
    """Create throwaway layers until the next auto-generated name ends a
    run of nines (dense_9, dense_99, ...): the next model's two names
    then sort in the other order than the one after it."""
    n = counters["Dense"]
    boundary = 10 ** len(str(n + 1)) - 1
    for _ in range(boundary - 1 - n):
        make()


def test_resume_across_an_auto_name_digit_boundary(tmp_path):
    """The saving model's layers are dense_9 / dense_10 (sorted: the second
    first), the resuming one's dense_11 / dense_12: the port remaps the
    moments by layer as it remaps the parameters, and continues bitwise.
    The JAX package pours the moments by sorted leaf order and fails on
    the same pair of models (ROADMAP.md queue 3)."""
    from analytics_zoo_tpu.keras import engine as jengine
    from analytics_zoo_tpu_torch.keras import engine as tengine
    x, y = _data()
    hist_full = _fit(_model("adam"), x, y, 2, "adam")
    _advance_to_digit_boundary(tengine._name_counters,
                               lambda: L.Dense(1, device="cpu"))
    m_a = _model("adam")
    m_a.set_checkpoint(str(tmp_path / "port"))
    _fit(m_a, x, y, 1, "adam")
    m_b = _model("adam")
    names = [l.name for l in m_a.ordered_layers()] + \
        [l.name for l in m_b.ordered_layers()]
    assert sorted(names[:2]) != names[:2] and sorted(names[2:]) == names[2:]
    m_b.set_checkpoint(str(tmp_path / "port"))
    assert _fit(m_b, x, y, 2, "adam", auto_resume=True)["loss"] == \
        hist_full["loss"][1:]

    def jmodel():
        m = JSequential()
        m.add(JL.Dense(8, activation="relu", input_shape=(6,)))
        m.add(JL.Dense(1))
        m.compile("adam", "mse")
        return m
    _advance_to_digit_boundary(jengine._name_counters, lambda: JL.Dense(1))
    j_a = jmodel()
    j_a.set_checkpoint(str(tmp_path / "jax"))
    jtrainer.fit_keras(j_a, x, y, batch_size=32, epochs=1, seed=7,
                       **JAX_FIT)
    j_b = jmodel()
    j_b.set_checkpoint(str(tmp_path / "jax"))
    with pytest.raises(TypeError, match="shapes"):
        jtrainer.fit_keras(j_b, x, y, batch_size=32, epochs=2, seed=7,
                           auto_resume=True, **JAX_FIT)


class TestStepWatchdog:
    def test_transient_step_fault_retried(self):
        x, y = _data()
        hist_clean = _fit(_model(), x, y, 2)
        before = _counter("training_step_retries_total")
        faults.inject("trainer.step", faults.Fault(times=2))
        hist = _fit(_model(), x, y, 2, step_retries=3)
        # the fault fires before the step, so the retried run is
        # numerically identical to the clean one
        assert hist["loss"] == hist_clean["loss"]
        assert _counter("training_step_retries_total") == before + 2

    def test_exhausted_retries_checkpoint_and_raise(self, tmp_path):
        x, y = _data()
        m = _model()
        m.set_checkpoint(str(tmp_path))
        faults.inject("trainer.step", faults.Fault(after=5))
        with pytest.raises(faults.FaultError):
            _fit(m, x, y, 2, step_retries=1)
        # the give-up path wrote an emergency checkpoint
        assert ckpt.latest_checkpoint(str(tmp_path)) is not None

    def test_hung_step_times_out_and_retries(self):
        x, y = _data(n=64)
        m = _model()
        before = _counter("training_step_retries_total")
        faults.inject("trainer.step",
                      faults.Fault(mode="stall", delay_s=2.0, times=1))
        hist = _fit(m, x, y, 1, step_retries=2, step_timeout_s=0.5)
        assert len(hist["loss"]) == 1
        assert _counter("training_step_retries_total") >= before + 1


# ---------------------------------------------------------------------------
# triggers and validation in a fit, against the JAX fit
# ---------------------------------------------------------------------------
def _names(jm):
    return [l.name for l in jm._ordered_layers()]


def _classifier_pair(optimizer="adam", seed=0):
    """(port, jax) Dense(8, relu) → Dense(3, softmax) classifiers with the
    same weights and given layer names."""
    t = Sequential()
    t.add(L.Dense(8, activation="relu", input_shape=(6,), name="hid",
                  device="cpu"))
    t.add(L.Dense(3, activation="softmax", name="out", device="cpu"))
    t.compile(optimizer, "sparse_categorical_crossentropy", ["accuracy"])
    t.ensure_built(seed=seed)
    j = JSequential()
    j.add(JL.Dense(8, activation="relu", input_shape=(6,), name="hid"))
    j.add(JL.Dense(3, activation="softmax", name="out"))
    j.compile(optimizer, "sparse_categorical_crossentropy", ["accuracy"])
    j.params = convert.model_params_to_jax(t.state_dict(), _names(j), t)
    return t, j


def _class_data(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 6).astype(np.float32)
    return x, (np.abs(x[:, 0] * 2 + x[:, 1]) % 3).astype(np.int32)


JAX_FIT = dict(distributed=False, device_cache=False, prefetch=False)


def test_validation_history_matches_jax():
    x, y = _class_data(96, 1)
    val = _class_data(40, 2)
    t, j = _classifier_pair()
    th = trainer.fit_keras(t, x, y, batch_size=16, epochs=2, seed=3,
                           validation_data=val)
    jh = jtrainer.fit_keras(j, x, y, batch_size=16, epochs=2, seed=3,
                            validation_data=val, **JAX_FIT)
    assert sorted(th) == sorted(jh) == \
        ["loss", "val_sparse_categorical_accuracy"]
    for key in jh:
        assert len(th[key]) == 2
        np.testing.assert_allclose(th[key], jh[key], rtol=0, atol=CROSS_TOL)
    fam = get_registry().get("training_validation_metric")
    assert fam.value(name="sparse_categorical_accuracy") == \
        th["val_sparse_categorical_accuracy"][-1]


def test_estimator_validation_matches_jax():
    x, y = _class_data(96, 4)
    vx, vy = _class_data(40, 5)
    t, j = _classifier_pair("rmsprop", seed=1)
    th = Estimator.from_keras(t, device="cpu").fit(
        {"x": x, "y": y}, epochs=2, batch_size=16,
        validation_data={"x": vx, "y": vy})
    jh = JEstimator.from_keras(j).fit(
        {"x": x, "y": y}, epochs=2, batch_size=16,
        validation_data={"x": vx, "y": vy}, **JAX_FIT)
    assert sorted(th) == sorted(jh)
    for key in jh:
        np.testing.assert_allclose(th[key], jh[key], rtol=0, atol=CROSS_TOL)


def test_iteration_triggers_match_jax(tmp_path):
    """`SeveralIteration(3)` checkpoints mid-epoch, `MaxIteration(5)` ends
    the fit in its second epoch: the same versions, metas and losses as
    the JAX fit."""
    x, y = _class_data(64, 6)
    t, j = _classifier_pair("sgd")
    t.set_checkpoint(str(tmp_path / "port"))
    j.set_checkpoint(str(tmp_path / "jax"))
    th = trainer.fit_keras(t, x, y, batch_size=16, epochs=3, seed=3,
                           checkpoint_trigger=tg.SeveralIteration(3),
                           end_trigger=tg.MaxIteration(5))
    from analytics_zoo_tpu.common import triggers as jtg
    jh = jtrainer.fit_keras(j, x, y, batch_size=16, epochs=3, seed=3,
                            checkpoint_trigger=jtg.SeveralIteration(3),
                            end_trigger=jtg.MaxIteration(5), **JAX_FIT)
    np.testing.assert_allclose(th["loss"], jh["loss"], atol=CROSS_TOL)
    port = ckpt.list_checkpoints(str(tmp_path / "port"))
    ref = jckpt.list_checkpoints(str(tmp_path / "jax"))
    assert [v for _, v in port] == [v for _, v in ref] == [3]
    keys = ("epoch", "iteration", "epoch_finished", "opt_state_layout")
    tmeta = ckpt.read_checkpoint_meta(*port[0])
    jmeta = jckpt.read_checkpoint_meta(*ref[0])
    assert {k: tmeta[k] for k in keys} == {k: jmeta[k] for k in keys}
    assert ckpt.published_intact(*port[0])


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
def _regression_pair(seed=0):
    t = Sequential()
    t.add(L.Dense(8, activation="relu", input_shape=(6,), name="hid",
                  device="cpu"))
    t.add(L.Dense(1, name="out", device="cpu"))
    t.compile("adam", "mse")
    t.ensure_built(seed=seed)
    j = JSequential()
    j.add(JL.Dense(8, activation="relu", input_shape=(6,), name="hid"))
    j.add(JL.Dense(1, name="out"))
    j.compile(optax.adam(1e-3), "mse")
    j.params = convert.model_params_to_jax(t.state_dict(), _names(j), t)
    return t, j


def _as_fused_checkpoint(root):
    """Rewrite the JAX fit's newest checkpoint as a fused fit of the JAX
    package writes it (`FusedAdamState` in place of optax.adam's chain,
    layout "fused"), through the JAX package's own manager."""
    run_dir, version, meta = jckpt.find_resume_checkpoint(str(root))
    params, tree, _ = jckpt.load_checkpoint(run_dir, version)
    count, mu, nu = tree[0]
    mgr = jckpt.CheckpointManager(str(root / "fused"))
    mgr.save(version, params, jopt.FusedAdamState(np.int32(count), mu, nu),
             extra=dict(meta, opt_state_layout="fused"))
    return root / "fused"


@pytest.mark.parametrize("fused", [False, True])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, fused):
    """A JAX fit checkpoints 2 epochs; the port's fit_keras(auto_resume)
    continues it, and its epoch-3 loss is the JAX uninterrupted run's."""
    x, y = _data()
    t, j_full = _regression_pair()
    init = j_full.params
    jh_full = jtrainer.fit_keras(j_full, x, y, batch_size=32, epochs=3,
                                 seed=7, **JAX_FIT)
    _, j_a = _regression_pair()
    j_a.params = init
    j_a.set_checkpoint(str(tmp_path))
    jtrainer.fit_keras(j_a, x, y, batch_size=32, epochs=2, seed=7,
                       **JAX_FIT)
    root = _as_fused_checkpoint(tmp_path) if fused else tmp_path
    t.set_checkpoint(str(root))
    th = trainer.fit_keras(t, x, y, batch_size=32, epochs=3, seed=7,
                           auto_resume=True, fused_optimizer=fused)
    assert len(th["loss"]) == 1
    np.testing.assert_allclose(th["loss"], jh_full["loss"][2:], rtol=0,
                               atol=CROSS_TOL)
    want = convert.model_params_from_jax(jax.device_get(j_full.params),
                                         _names(j_full), t)
    for k, v in t.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                   atol=CROSS_TOL)


PORT_TO_JAX = ["sgd", "rmsprop", "adamax", "adagrad", "adadelta", "adam",
               "adamw", "fused"]


@pytest.mark.parametrize("name", PORT_TO_JAX)
def test_port_checkpoint_restores_in_the_jax_package(tmp_path, name):
    """A port fit checkpoints; the JAX `find_resume_checkpoint` finds it,
    and its optimizer tree pours through the JAX `restore_opt_state` into
    the JAX `optimizer.init` template, leaf for leaf the port's state and
    the JAX fit's own checkpoint of the same training."""
    x, y = _class_data(64, 7)
    spec = "adam" if name == "fused" else name
    t, j = _classifier_pair(spec)
    t.set_checkpoint(str(tmp_path / "port"))
    j.set_checkpoint(str(tmp_path / "jax"))
    trainer.fit_keras(t, x, y, batch_size=16, epochs=1, seed=3,
                      fused_optimizer=name == "fused")
    jtrainer.fit_keras(j, x, y, batch_size=16, epochs=1, seed=3, **JAX_FIT)

    run_dir, version, meta = jckpt.find_resume_checkpoint(
        str(tmp_path / "port"))
    assert version == 4 and meta["epoch"] == 1 and meta["epoch_finished"]
    assert meta["opt_state_layout"] == ("fused" if name == "fused"
                                        else "tree")
    params, tree, _ = jckpt.load_checkpoint(run_dir, version)
    jtx = jopt.fused_adam() if name == "fused" else jopt.get(spec)
    restored = jckpt.restore_opt_state(jtx.init(j.params), tree)
    # leaf for leaf the JAX fit's own checkpoint of the same training
    jrun, jversion, _ = jckpt.find_resume_checkpoint(str(tmp_path / "jax"))
    jparams, jtree, _ = jckpt.load_checkpoint(jrun, jversion)
    want = jtree[0] if name == "fused" else jtree    # optax.adam's chain
    got = restored
    assert len(jax.tree_util.tree_leaves(got)) == len(
        jax.tree_util.tree_leaves(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=MOMENT_RTOL, atol=CROSS_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a, b, atol=CROSS_TOL)
    # the JAX fit resumes the port's checkpoint (its fused layout only
    # where its fused kernel runs, which the installed jax refuses on the
    # CPU)
    if name != "fused":
        _, j2 = _classifier_pair(spec)
        j2.set_checkpoint(str(tmp_path / "port"))
        h = jtrainer.fit_keras(j2, x, y, batch_size=16, epochs=2, seed=3,
                               auto_resume=True, **JAX_FIT)
        assert len(h["loss"]) == 1 and np.isfinite(h["loss"][0])


# ---------------------------------------------------------------------------
# lazy-embedding state
# ---------------------------------------------------------------------------
WND = dict(class_num=3, model_type="wide_n_deep", wide_base_dims=(6, 3),
           wide_cross_dims=(10,), indicator_dims=(4, 3),
           embed_in_dims=(50, 50), embed_out_dims=(8, 6),
           continuous_cols=("age",), hidden_layers=(16, 8))


def _wnd_data(n, seed):
    rs = np.random.RandomState(seed)
    x = [(rs.rand(n, 19) < 0.2).astype(np.float32),
         (rs.rand(n, 7) < 0.3).astype(np.float32),
         rs.randint(1, 51, (n, 2)).astype(np.int32),
         rs.standard_normal((n, 1)).astype(np.float32)]
    return x, rs.randint(0, 3, n).astype(np.int32)


def _wnd(seed=0):
    m = WideAndDeep(device="cpu", **WND)
    m.model.ensure_built(seed=seed)
    m.compile("adam", "sparse_categorical_crossentropy")
    return m


@pytest.mark.parametrize("fused", [False, True])
def test_zoo_model_set_checkpoint_resumes_bitwise(tmp_path, fused):
    """`ZooModel.set_checkpoint` (WideAndDeep): a fault mid-epoch 3, then a
    fresh instance resumes from the epoch-2 boundary, bitwise."""
    x, y = _wnd_data(64, 8)
    kw = dict(batch_size=16, seed=5, fused_optimizer=fused)
    full = _wnd()
    h_full = full.fit(x, y, nb_epoch=3, **kw)
    m_a = _wnd()
    m_a.set_checkpoint(str(tmp_path))
    faults.inject("trainer.step",
                  faults.Fault(exc=RuntimeError("lost the card"),
                               match=lambda c: c.get("iteration", 0) >= 10))
    with pytest.raises(RuntimeError, match="lost the card"):
        m_a.fit(x, y, nb_epoch=3, **kw)
    faults.clear("trainer.step")
    m_b = _wnd()
    m_b.set_checkpoint(str(tmp_path))
    h = m_b.fit(x, y, nb_epoch=3, auto_resume=True, **kw)
    assert h["loss"] == h_full["loss"][2:]
    for a, b in zip(m_b.model.state_dict().values(),
                    full.model.state_dict().values()):
        assert torch.equal(a, b)


NCF = dict(user_count=30, item_count=20, class_num=2, user_embed=8,
           item_embed=8, mf_embed=8, hidden_layers=(16, 8))


def _ncf_data(n, seed):
    rs = np.random.RandomState(seed)
    x = np.stack([rs.randint(1, 31, n), rs.randint(1, 21, n)],
                 axis=1).astype(np.int32)
    return x, rs.randint(0, 2, n).astype(np.int32)


def _ncf():
    from analytics_zoo_tpu_torch.models import NeuralCF
    m = NeuralCF(device="cpu", **NCF)
    m.model.ensure_built(seed=0)
    m.compile("adam", "sparse_categorical_crossentropy")
    return m


@pytest.mark.parametrize("fused", [False, True])
def test_lazy_embedding_checkpoint(tmp_path, fused):
    """`lazy_embeddings=True` (NeuralCF's four tables): the resumed fit is
    bitwise the uninterrupted one, and the optimizer artifact pours into
    the JAX package's lazy-embedding state (`init_state` over optax.adam
    or its fused Adam, None at the tables) by leaf order."""
    from analytics_zoo_tpu.learn import lazy_embedding as jlazy
    from analytics_zoo_tpu.models import recommendation as jrec
    x, y = _ncf_data(64, 9)
    kw = dict(batch_size=16, seed=5, fused_optimizer=fused,
              lazy_embeddings=True)
    h_full = _ncf().fit(x, y, nb_epoch=3, **kw)
    m_a = _ncf()
    m_a.set_checkpoint(str(tmp_path))
    m_a.fit(x, y, nb_epoch=2, **kw)
    m_b = _ncf()
    m_b.set_checkpoint(str(tmp_path))
    assert m_b.fit(x, y, nb_epoch=3, auto_resume=True,
                   **kw)["loss"] == h_full["loss"][2:]

    _, version, meta = jckpt.find_resume_checkpoint(str(tmp_path))
    assert meta["opt_state_layout"] == ("fused" if fused else "tree")
    params, tree, _ = jckpt.load_checkpoint(str(tmp_path), version)
    j = jrec.NeuralCF(**NCF)
    j.compile("adam", "sparse_categorical_crossentropy")
    j.model.params = convert.model_params_to_jax(
        m_b.model.state_dict(), [l.name for l in j.model._ordered_layers()],
        m_b.model)
    specs = jlazy.resolve_specs(j.model)
    rest_opt = jopt.fused_adam() if fused else optax.adam(1e-3)
    template = jlazy.init_state(j.model.params, specs, rest_opt)
    restored = jckpt.restore_opt_state(template, tree)
    assert int(restored["t"]) == version
    assert set(restored["tables"]) == set(template["tables"])
    assert len(jax.tree_util.tree_leaves(restored)) == len(
        jax.tree_util.tree_leaves(template))


# ---------------------------------------------------------------------------
# the Estimator
# ---------------------------------------------------------------------------
def test_estimator_model_dir_retries_from_the_latest_checkpoint(tmp_path):
    """A fault mid-epoch 2: the Estimator reloads the newest checkpoint's
    parameters (the emergency one, as the JAX package does) and trains
    the epochs left; the retry is counted."""
    x, y = _data()
    m = _model("adam")
    est = Estimator(m, model_dir=str(tmp_path), device="cpu")
    before = _counter("training_retries_total")
    faults.inject("trainer.step",
                  faults.Fault(exc=RuntimeError("flaky"), times=1,
                               match=lambda c: c.get("iteration", 0) == 6))
    hist = est.fit({"x": x, "y": y}, epochs=3, batch_size=32, seed=7)
    assert _counter("training_retries_total") == before + 1
    # the failed attempt adds nothing to the history; the emergency
    # checkpoint (iteration 5, meta epoch 1) sets 3 - 1 epochs left
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
    assert m._checkpoint_path == str(tmp_path)
    assert ckpt.latest_checkpoint(str(tmp_path)) is not None


def test_estimator_gives_up_after_the_retry_budget(tmp_path):
    x, y = _data()
    est = Estimator(_model(), model_dir=str(tmp_path), device="cpu",
                    failure=FailureConfig(retry_times=1,
                                          retry_time_interval_s=60))
    faults.inject("trainer.step",
                  faults.Fault(exc=RuntimeError("dead"),
                               match=lambda c: c.get("iteration", 0) >= 2))
    with pytest.raises(RuntimeError, match="dead"):
        est.fit({"x": x, "y": y}, epochs=2, batch_size=32)
    faults.clear("trainer.step")
    # a configuration error is not retried
    with pytest.raises(ValueError):
        est.fit({"x": x[:8], "y": y[:8]}, epochs=1, batch_size=32)


def test_estimator_surface(tmp_path):
    """predict, evaluate, save/load, get_model and load_orca_checkpoint."""
    x, y = _class_data(64, 10)
    t, _ = _classifier_pair("adagrad")
    est = Estimator.from_keras(t, model_dir=str(tmp_path / "ckpt"),
                               device="cpu")
    est.fit({"x": x, "y": y}, epochs=2, batch_size=16)
    assert est.get_model() is t
    pred = est.predict({"x": x}, batch_per_thread=24)
    assert pred.shape == (64, 3)
    ev = est.evaluate({"x": x, "y": y}, batch_per_thread=24)
    ev_acc = est.evaluate((x, y), metrics=["accuracy"])
    assert sorted(ev) == ["sparse_categorical_accuracy"]
    assert list(ev_acc.values()) == list(ev.values())
    ev8 = est.evaluate((x, y), quantize="int8")
    assert sorted(ev8) == ["baseline_sparse_categorical_accuracy",
                           "sparse_categorical_accuracy"]
    assert ev8["baseline_sparse_categorical_accuracy"] == list(
        ev.values())[0]
    est.save(str(tmp_path / "w"))
    other, _ = _classifier_pair("adagrad", seed=9)
    Estimator(other, device="cpu").load(str(tmp_path / "w"))
    np.testing.assert_array_equal(other.predict(x), pred)
    # load_orca_checkpoint: the epoch-1 checkpoint's parameters, then the
    # one epoch left
    third, _ = _classifier_pair("adagrad", seed=11)
    e3 = Estimator(third, device="cpu").load_orca_checkpoint(
        str(tmp_path / "ckpt"), version=4)
    h = e3.fit({"x": x, "y": y}, epochs=2, batch_size=16)
    assert len(h["loss"]) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
def test_text_classifier_adagrad_checkpointed_fit_on_gpu(tmp_path):
    """Path A, small: an lstm TextClassifier compiled with "adagrad" under
    a checkpointed Estimator, bf16; the dropout kernel launches twice a
    step, validation runs every epoch, the directory resumes."""
    from analytics_zoo_tpu_torch.kernels import LAUNCHES
    from analytics_zoo_tpu_torch.kernels import dropout as dr
    from analytics_zoo_tpu_torch.models import TextClassifier
    _need_gpu()
    rs = np.random.RandomState(12)
    clf = TextClassifier(4, embedding_dim=8, vocab_size=20,
                         sequence_length=8, encoder="lstm",
                         encoder_output_dim=12,
                         embedding_weights=rs.rand(20, 8).astype(np.float32))
    clf.compile("adagrad", "sparse_categorical_crossentropy", ["accuracy"])
    x = rs.randint(0, 20, (64, 8)).astype(np.int32)
    y = rs.randint(0, 4, 64).astype(np.int32)
    est = Estimator.from_keras(clf.model, model_dir=str(tmp_path))
    LAUNCHES.reset()
    h = est.fit({"x": x, "y": y}, epochs=2, batch_size=16,
                validation_data={"x": x[:32], "y": y[:32]},
                mixed_precision=True)
    assert LAUNCHES.snapshot().get(dr.KERNEL_NAME, 0) == 2 * 8
    assert len(h["val_sparse_categorical_accuracy"]) == 2
    assert ckpt.find_resume_checkpoint(str(tmp_path))[1] == 8


@pytest.mark.gpu
def test_wide_and_deep_fused_resume_on_gpu(tmp_path):
    """Path B, small: a fused-Adam WideAndDeep fit killed in epoch 3
    resumes bitwise from the epoch-2 boundary, one fused-Adam launch a
    step; the uninterrupted fit runs each step on the watchdog's thread
    (on the caller's device and stream) and still matches bitwise."""
    from analytics_zoo_tpu_torch.kernels import LAUNCHES
    from analytics_zoo_tpu_torch.kernels import fused_adam as fad
    _need_gpu()
    x, y = _wnd_data(64, 13)
    kw = dict(batch_size=16, seed=5, fused_optimizer=True)

    def wnd():
        m = WideAndDeep(**WND)
        m.model.ensure_built(seed=0)
        m.compile("adam", "sparse_categorical_crossentropy")
        return m
    full = wnd()
    LAUNCHES.reset()
    h_full = full.fit(x, y, nb_epoch=3, step_timeout_s=120.0, **kw)
    assert LAUNCHES.snapshot().get(fad.KERNEL_NAME, 0) == 12
    m_a = wnd()
    m_a.set_checkpoint(str(tmp_path))
    faults.inject("trainer.step",
                  faults.Fault(exc=RuntimeError("lost the card"),
                               match=lambda c: c.get("iteration", 0) >= 10))
    with pytest.raises(RuntimeError):
        m_a.fit(x, y, nb_epoch=3, **kw)
    faults.clear("trainer.step")
    m_b = wnd()
    m_b.set_checkpoint(str(tmp_path))
    assert m_b.fit(x, y, nb_epoch=3, auto_resume=True,
                   **kw)["loss"] == h_full["loss"][2:]
    for a, b in zip(m_b.model.state_dict().values(),
                    full.model.state_dict().values()):
        assert torch.equal(a, b)
