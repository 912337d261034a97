"""Versioned rollout in the port (`serving/rollout.py`), each case run on
both packages through the `m` fixture: the engine's `EngineRolloutAgent`
(directive → drain → swap → canary → heartbeat report, or restore and
veto), the gateway's tick-driven `RolloutController` (engine by engine,
fleet-wide quarantine, stragglers, pins), the `/rollout` routes and an
in-process two-engine fleet that converges with traffic flowing. Held to
the cases of the JAX package's tests/test_rollout.py
(`TestEngineRolloutAgent`, `TestRolloutController`, `TestRolloutHTTP`,
`TestEndToEndRollout`); `TestRolloutConfig` is in
`test_torch_serving_cli.py`. The model is ``x * w`` with the scalar `w`
in a ``{"w": ...}`` tree, which is its state dict in both packages. The
JAX package's "zero XLA compiles" for a same-structure swap is, in the
port, zero kernel builds and the same warmed buckets.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from analytics_zoo_tpu.models.bert import BERTClassifier as JClassifier
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from torch_cluster_serving_impls import (  # noqa: F401 (fixtures)
    RESULT_KEY, STREAM, m, no_stray_threads, wait_for)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    from torch_cluster_serving_impls import IMPLS
    yield
    for pkg in IMPLS.values():
        pkg.faults.clear()


def _publish(m, mgr, version, scale):
    mgr.save(version, {"w": np.asarray(scale, np.float32)})
    m.checkpoint.write_publish_marker(mgr.run_dir, version)
    return mgr.run_dir


def _scale_engine(m, broker, engine_id, scale=2.0, version=1, warm=True,
                  **kw):
    im = m.scale_model(scale)
    if warm:
        im.warmup(np.full(3, 1.0, np.float32), buckets=[1, 2, 4, 8])
    kw.setdefault("batch_size", 8)
    kw.setdefault("batch_timeout_ms", 2)
    kw.setdefault("heartbeat_interval_s", 0.05)
    return m.server.ClusterServing(im, broker=broker, engine_id=engine_id,
                                   registry=m.registry.MetricsRegistry(),
                                   model_version=version, **kw)


def _wait_results(broker, n, timeout_s=30.0):
    wait_for(lambda: broker.hlen(RESULT_KEY) >= n, timeout_s=timeout_s,
             interval=0.01, msg=f"{n} results")
    return broker.hgetall(RESULT_KEY)


def _value(m, raw):
    return m.broker.decode_ndarray(json.loads(raw))


def _beat(m, broker, eid, version, ready=True):
    broker.hset(m.fleet.engines_key(STREAM), eid, json.dumps(
        {"engine_id": eid, "ts": time.time(), "ready": ready,
         "model_version": version}))


def _tracker(m, broker):
    return m.fleet.FleetTracker(broker, STREAM, ttl_s=30.0,
                                registry=m.registry.MetricsRegistry(),
                                poll_min_interval_s=0.0)


def _ckpt(m, tmp_path):
    return m.checkpoint.CheckpointManager(str(tmp_path), keep=10)


# ---------------------------------------------------------------------------
# TestEngineRolloutAgent
# ---------------------------------------------------------------------------
def _engine_with_traffic(m, broker):
    s = _scale_engine(m, broker, "e1", scale=2.0, version=1,
                      supervise=False).start()
    inq = m.client.InputQueue(broker)
    for i in range(4):
        inq.enqueue(uri=f"warm{i}", t=np.full(3, 1.0, np.float32))
    _wait_results(broker, 4)
    return s


def _agent(m, s, broker, **kw):
    kw.setdefault("poll_interval_s", 0.05)
    kw.setdefault("drain_timeout_s", 5.0)
    return m.rollout.EngineRolloutAgent(
        s, broker, registry=m.registry.MetricsRegistry(), **kw)


def _direct(m, broker, version, run_dir, target="e1"):
    broker.hset(m.rollout.rollout_key(STREAM), "directive", json.dumps(
        {"version": version, "run_dir": run_dir, "target": target}))


def test_directive_swaps_canaries_and_reports(m, tmp_path):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    run_dir = _publish(m, mgr, 2, 3.0)
    s = _engine_with_traffic(m, broker)
    try:
        agent = _agent(m, s, broker)
        _direct(m, broker, 2, run_dir)
        assert agent.poll_once() == "swapped"
        assert s.model_version == 2
        assert agent.last_swap["mode"] == "same"
        assert agent.last_swap["swap_executables_delta"] == 0
        if m.name == "port":
            assert agent.last_swap["warmed_buckets_kept"] is True
        assert s._heartbeat_payload()["model_version"] == 2
        m.client.InputQueue(broker).enqueue(
            uri="post", t=np.full(3, 1.0, np.float32))
        res = _wait_results(broker, 5)
        np.testing.assert_allclose(_value(m, res["post"]), 3.0)
    finally:
        s.stop()


def test_directive_for_other_engine_ignored(m, tmp_path):
    broker = m.broker.MemoryBroker()
    run_dir = _publish(m, _ckpt(m, tmp_path), 2, 3.0)
    s = _scale_engine(m, broker, "e1", supervise=False)
    try:
        agent = _agent(m, s, broker)
        _direct(m, broker, 2, run_dir, target="other")
        assert agent.poll_once() is None
        assert s.model_version == 1
    finally:
        s.stop()


def test_failed_canary_rolls_back_and_vetoes(m, tmp_path):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    run_dir = _publish(m, mgr, 3, float("nan"))   # poisoned version
    s = _engine_with_traffic(m, broker)
    try:
        agent = _agent(m, s, broker)
        _direct(m, broker, 3, run_dir)
        assert agent.poll_once() == "vetoed"
        assert s.model_version == 1
        veto = json.loads(broker.hget(m.rollout.rollout_key(STREAM),
                                      "veto:e1"))
        assert veto["version"] == 3 and "finite" in veto["reason"]
        m.client.InputQueue(broker).enqueue(
            uri="after", t=np.full(3, 1.0, np.float32))
        res = _wait_results(broker, 5)
        np.testing.assert_allclose(_value(m, res["after"]), 2.0)
        assert agent.poll_once() is None
    finally:
        s.stop()


def test_golden_delta_gate_and_unpublished_load(m, tmp_path):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    run_dir = _publish(m, mgr, 2, 200.0)     # finite but wildly off
    mgr.save(4, {"w": np.asarray(3.0, np.float32)})   # NOT published
    s = _engine_with_traffic(m, broker)
    try:
        agent = _agent(m, s, broker, golden_tolerance=0.5)
        _direct(m, broker, 2, run_dir)
        assert agent.poll_once() == "vetoed"
        assert "golden-output delta" in agent.last_swap["reason"]
        assert s.model_version == 1
        _direct(m, broker, 4, mgr.run_dir)
        assert agent.poll_once() == "vetoed"
        assert "load failed" in agent.last_swap["reason"]
    finally:
        s.stop()


def test_canary_skips_pre_quarantined_replicas(m):
    im = m.inference_model
    if m.name == "jax":
        model = im.InferenceModel(num_replicas=2,
                                  devices=jax.devices()[:2]).load_fn(
            lambda p, x: x * p["w"], {"w": np.asarray(2.0, np.float32)})
    else:
        from torch_cluster_serving_impls import _Scale
        model = im.InferenceModel(num_replicas=2,
                                  devices=["cpu", "cpu"]).load_torch(
            _Scale(2.0))
    try:
        x = np.full((2, 3), 1.0, np.float32)
        model.predict(x)                      # golden traffic
        assert model.quarantine_replica(1)
        broker = m.broker.MemoryBroker()
        s = m.server.ClusterServing(model, broker=broker, engine_id="e1",
                                    registry=m.registry.MetricsRegistry(),
                                    supervise=False)
        agent = _agent(m, s, broker)
        old = agent._out_leaves(model.predict(x))
        ok, reason = agent._canary(model, x, old)
        assert ok, reason
    finally:
        model.close()


def test_swap_exception_vetoes_and_restores(m, tmp_path, monkeypatch):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    run_dir = _publish(m, mgr, 2, 3.0)
    s = _engine_with_traffic(m, broker)
    try:
        agent = _agent(m, s, broker)
        orig = s.model.swap_params
        calls = {"n": 0}

        def exploding(params):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("device OOM mid-transfer")
            return orig(params)

        monkeypatch.setattr(s.model, "swap_params", exploding)
        _direct(m, broker, 2, run_dir)
        assert agent.poll_once() == "vetoed"
        assert "swap raised" in agent.last_swap["reason"]
        assert s.model_version == 1
        veto = json.loads(broker.hget(m.rollout.rollout_key(STREAM),
                                      "veto:e1"))
        assert veto["version"] == 2
        m.client.InputQueue(broker).enqueue(
            uri="post-oops", t=np.full(3, 1.0, np.float32))
        res = _wait_results(broker, 5)
        np.testing.assert_allclose(_value(m, res["post-oops"]), 2.0)
    finally:
        s.stop()


def test_quarantined_version_never_applied(m, tmp_path):
    broker = m.broker.MemoryBroker()
    run_dir = _publish(m, _ckpt(m, tmp_path), 2, 3.0)
    broker.hset(m.rollout.rollout_key(STREAM), "quarantine",
                json.dumps({"2": "poisoned elsewhere"}))
    s = _scale_engine(m, broker, "e1", supervise=False)
    try:
        agent = _agent(m, s, broker)
        _direct(m, broker, 2, run_dir)
        assert agent.poll_once() is None
        assert s.model_version == 1
    finally:
        s.stop()


def test_port_default_loader_maps_a_bert_checkpoint(tmp_path):
    """The port's default loader turns a checkpoint's JAX-layout tree into
    the served net's state dict (`convert.state_from_jax`); the JAX
    package's swap takes the tree itself."""
    from analytics_zoo_tpu_torch.learn import checkpoint as tckpt
    from analytics_zoo_tpu_torch.serving.rollout import \
        default_params_loader
    cfg = dict(vocab=30, hidden_size=16, n_block=1, n_head=2, seq_len=4,
               intermediate_size=32)
    params = jax.device_get(
        JClassifier(2, **cfg).build(jax.random.PRNGKey(1)))
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, params)
    net = BERTClassifier(2, device="cpu", **cfg)
    state = default_params_loader(mgr.run_dir, 1, net)
    want = convert.params_from_jax(params)
    assert set(state) == set(want) == set(net.state_dict())
    for k in want:
        np.testing.assert_array_equal(np.asarray(state[k]),
                                      np.asarray(want[k]))
    flat = {"w": np.asarray(2.0, np.float32)}
    mgr.save(2, flat)
    assert set(default_params_loader(mgr.run_dir, 2)) == {"w"}


# ---------------------------------------------------------------------------
# TestRolloutController (tick-driven)
# ---------------------------------------------------------------------------
def _controller(m, broker, root, tracker, **kw):
    kw.setdefault("poll_interval_s", 0.5)
    kw.setdefault("engine_timeout_s", 30.0)
    return m.rollout.RolloutController(broker, STREAM, root, tracker,
                                       registry=m.registry.MetricsRegistry(),
                                       **kw)


def _directive(m, broker):
    raw = broker.hget(m.rollout.rollout_key(STREAM), "directive")
    return json.loads(raw) if raw else None


def test_engine_by_engine_convergence(m, tmp_path):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    _publish(m, mgr, 2, 3.0)
    _beat(m, broker, "e0", 1)
    _beat(m, broker, "e1", 1)
    ctrl = _controller(m, broker, str(tmp_path), _tracker(m, broker))
    assert ctrl.tick(now=0.0) == "direct"
    assert ctrl.state == "rolling"
    d = _directive(m, broker)
    assert d["target"] == "e0" and d["version"] == 2
    assert ctrl.tick(now=1.0) is None
    _beat(m, broker, "e0", 2)
    assert ctrl.tick(now=2.0) == "direct"
    assert _directive(m, broker)["target"] == "e1"
    _beat(m, broker, "e1", 2)
    assert ctrl.tick(now=3.0) == "converged"
    assert ctrl.state == "idle" and ctrl.active_version == 2
    assert _directive(m, broker) is None


def test_veto_quarantines_fleet_wide_and_rolls_back(m, tmp_path):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    _publish(m, mgr, 2, 3.0)
    _beat(m, broker, "e0", 2)
    _beat(m, broker, "e1", 1)
    ctrl = _controller(m, broker, str(tmp_path), _tracker(m, broker))
    assert ctrl.tick(now=0.0) == "direct"
    assert _directive(m, broker)["target"] == "e1"
    broker.hset(m.rollout.rollout_key(STREAM), "veto:e1", json.dumps(
        {"version": 2, "reason": "canary output is not finite",
         "engine_id": "e1"}))
    ctrl.tick(now=1.0)
    assert "2" in ctrl.quarantined
    q = json.loads(broker.hget(m.rollout.rollout_key(STREAM),
                               "quarantine"))
    assert "2" in q
    ctrl.tick(now=2.0)
    assert ctrl.state == "rolled_back"
    d = _directive(m, broker)
    assert d["target"] == "e0" and d["version"] == 1
    _beat(m, broker, "e0", 1)
    assert ctrl.tick(now=3.0) == "converged"
    assert ctrl.state == "idle" and ctrl.active_version == 1
    assert not ctrl.rolling_back


def test_quarantine_survives_restart_and_dead_engine_skipped(m, tmp_path):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    _publish(m, mgr, 2, 3.0)
    broker.hset(m.rollout.rollout_key(STREAM), "quarantine",
                json.dumps({"2": "poisoned"}))
    _beat(m, broker, "e0", 1)
    ctrl = _controller(m, broker, str(tmp_path), _tracker(m, broker))
    assert "2" in ctrl.quarantined
    assert ctrl.tick(now=0.0) is None
    assert ctrl.state == "idle" and ctrl.active_version == 1
    # a dead engine mid-campaign is skipped
    broker = m.broker.MemoryBroker()
    _publish(m, mgr, 3, 4.0)
    _beat(m, broker, "e0", 1)
    _beat(m, broker, "e1", 1)
    ctrl = _controller(m, broker, str(tmp_path), _tracker(m, broker))
    ctrl.tick(now=0.0)
    assert _directive(m, broker)["target"] == "e0"
    broker.hdel(m.fleet.engines_key(STREAM), "e0")
    assert ctrl.tick(now=1.0) == "direct"
    assert _directive(m, broker)["target"] == "e1"
    _beat(m, broker, "e1", 3)
    assert ctrl.tick(now=2.0) == "converged"
    assert ctrl.active_version == 3


def test_wedged_engine_skipped_not_quarantined(m, tmp_path):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    _publish(m, mgr, 2, 3.0)
    _beat(m, broker, "e0", 1)
    _beat(m, broker, "e1", 1)
    ctrl = _controller(m, broker, str(tmp_path), _tracker(m, broker),
                       engine_timeout_s=5.0)
    ctrl.tick(now=0.0)
    assert _directive(m, broker)["target"] == "e0"
    _beat(m, broker, "e0", 1)
    assert ctrl.tick(now=6.0) == "direct"
    assert _directive(m, broker)["target"] == "e1"
    assert "2" not in ctrl.quarantined
    _beat(m, broker, "e1", 2)
    assert ctrl.tick(now=7.0) == "partial"
    assert ctrl.status()["stragglers"] == {"e0": 2}
    assert ctrl.tick(now=8.0) is None
    _publish(m, mgr, 3, 4.0)
    assert ctrl.tick(now=9.0) == "direct"
    d = _directive(m, broker)
    assert d["version"] == 3 and d["target"] == "e0"


def test_engine_scope_veto_skips_engine_not_version(m, tmp_path):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    _publish(m, mgr, 2, 3.0)
    _beat(m, broker, "e0", 1)
    _beat(m, broker, "e1", 1)
    ctrl = _controller(m, broker, str(tmp_path), _tracker(m, broker))
    ctrl.tick(now=0.0)
    assert _directive(m, broker)["target"] == "e0"
    broker.hset(m.rollout.rollout_key(STREAM), "veto:e0", json.dumps(
        {"version": 2, "scope": "engine", "engine_id": "e0",
         "reason": "load failed: FileNotFoundError"}))
    assert ctrl.tick(now=1.0) == "direct"
    assert _directive(m, broker)["target"] == "e1"
    assert "2" not in ctrl.quarantined
    assert ctrl.status()["stragglers"] == {"e0": 2}
    _beat(m, broker, "e1", 2)
    assert ctrl.tick(now=2.0) == "partial"


def test_pins_release_keep_and_resume(m, tmp_path, monkeypatch):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    _publish(m, mgr, 2, 3.0)
    _beat(m, broker, "e0", 1)
    ctrl = _controller(m, broker, str(tmp_path), _tracker(m, broker))
    ctrl.request(2)
    assert _directive(m, broker)["version"] == 2
    broker.hset(m.rollout.rollout_key(STREAM), "veto:e0", json.dumps(
        {"version": 2, "reason": "canary output is not finite",
         "engine_id": "e0"}))
    ctrl.tick(now=1.0)
    assert "2" in ctrl.quarantined
    ctrl.tick(now=2.0)
    assert ctrl.force_version is None
    assert ctrl.tick(now=3.0) is None
    assert ctrl.active_version == 1
    # a transient resolution error keeps a pin
    ctrl.request(1)
    assert ctrl.force_version == 1
    monkeypatch.setattr(m.checkpoint, "resolve_checkpoint",
                        lambda *a, **k: (_ for _ in ()).throw(
                            OSError("nfs blip")))
    assert ctrl.tick(now=4.0) is None
    assert ctrl.force_version == 1


def test_mixed_fleet_resumes_and_request_pins(m, tmp_path):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    _publish(m, mgr, 2, 3.0)
    _beat(m, broker, "e0", 2)
    _beat(m, broker, "e1", 1)
    _beat(m, broker, "e2", 1)
    ctrl = _controller(m, broker, str(tmp_path), _tracker(m, broker))
    assert ctrl.tick(now=0.0) == "direct"
    assert "e0" in ctrl.converted
    assert _directive(m, broker)["target"] == "e1"
    broker = m.broker.MemoryBroker()
    _beat(m, broker, "e0", 2)
    ctrl = _controller(m, broker, str(tmp_path), _tracker(m, broker))
    status = ctrl.request(1)
    assert status["state"] == "rolling" and status["pinned_version"] == 1
    assert _directive(m, broker)["version"] == 1
    _beat(m, broker, "e0", 1)
    assert ctrl.tick(now=1.0) == "converged"
    assert ctrl.tick(now=2.0) is None
    assert ctrl.force_version == 1 and ctrl.active_version == 1
    ctrl.request(unpin=True)
    assert ctrl.state == "rolling"
    assert _directive(m, broker)["version"] == 2
    with pytest.raises(FileNotFoundError):
        ctrl.request(99)
    ctrl.quarantined["1"] = "testing"
    with pytest.raises(ValueError):
        ctrl.request(1)


def test_state_metrics(m, tmp_path):
    reg = m.registry.MetricsRegistry()
    broker = m.broker.MemoryBroker()
    _publish(m, _ckpt(m, tmp_path), 2, 3.0)
    _beat(m, broker, "e0", 1)
    ctrl = m.rollout.RolloutController(broker, STREAM, str(tmp_path),
                                       _tracker(m, broker), registry=reg)
    assert reg.get("serving_rollout_state").value() == 0.0
    ctrl.tick(now=0.0)
    assert reg.get("serving_rollout_state").value() == 1.0
    _beat(m, broker, "e0", 2)
    ctrl.tick(now=1.0)
    assert reg.get("serving_rollout_state").value() == 0.0
    assert reg.get("serving_rollout_transitions_total").value(
        state="converged", version="2") == 1.0


# ---------------------------------------------------------------------------
# TestRolloutHTTP
# ---------------------------------------------------------------------------
def _http(url, body=None):
    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_rollout_routes_404_unconfigured_and_gateway_roundtrip(m,
                                                               tmp_path):
    fe = m.http_frontend.FrontEnd(m.broker.MemoryBroker(), None,
                                  host="127.0.0.1", port=0,
                                  registry=m.registry.MetricsRegistry()
                                  ).start()
    try:
        base = f"http://127.0.0.1:{fe.port}"
        assert _http(f"{base}/rollout/status")[0] == 404
        assert _http(f"{base}/rollout", b"")[0] == 404
    finally:
        fe.stop()
    broker = m.broker.MemoryBroker()
    _publish(m, _ckpt(m, tmp_path), 1, 2.0)
    _beat(m, broker, "e0", 1)
    fe = m.http_frontend.FrontEnd(broker, None, host="127.0.0.1", port=0,
                                  fleet_stream=STREAM,
                                  registry=m.registry.MetricsRegistry()
                                  ).start()
    ctrl = m.rollout.RolloutController(broker, STREAM, str(tmp_path),
                                       fe.fleet,
                                       registry=m.registry.MetricsRegistry())
    fe.set_rollout(ctrl)
    try:
        base = f"http://127.0.0.1:{fe.port}"
        code, status = _http(f"{base}/rollout/status")
        assert code == 200 and status["state"] == "idle"
        assert _http(f"{base}/rollout",
                     json.dumps({"version": 42}).encode())[0] == 404
        ctrl.quarantined["1"] = "bad"
        assert _http(f"{base}/rollout",
                     json.dumps({"version": 1}).encode())[0] == 409
        ctrl.quarantined.clear()
        assert _http(f"{base}/rollout",
                     json.dumps({"version": 1}).encode())[0] == 202
        code, h = _http(f"{base}/healthz")
        assert h["fleet"]["model_versions"] == [1]
    finally:
        fe.stop()


def test_engine_healthz_carries_version(m):
    broker = m.broker.MemoryBroker()
    s = _scale_engine(m, broker, "e1", version=5, warm=False,
                      supervise=False).start()
    fe = m.http_frontend.FrontEnd(broker, s, host="127.0.0.1", port=0,
                                  registry=m.registry.MetricsRegistry()
                                  ).start()
    try:
        code, h = _http(f"http://127.0.0.1:{fe.port}/healthz")
        assert code == 200 and h["model_version"] == 5
    finally:
        fe.stop()
        s.stop()


# ---------------------------------------------------------------------------
# TestEndToEndRollout
# ---------------------------------------------------------------------------
def _no_compile_marker(m, engines):
    """What a same-structure rollout must leave unchanged: the JAX
    package's executable counts; the port's kernel builds and warmed
    buckets."""
    if m.name == "jax":
        return [s.model.compile_cache_size() for s in engines]
    from analytics_zoo_tpu_torch.kernels import _build
    return (_build.build_events()["compiles"],
            [sorted(s.model.warmed_buckets) for s in engines])


def test_fleet_converges_with_traffic_flowing(m, tmp_path):
    broker = m.broker.MemoryBroker()
    mgr = _ckpt(m, tmp_path)
    _publish(m, mgr, 1, 2.0)
    engines, agents = [], []
    for i in range(2):
        s = _scale_engine(m, broker, f"e{i}", scale=2.0, version=1,
                          supervise=False).start()
        engines.append(s)
        agents.append(m.rollout.EngineRolloutAgent(
            s, broker, poll_interval_s=0.05, drain_timeout_s=5.0,
            registry=m.registry.MetricsRegistry()).start())
    tracker = _tracker(m, broker)
    ctrl = m.rollout.RolloutController(
        broker, STREAM, str(tmp_path), tracker, poll_interval_s=0.05,
        engine_timeout_s=60.0,
        registry=m.registry.MetricsRegistry()).start()
    inq = m.client.InputQueue(broker)
    accepted = []
    feeding = threading.Event()
    feeding.set()

    def feeder():
        i = 0
        while feeding.is_set():
            uri = f"r{i}"
            inq.enqueue(uri=uri, t=np.full(3, 1.0, np.float32))
            accepted.append(uri)
            i += 1
            time.sleep(0.005)

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    try:
        wait_for(lambda: broker.hlen(RESULT_KEY) >= 8,
                 msg="pre-rollout traffic")
        marker0 = _no_compile_marker(m, engines)
        _publish(m, mgr, 2, 3.0)
        wait_for(lambda: all(s.model_version == 2 for s in engines),
                 timeout_s=30.0, msg="fleet convergence on v2")
        wait_for(lambda: ctrl.status()["active_version"] == 2,
                 timeout_s=30.0, msg="controller active_version")
        assert _no_compile_marker(m, engines) == marker0
        _publish(m, mgr, 3, float("nan"))
        wait_for(lambda: "3" in ctrl.status()["quarantined"],
                 timeout_s=30.0, msg="fleet-wide quarantine of v3")
        wait_for(lambda: all(s.model_version == 2 for s in engines),
                 timeout_s=30.0, msg="engines back on v2")
        time.sleep(0.2)
    finally:
        feeding.clear()
        t.join(timeout=10)
        total = len(accepted)
        try:
            res = _wait_results(broker, total, timeout_s=60.0)
        finally:
            ctrl.stop()
            for a in agents:
                a.stop()
            for s in engines:
                s.stop()
    missing = [u for u in accepted if u not in res]
    assert not missing, f"{len(missing)} records lost"
    bad = []
    for uri in accepted:
        vals = np.asarray(_value(m, res[uri]))
        if not np.all(np.isfinite(vals)):
            bad.append((uri, "NaN"))
        elif not (np.allclose(vals, 2.0) or np.allclose(vals, 3.0)):
            bad.append((uri, vals.tolist()))
    assert not bad, f"bad results: {bad[:5]}"
