"""The fleet plane of the port: heartbeats and fleet tracking
(`serving/fleet.py`), fleet metrics (`serving/fleet_metrics.py`), the
trace plane (`serving/trace_plane.py`) and device-memory telemetry
(`observability/memwatch.py`), each case run on both packages through the
`m` fixture. Held to the cases of the JAX package's own tests:
tests/test_serving_fleet.py (`TestFleetGateway`, `TestFleetObservability`),
tests/test_trace_plane.py (all of it), tests/test_rollout.py
(`TestHeartbeatLastKnownGood`) and tests/test_profiling_slo.py
(`TestDeviceMemory`, on each package's own device arrays). The fleet's
config knobs are in `test_torch_serving_cli.py`.
"""

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from torch_cluster_serving_impls import (  # noqa: F401 (fixtures)
    IMPLS, RESULT_KEY, STREAM, m, no_stray_threads, wait_for)


def _identity_engine(m, broker, engine_id=None, registry=None, **kw):
    kw.setdefault("batch_size", 8)
    kw.setdefault("batch_timeout_ms", 2)
    return m.server.ClusterServing(
        m.fn_model("double"), broker=broker, engine_id=engine_id,
        registry=registry or m.registry.MetricsRegistry(), **kw)


def _wait_results(broker, n, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        res = broker.hgetall(RESULT_KEY)
        if len(res) >= n:
            return res
        time.sleep(0.01)
    return broker.hgetall(RESULT_KEY)


def _get(url):
    r = urllib.request.urlopen(url, timeout=5)
    return r.status, json.load(r)


# ---------------------------------------------------------------------------
# tests/test_serving_fleet.py TestFleetGateway
# ---------------------------------------------------------------------------
def test_standalone_frontend_stays_200(m):
    fe = m.http_frontend.FrontEnd(
        m.broker.MemoryBroker(), None, host="127.0.0.1", port=0,
        registry=m.registry.MetricsRegistry()).start()
    try:
        code, body = _get(f"http://127.0.0.1:{fe.port}/healthz")
        assert code == 200 and body["engine"] is None
        assert "fleet" not in body
    finally:
        fe.stop()


def test_gateway_tracks_engine_lifecycle(m):
    broker = m.broker.MemoryBroker()
    reg = m.registry.MetricsRegistry()
    fe = m.http_frontend.FrontEnd(broker, None, host="127.0.0.1", port=0,
                                  fleet_stream=STREAM, engine_ttl_s=5.0,
                                  registry=reg).start()
    url = f"http://127.0.0.1:{fe.port}"
    s = None
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/healthz", timeout=5)
        assert ei.value.code == 503
        assert ei.value.headers["Retry-After"]
        assert json.load(ei.value)["reason"] == "no serving engine alive"
        req = urllib.request.Request(
            url + "/predict", data=b'{"instances": [[1.0]]}',
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        assert ei.value.code == 503

        s = _identity_engine(m, broker, engine_id="e1",
                             heartbeat_interval_s=0.05).start()
        wait_for(lambda: fe.fleet.poll(force=True) is not None
                 and fe.fleet.alive_count() == 1, msg="e1 alive")
        code, body = _get(url + "/healthz")
        assert code == 200 and body["fleet"]["ready"] == 1
        assert body["fleet"]["engines"]["e1"]["alive"]
        code, mm = _get(url + "/metrics")
        assert mm["fleet"]["alive"] == 1
        assert reg.get("serving_engines_alive").value() == 1
        assert reg.get("serving_engines_total").value() == 1

        s.stop()               # clean stop deregisters immediately
        s = None
        fe.fleet.poll(force=True)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/healthz", timeout=5)
        assert ei.value.code == 503
        assert reg.get("serving_engines_alive").value() == 0
        assert reg.get("serving_engines_total").value() == 1
    finally:
        if s is not None:
            s.stop()
        fe.stop()


def test_killed_engine_ages_out_by_ttl(m):
    broker = m.broker.MemoryBroker()
    tracker = m.fleet.FleetTracker(broker, STREAM, ttl_s=0.25,
                                   registry=m.registry.MetricsRegistry())
    hb = m.fleet.HeartbeatPublisher(
        broker, STREAM, "doomed", lambda: {"ready": True},
        interval_s=0.05, registry=m.registry.MetricsRegistry()).start()
    try:
        wait_for(lambda: tracker.alive_count() == 1, timeout_s=5,
                 msg="doomed alive")
        hb.stop(deregister=False)          # the SIGKILL analogue
        assert broker.hget(m.fleet.engines_key(STREAM), "doomed")
        wait_for(lambda: tracker.poll(force=True) is not None
                 and tracker.alive_count() == 0, timeout_s=5,
                 interval=0.05, msg="doomed aged out")
    finally:
        hb.stop(deregister=False)
        tracker.close()


def test_liveness_survives_cross_host_clock_skew(m):
    broker = m.broker.MemoryBroker()
    tracker = m.fleet.FleetTracker(broker, STREAM, ttl_s=1.0,
                                   registry=m.registry.MetricsRegistry(),
                                   poll_min_interval_s=0.0)
    skew = -4000.0     # engine clock 4000 s behind the gateway
    seq = [0]

    def beat():
        seq[0] += 1
        broker.hset(m.fleet.engines_key(STREAM), "skewed", json.dumps(
            {"engine_id": "skewed", "ready": True,
             "ts": time.time() + skew + 0.01 * seq[0]}))

    try:
        beat()
        assert tracker.poll(force=True)["skewed"]["alive"]
        for _ in range(3):          # keeps beating -> stays alive
            time.sleep(0.12)
            beat()
            assert tracker.alive_count() == 1, "skew killed a live engine"
        wait_for(lambda: tracker.alive_count() == 0, timeout_s=10,
                 interval=0.05, msg="skewed engine aged out")
    finally:
        tracker.close()


def test_dead_rows_purged_from_registry(m):
    broker = m.broker.MemoryBroker()
    tracker = m.fleet.FleetTracker(broker, STREAM, ttl_s=0.05,
                                   registry=m.registry.MetricsRegistry(),
                                   poll_min_interval_s=0.0)
    key = m.fleet.engines_key(STREAM)
    try:
        broker.hset(key, "crashed-old", json.dumps(
            {"engine_id": "crashed-old", "ts": time.time() - 3600}))
        tracker.poll(force=True)
        time.sleep(0.08)                      # > ttl: ages out
        assert not tracker.poll(force=True)["crashed-old"]["alive"]
        wait_for(lambda: tracker.poll(force=True) is not None
                 and broker.hget(key, "crashed-old") is None,
                 timeout_s=5, msg="dead row purged")
        assert "crashed-old" not in (tracker.poll(force=True) or {})
    finally:
        tracker.close()


def test_engine_beating_not_ready_is_not_capacity(m):
    broker = m.broker.MemoryBroker()
    tracker = m.fleet.FleetTracker(broker, STREAM, ttl_s=5.0,
                                   registry=m.registry.MetricsRegistry())
    hb = m.fleet.HeartbeatPublisher(
        broker, STREAM, "sick", lambda: {"ready": False},
        interval_s=0.05, registry=m.registry.MetricsRegistry()).start()
    try:
        wait_for(lambda: "sick" in (tracker.poll(force=True) or {}),
                 msg="sick row")
        assert tracker.poll(force=True)["sick"]["alive"]
        assert tracker.alive_count() == 0
        summary = tracker.summary()
        assert summary["alive"] == 1 and summary["ready"] == 0
    finally:
        hb.stop()
        tracker.close()


def test_local_engine_healthz_carries_fleet_section(m):
    broker = m.broker.MemoryBroker()
    s = _identity_engine(m, broker, engine_id="e1",
                         heartbeat_interval_s=0.05).start()
    fe = m.http_frontend.FrontEnd(broker, s, host="127.0.0.1", port=0,
                                  fleet_stream=STREAM, engine_ttl_s=5.0,
                                  registry=m.registry.MetricsRegistry()
                                  ).start()
    try:
        wait_for(lambda: "e1" in (fe.fleet.poll(force=True) or {}),
                 msg="e1 row")
        code, body = _get(f"http://127.0.0.1:{fe.port}/healthz")
        assert code == 200 and body["ready"]
        assert body["fleet"]["engines"]["e1"]["alive"]
    finally:
        fe.stop()
        s.stop()


def test_unreachable_broker_is_503_not_200(m):
    class DeadBroker(m.broker.MemoryBroker):
        def hgetall(self, key):
            raise ConnectionError("broker down")

    fe = m.http_frontend.FrontEnd(DeadBroker(), None, host="127.0.0.1",
                                  port=0, fleet_stream=STREAM,
                                  registry=m.registry.MetricsRegistry()
                                  ).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{fe.port}/healthz",
                                   timeout=5)
        assert ei.value.code == 503
        assert json.load(ei.value)["reason"] == "broker unreachable"
    finally:
        fe.stop()


# ---------------------------------------------------------------------------
# the engine's fleet knobs, each doing its work (these replace the port's
# refusal of them)
# ---------------------------------------------------------------------------
def test_engine_knobs_publish_heartbeat_metrics_and_spans(m):
    broker = m.broker.MemoryBroker()
    s = _identity_engine(m, broker, engine_id="e1",
                         heartbeat_interval_s=0.05,
                         fleet_metrics_interval_s=0.05, trace_sample=1.0,
                         trace_export_interval_s=0.05).start()
    try:
        uri = m.client.InputQueue(broker, trace_sample=1.0).enqueue(
            uri="k0", t=np.ones(3, np.float32))
        assert uri == "k0" and len(_wait_results(broker, 1)) == 1
        beats = m.fleet.engines_key(STREAM)
        wait_for(lambda: broker.hget(beats, "e1") is not None,
                 msg="heartbeat row")
        row = json.loads(broker.hget(beats, "e1"))
        assert row["engine_id"] == "e1" and row["ready"] is True
        mkey = m.fleet_metrics.metrics_key(STREAM)
        wait_for(lambda: broker.hget(mkey, "e1") is not None and
                 "serving_records_total" in json.loads(
                     broker.hget(mkey, "e1"))["counters"],
                 msg="registry blob")
        tkey = m.trace_plane.traces_key(STREAM)
        wait_for(lambda: any(sp.get("id") == "k0" or "k0" in sp.get(
            "ids", ()) for sp in json.loads(
                broker.hget(tkey, "e1") or '{"spans": []}')["spans"]),
            msg="sampled spans exported")
    finally:
        s.stop()
    # a clean stop deregisters the heartbeat row
    assert broker.hget(m.fleet.engines_key(STREAM), "e1") is None


# ---------------------------------------------------------------------------
# tests/test_rollout.py TestHeartbeatLastKnownGood
# ---------------------------------------------------------------------------
def test_telemetry_error_keeps_version_and_burn(m):
    broker = m.broker.MemoryBroker()
    calls = {"n": 0}

    def payload():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("transient slo read")
        return {"ready": True, "model_version": 7, "slo_burn": 0.5}

    hb = m.fleet.HeartbeatPublisher(broker, STREAM, "e1", payload,
                                    interval_s=60.0,
                                    registry=m.registry.MetricsRegistry())
    assert hb._publish_once()
    assert hb._publish_once()      # payload_fn raises this beat
    row = json.loads(broker.hget(m.fleet.engines_key(STREAM), "e1"))
    assert row["ready"] is False
    assert row["model_version"] == 7 and row["slo_burn"] == 0.5
    assert "transient" in row["error"]


# ---------------------------------------------------------------------------
# tests/test_serving_fleet.py TestFleetObservability
# ---------------------------------------------------------------------------
def _records_series(text):
    out = []
    for line in text.splitlines():
        mt = re.match(r"^serving_records_total\{([^}]*)\} (\S+)$", line)
        if mt:
            labels = dict(re.findall(r'(\w+)="([^"]*)"', mt.group(1)))
            out.append((labels, float(mt.group(2))))
    return out


def _get_code(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def _get_text(url):
    req = urllib.request.Request(url, headers={"Accept": "text/plain"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read().decode()


def _predict_batch(port, instances):
    import http.client
    body = json.dumps({"instances": instances}).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.connect()
        t0 = time.perf_counter()
        conn.request("POST", "/predict", body,
                     {"Content-Type": "application/json"})
        out = json.loads(conn.getresponse().read())
        return out, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def test_any_replica_serves_merged_trace_and_fleet_metrics(m):
    broker = m.broker.MemoryBroker()
    knobs = dict(partitions=2, partition_lease_ttl_s=1.0,
                 heartbeat_interval_s=0.05, trace_sample=1.0,
                 trace_export_interval_s=0.05,
                 fleet_metrics_interval_s=0.05)
    # 100 ms of service time a batch (the JAX package's test uses 30): the
    # bound compares span time with the client's clock, and the HTTP
    # parse and write outside any span stretch to several ms on a loaded
    # worker
    engines = [m.server.ClusterServing(
        m.slow_double(0.1), broker=broker, engine_id=f"e{i}",
        registry=m.registry.MetricsRegistry(), batch_size=8,
        batch_timeout_ms=2, **knobs).start() for i in (1, 2)]
    fes = [m.http_frontend.FrontEnd(
        broker, None, host="127.0.0.1", port=0, timeout_s=15,
        fleet_stream=STREAM, engine_ttl_s=5.0, gateway_id=f"gw-{i}",
        leader_ttl_s=0.5, registry=m.registry.MetricsRegistry(),
        partitions=2, trace_sample=1.0,
        trace_export_interval_s=0.05).start() for i in range(2)]
    try:
        wait_for(lambda: sorted(engines[0].lease_table.owned()
                                + engines[1].lease_table.owned())
                 == [0, 1], msg="both partitions leased")
        wait_for(lambda: _get_code(
            f"http://127.0.0.1:{fes[0].port}/healthz")[0] == 200,
            msg="fleet visible through the gateway")
        warm, _ = _predict_batch(fes[0].port, [[1.0, 2.0], [3.0, 4.0]])
        assert warm["predictions"] == [[2.0, 4.0], [6.0, 8.0]]
        n_sent = 2

        def _summary(port, rid):
            return _get_code(f"http://127.0.0.1:{port}/trace/{rid}/summary")

        def _assembled(rid):
            code, s = _summary(fes[0].port, rid)
            return code == 200 and any(e.startswith("gw-")
                                       for e in s["engines"])

        best = 0.0
        rids = []
        for _ in range(3):
            out, client_ms = _predict_batch(fes[0].port,
                                            [[1.0, 2.0], [3.0, 4.0]])
            n_sent += 2
            assert out["predictions"] == [[2.0, 4.0], [6.0, 8.0]]
            rids = out["request_ids"]
            assert len(rids) == 2
            wait_for(lambda: all(_assembled(r) for r in rids),
                     msg="traces assembled with the gateway window")
            for rid in rids:
                _, s = _summary(fes[0].port, rid)
                best = max(best, s["coverage"] * s["e2e_ms"] / client_ms)
            if best >= 0.95:
                break
        assert best >= 0.95, f"span coverage {best:.3f} of client e2e"

        for fe in fes:
            code, doc = _get_code(
                f"http://127.0.0.1:{fe.port}/trace/{rids[0]}")
            assert code == 200
            assert doc["request_id"] == rids[0]
            names = {e["name"] for e in doc["traceEvents"]}
            assert {"gateway_request", "wire", "decode",
                    "writeback"} <= names
            assert any(e.startswith("gw-0") for e in doc["engines"])
            assert any(e in ("e1", "e2") for e in doc["engines"])
            assert all(":" in e["tid"] for e in doc["traceEvents"])
        code, _ = _get_code(
            f"http://127.0.0.1:{fes[1].port}/trace/no-such-id")
        assert code == 404

        def _sums():
            series = _records_series(_get_text(
                f"http://127.0.0.1:{fes[1].port}/metrics"))
            fleet = {lb["outcome"]: v for lb, v in series
                     if lb.get("scope") == "fleet"}
            per_engine = {}
            for lb, v in series:
                if "engine" in lb and "scope" not in lb:
                    per_engine[lb["outcome"]] = \
                        per_engine.get(lb["outcome"], 0.0) + v
            return fleet, per_engine

        wait_for(lambda: _sums()[0].get("served", 0.0) >= n_sent,
                 msg="fleet served rollup catching up")
        fleet, per_engine = _sums()
        for outcome in ("read", "served"):
            assert fleet[outcome] == per_engine[outcome]
        text = _get_text(f"http://127.0.0.1:{fes[0].port}/metrics")
        assert "fleet_scrape_age_s" in text
    finally:
        for fe in fes:
            fe.stop()
        for e in engines:
            e.stop()


def test_killed_engine_survivor_spans_join_same_trace(m):
    broker = m.broker.MemoryBroker(redeliver_after_s=60.0)
    knobs = dict(partitions=2, partition_lease_ttl_s=0.4,
                 claim_min_idle_s=0.1, claim_interval_s=0.05,
                 heartbeat_interval_s=0.05, trace_sample=1.0,
                 trace_export_interval_s=0.05)
    coll = m.trace_plane.TraceCollector(broker, STREAM)
    ea = _identity_engine(m, broker, engine_id="eA", **knobs).start()
    eb = None
    try:
        wait_for(lambda: ea.lease_table.owned() == [0, 1],
                 msg="eA owning both partitions")
        inq = m.client.InputQueue(broker, partitions=2, trace_sample=1.0)
        live = [f"live{i}" for i in range(6)]
        for i, uri in enumerate(live):
            inq.enqueue(uri=uri, t=np.full(3, float(i), np.float32))
        assert len(_wait_results(broker, 6)) == 6
        wait_for(lambda: all(coll.assemble(u) is not None for u in live),
                 timeout_s=60, msg="pre-kill spans published")
        ea.kill()      # stops everything, flushes/acks NOTHING
        dead = [f"dead{i}" for i in range(12)]
        for i, uri in enumerate(dead):
            inq.enqueue(uri=uri, t=np.full(3, float(i), np.float32))
        group = m.server.GROUP
        d0 = broker.read_group(f"{STREAM}.p0", group, "eA", 100,
                               block_ms=50)
        d1 = broker.read_group(f"{STREAM}.p1", group, "eA", 100,
                               block_ms=50)
        assert len(d0) + len(d1) == 12
        eb = _identity_engine(m, broker, engine_id="eB", **knobs).start()
        # bounded generously: eB waits out eA's leases, then claims, and a
        # JAX engine compiles its buckets first (a loaded worker is slow)
        res = _wait_results(broker, 18, timeout_s=90)
        assert sorted(res) == sorted(live + dead)

        def _joined():
            # eB exports on its interval: a blob may hold a record's
            # decode span before the writeback span that follows it
            for uri in dead:
                doc = coll.assemble(uri)
                if doc is None or "eB" not in doc["engines"] or not {
                        "wire", "decode", "writeback"} <= {
                        e["name"] for e in doc["traceEvents"]}:
                    return False
            return True
        wait_for(_joined, timeout_s=60,
                 msg="survivor spans joining dead uris")
        doc = coll.assemble(dead[0])
        assert doc["request_id"] == dead[0]
        names = {e["name"] for e in doc["traceEvents"]}
        assert {"wire", "decode", "writeback"} <= names
        for uri in live + dead:
            assert coll.assemble(uri) is not None
    finally:
        if eb is not None:
            eb.stop()


# ---------------------------------------------------------------------------
# tests/test_trace_plane.py
# ---------------------------------------------------------------------------
def test_should_sample_deterministic_and_exact_edges(m):
    for i in range(64):
        uri = f"req-{i}"
        assert m.trace_plane.should_sample(uri, 1.0)
        assert not m.trace_plane.should_sample(uri, 0.0)
        assert m.trace_plane.should_sample(uri, 0.5) == \
            m.trace_plane.should_sample(uri, 0.5)


def test_should_sample_mid_rate_and_monotone(m):
    ids = [f"id-{i}" for i in range(4000)]
    frac = sum(m.trace_plane.should_sample(u, 0.1) for u in ids) / len(ids)
    assert 0.06 < frac < 0.14
    for i in range(256):
        uri = f"mono-{i}"
        if m.trace_plane.should_sample(uri, 0.01):
            assert m.trace_plane.should_sample(uri, 0.1)
            assert m.trace_plane.should_sample(uri, 0.5)


def test_should_sample_agrees_across_packages():
    ids = [f"x-{i}" for i in range(512)]
    for rate in (0.01, 0.3, 0.77):
        assert [IMPLS["jax"].trace_plane.should_sample(u, rate)
                for u in ids] == [
            IMPLS["port"].trace_plane.should_sample(u, rate) for u in ids]


def test_span_wire_round_trip_and_empty_fields(m):
    t = m.tracing
    s = t.Span("decode", "serving.pipeline", 10.5, 0.25, trace_id="u1",
               tid="worker-0", parent="serve_once", args={"k": 1})
    d = t.span_to_dict(s, epoch=10.0)
    assert d["s"] == pytest.approx(0.5) and d["d"] == pytest.approx(0.25)
    rt = t.span_from_dict(d)
    assert (rt.name, rt.cat, rt.trace_id, rt.tid, rt.parent) == \
        ("decode", "serving.pipeline", "u1", "worker-0", "serve_once")
    assert rt.args == {"k": 1}
    d = t.span_to_dict(t.Span("sink", "serving", 1.0, 0.1))
    for absent in ("id", "ids", "parent", "args"):
        assert absent not in d


def test_tracer_ring_overflow_and_namespaced_tid(m):
    reg = m.registry.MetricsRegistry()
    tr = m.tracing.Tracer(max_spans=16, registry=reg, engine="e9")
    for i in range(24):
        tr.add_span("decode", 0.0, 1.0, trace_id=f"u{i}")
    fam = reg.get("observability_spans_dropped_total")
    assert fam.value(engine="e9") == 8
    assert len(tr.spans()) == 16
    tr = m.tracing.Tracer(engine="e3")
    tr.add_span("decode", 0.0, 1.0, trace_id="u")
    doc = tr.chrome_trace()
    assert doc["traceEvents"]
    assert all(e["tid"].startswith("e3:") for e in doc["traceEvents"])


def _exporter(m, sample, **kw):
    broker = m.broker.MemoryBroker()
    reg = m.registry.MetricsRegistry()
    tracer = m.tracing.Tracer(engine="eX")
    exp = m.trace_plane.SpanExporter(broker, STREAM, "eX", tracer,
                                     sample=sample, registry=reg, **kw)
    return broker, reg, tracer, exp


def _blob(m, broker):
    return json.loads(broker.hget(m.trace_plane.traces_key(STREAM), "eX"))


def test_exporter_retention_independent_of_sampling_then_force(m):
    broker, reg, tracer, exp = _exporter(m, sample=0.0)
    tracer.add_span("decode", 0.0, 0.01, trace_id="u-fail")
    assert exp.publish_once()
    assert _blob(m, broker)["spans"] == []
    exp.force(["u-fail"])
    assert exp.publish_once()
    assert [s["id"] for s in _blob(m, broker)["spans"]] == ["u-fail"]
    assert reg.get("serving_trace_spans_total").value(engine="eX") == 1
    assert reg.get("serving_trace_sampled_total").value(engine="eX") == 1


def test_exporter_counts_once_batches_ids_and_overflow(m):
    broker, reg, tracer, exp = _exporter(m, sample=1.0)
    tracer.add_span("decode", 0.0, 0.01, trace_id="u1")
    exp.publish_once()
    exp.publish_once()
    assert reg.get("serving_trace_sampled_total").value(engine="eX") == 1
    assert _blob(m, broker)["seq"] == 2
    broker, _, tracer, exp = _exporter(m, sample=1.0)
    tracer.add_span("device", 0.0, 0.01, trace_ids=("u1", "u2"))
    exp.publish_once()
    spans = _blob(m, broker)["spans"]
    assert spans and spans[0]["ids"] == ["u1", "u2"]
    broker, reg, tracer, exp = _exporter(m, sample=1.0, buffer_spans=16)
    for i in range(20):
        tracer.add_span("decode", 0.0, 0.01, trace_id=f"u{i}")
    assert exp.stats()["dropped"] == 4
    assert reg.get("serving_trace_dropped_total").value(engine="eX") == 4


SKEW = 3600.0   # engine clock one hour ahead of the client's


def _publish_trace_blob(m, broker, engine, spans, epoch_wall=0.0):
    broker.hset(m.trace_plane.traces_key(STREAM), engine, json.dumps(
        {"engine": engine, "pid": 7, "seq": 1, "wall": 0.0,
         "epoch_wall": epoch_wall, "dropped": 0, "spans": spans}))


def _fleet_trace_blobs(m, broker):
    _publish_trace_blob(m, broker, "gw", [
        {"name": "gateway_request", "cat": "serving.gateway", "s": 100.0,
         "d": 0.2, "ids": ["r1"], "tid": "h0",
         "args": {"t_ingest": 1000.0}}])
    _publish_trace_blob(m, broker, "e1", [
        {"name": "wire", "cat": "serving.wire", "s": 49.0, "d": 0.002,
         "id": "r0", "tid": "rd",
         "args": {"t_ingest": 999.0, "t_read_wall": 999.0 + SKEW + 0.002}},
        {"name": "wire", "cat": "serving.wire", "s": 50.0, "d": 0.005,
         "id": "r1", "tid": "rd",
         "args": {"t_ingest": 1000.0,
                  "t_read_wall": 1000.0 + SKEW + 0.005}},
        {"name": "decode", "cat": "serving.pipeline", "s": 50.01,
         "d": 0.02, "id": "r1", "tid": "dec"},
        {"name": "device", "cat": "serving.device", "s": 50.04, "d": 0.1,
         "ids": ["r1"], "tid": "snk"},
        {"name": "writeback", "cat": "serving.sink", "s": 50.15,
         "d": 0.01, "ids": ["r1"], "tid": "snk"}])


def test_collector_places_skewed_engine_on_client_timeline(m):
    broker = m.broker.MemoryBroker()
    _fleet_trace_blobs(m, broker)
    doc = m.trace_plane.TraceCollector(broker, STREAM).assemble("r1")
    assert doc is not None and doc["engines"] == ["e1", "gw"]
    assert doc["anchor_wall"] == pytest.approx(1000.0, abs=0.01)
    assert all(0.0 <= e["ts"] <= 0.3e6 for e in doc["traceEvents"])
    wire = next(e for e in doc["traceEvents"] if e["name"] == "wire")
    assert wire["dur"] == pytest.approx(3000.0, rel=0.01)
    tids = {e["tid"] for e in doc["traceEvents"]}
    assert "gw:h0" in tids and "e1:dec" in tids


def test_collector_summary_critical_path_and_coverage(m):
    broker = m.broker.MemoryBroker()
    _fleet_trace_blobs(m, broker)
    s = m.trace_plane.TraceCollector(broker, STREAM).summary("r1")
    assert s["engines"] == ["e1", "gw"]
    assert s["e2e_ms"] == pytest.approx(200.0, rel=0.01)
    cp = s["critical_path_ms"]
    assert cp["wire"] == pytest.approx(3.0, rel=0.05)
    assert cp["decode"] == pytest.approx(20.0, rel=0.05)
    assert cp["device"] == pytest.approx(100.0, rel=0.05)
    assert cp["writeback"] == pytest.approx(10.0, rel=0.05)
    assert 0.0 < s["coverage"] <= 1.0


def test_collector_anchorless_unknown_and_garbage(m):
    broker = m.broker.MemoryBroker()
    _publish_trace_blob(m, broker, "e2", [
        {"name": "decode", "cat": "serving.pipeline", "s": 5.0, "d": 0.01,
         "id": "rz", "tid": "dec"}], epoch_wall=2000.0)
    coll = m.trace_plane.TraceCollector(broker, STREAM)
    assert coll.assemble("rz")["anchor_wall"] == pytest.approx(2005.0)
    broker = m.broker.MemoryBroker()
    assert m.trace_plane.TraceCollector(broker, STREAM).assemble(
        "nope") is None
    broker.hset(m.trace_plane.traces_key(STREAM), "bad", "not json")
    _fleet_trace_blobs(m, broker)
    assert m.trace_plane.TraceCollector(broker, STREAM).assemble(
        "r1") is not None


def _engine_registry(m, served, stage_ms):
    reg = m.registry.MetricsRegistry()
    reg.counter("serving_records_total", "records").inc(
        served, outcome="served")
    h = reg.histogram("serving_stage_ms", "stage time")
    for v in stage_ms:
        h.observe(v, stage="decode")
    reg.gauge("serving_queue_depth", "depth").set(float(served),
                                                  queue="decode")
    return reg


def _publish_metrics(m, broker, engine, reg, seq=1):
    broker.hset(m.fleet_metrics.metrics_key(STREAM), engine,
                json.dumps(m.fleet_metrics.registry_blob(reg, engine, seq)))


def test_fleet_metrics_counters_histograms_gauges(m):
    broker = m.broker.MemoryBroker()
    _publish_metrics(m, broker, "e1",
                     _engine_registry(m, 5, [1.0, 2.0, 3.0]))
    _publish_metrics(m, broker, "e2", _engine_registry(m, 7, [100.0]))
    agg = m.fleet_metrics.FleetMetricsAggregator(
        broker, STREAM, m.registry.MetricsRegistry())
    merged = agg.merged()
    fam = merged.get("serving_records_total")
    assert fam.value(engine="e1", outcome="served") == 5
    assert fam.value(engine="e2", outcome="served") == 7
    assert fam.value(outcome="served", scope="fleet") == 12
    hfam = merged.get("serving_stage_ms")
    fleet = hfam.child(stage="decode", scope="fleet")
    assert fleet.count == 4
    assert fleet.total == pytest.approx(106.0)
    assert hfam.child(stage="decode", engine="e1").count == 3
    gfam = merged.get("serving_queue_depth")
    assert gfam.value(engine="e1", queue="decode") == 5.0
    assert gfam.value(engine="e2", queue="decode") == 7.0
    labels = [s["labels"] for s in gfam._series_snapshot()]
    assert not any(lb.get("scope") == "fleet" for lb in labels)


def test_fleet_metrics_alive_filter_and_colocated_series(m):
    broker = m.broker.MemoryBroker()
    _publish_metrics(m, broker, "e1", _engine_registry(m, 5, []))
    _publish_metrics(m, broker, "edead", _engine_registry(m, 100, []))
    agg = m.fleet_metrics.FleetMetricsAggregator(
        broker, STREAM, m.registry.MetricsRegistry(),
        alive_fn=lambda: {"e1"})
    fam = agg.merged().get("serving_records_total")
    assert fam.value(outcome="served", scope="fleet") == 5
    assert fam.value(engine="edead", outcome="served") == 0
    broker = m.broker.MemoryBroker()
    _publish_metrics(m, broker, "e1", _engine_registry(m, 5, []))
    gw = m.registry.MetricsRegistry()
    gw.counter("serving_records_total", "records").inc(
        5, outcome="served", engine="e1")
    fam = m.fleet_metrics.FleetMetricsAggregator(
        broker, STREAM, gw).merged().get("serving_records_total")
    assert fam.value(engine="e1", outcome="served") == 5
    assert fam.value(outcome="served", scope="fleet") == 5


def test_fleet_metrics_scrape_age_tracks_seq_progress(m):
    broker = m.broker.MemoryBroker()
    gw = m.registry.MetricsRegistry()
    pub = m.fleet_metrics.FleetMetricsPublisher(
        broker, STREAM, "e1", _engine_registry(m, 1, []), interval_s=30.0)
    pub.publish_once()
    agg = m.fleet_metrics.FleetMetricsAggregator(broker, STREAM, gw)
    agg.merged()
    assert gw.get("fleet_scrape_age_s").value(engine="e1") < 1.0
    assert agg.summary()["engines"]["e1"]["seq"] == 1
    pub.publish_once()
    agg.merged()
    assert agg.summary()["engines"]["e1"]["seq"] == 2


def test_result_rows_carry_per_hop_timing(m):
    broker = m.broker.MemoryBroker()
    srv = _identity_engine(m, broker, engine_id="e1", batch_size=4,
                           trace_sample=1.0,
                           trace_export_interval_s=0.1).start()
    try:
        inq = m.client.InputQueue(broker, trace_sample=1.0)
        outq = m.client.OutputQueue(broker)
        uri = inq.enqueue(t=np.ones(3, np.float32))
        res = []
        wait_for(lambda: res.append(outq.query(uri)) or res[-1] is not None,
                 interval=0.005, msg="traced result")
        hops = outq.last_hops[uri]
        assert hops["engine"] == "e1"
        assert hops["engine_ms"] >= hops["device_ms"] >= 0.0
        assert hops["engine_ms"] >= hops["queue_ms"] >= 0.0
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# tests/test_profiling_slo.py TestDeviceMemory, and the package's exports
# ---------------------------------------------------------------------------
def _device_array(m, shape):
    """A device array of each package on its CPU backend."""
    if m.name == "jax":
        return jax.device_put(np.ones(shape, np.float32))
    return torch.ones(shape, dtype=torch.float32)


def test_watcher_publishes_gauges(m):
    reg = m.registry.MetricsRegistry()
    w = m.memwatch.DeviceMemoryWatcher(interval_s=30.0, registry=reg)
    keep = _device_array(m, (64, 64))
    snap = w.sample()
    # the JAX package's CPU backend here may hold several host devices
    assert "cpu:0" in snap and all(k.startswith("cpu:") for k in snap)
    assert snap["cpu:0"]["live_bytes"] >= 64 * 64 * 4
    assert snap["cpu:0"]["peak_bytes"] >= snap["cpu:0"]["live_bytes"]
    g = reg.get("device_memory_live_bytes")
    assert {"device": "cpu:0"} in [dict(k) for k in g.label_keys()]
    assert reg.get("device_memory_peak_bytes") is not None
    del keep


def test_watcher_thread_lifecycle(m):
    w = m.memwatch.DeviceMemoryWatcher(
        interval_s=0.05, registry=m.registry.MetricsRegistry())
    with w:
        time.sleep(0.15)
    assert w._thread is None


def test_leak_check_clean_and_detects_retained_bytes(m):
    with m.memwatch.leak_check(tolerance_bytes=1 << 20):
        r = _device_array(m, (128, 128))
        del r
    keep = []
    with pytest.raises(m.memwatch.DeviceMemoryLeak, match="grew past"):
        with m.memwatch.leak_check(tolerance_bytes=1024):
            keep.append(_device_array(m, (512, 512)))
    keep.clear()
    with pytest.raises(RuntimeError, match="workload"):
        with m.memwatch.leak_check(tolerance_bytes=0):
            raise RuntimeError("workload failed")


def test_port_tree_device_bytes_counts_each_storage_once():
    from analytics_zoo_tpu_torch.observability.memwatch import \
        tree_device_bytes
    lin = torch.nn.Linear(8, 4)
    assert tree_device_bytes(lin) == {"cpu:0": float((8 * 4 + 4) * 4)}
    w = torch.zeros(10)
    assert tree_device_bytes({"a": w, "b": [w[:5], w]}) == {"cpu:0": 40.0}


def test_observability_package_exports_every_name(m):
    names = IMPLS["jax"].observability.__all__
    assert sorted(m.observability.__all__) == sorted(names)
    for name in names:
        assert getattr(m.observability, name) is not None
    assert m.observability.leak_check is m.memwatch.leak_check
