"""The port's `ClusterServing` engine and the modules it runs
(`serving/server.py`, `serving/pre_post.py`, `serving/elastic.py`,
`observability/tracing.py`, `observability/slo.py`) held to the cases of
the JAX package's own tests: tests/test_serving.py (`TestEndToEnd`),
tests/test_redis_broker.py (the engine cases), tests/test_serving_pipeline.py
(`TestPipelinedServing`), tests/test_serving_prepost.py (all),
tests/test_elastic_serving.py (`TestAdaptiveController`, `TestTierTable`,
`TestAdmissionController`, `TestTieredEngine`), tests/test_observability.py
(`TestTracer`, `TestServingObservability`) and tests/test_profiling_slo.py
(`TestSLOTracker`). Every case runs on both packages; each engine stops in
a `finally`.
"""

import base64
import io
import json
import logging
import threading
import time

import numpy as np
import pytest
from torch import nn

from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry
from analytics_zoo_tpu_torch.serving import server as tserver
from analytics_zoo_tpu_torch.serving.broker import MemoryBroker
from analytics_zoo_tpu_torch.serving.client import InputQueue
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel
from torch_cluster_serving_impls import (  # noqa: F401 (fixtures)
    STREAM, m, no_stray_threads, wait_for, wait_results)

BUCKETS = [1, 2, 4, 8, 16, 32]


def _bad_record(uri, shape=(4,)):
    return {"uri": uri, "data": {"t": {"b64": "!!!", "dtype": "float32",
                                       "shape": list(shape)}}}


# ---------------------------------------------------------------------------
# tests/test_serving.py TestEndToEnd
# ---------------------------------------------------------------------------
def test_queue_to_result(m):
    W, im = m.linear()
    br = m.broker.MemoryBroker()
    serving = m.server.ClusterServing(im, br, batch_size=8).start()
    try:
        q = m.client.InputQueue(br)
        x = np.random.RandomState(1).randn(6, 4).astype(np.float32)
        uris = [q.enqueue(None, t=x[i]) for i in range(3)]
        results = wait_results(m, br, uris, timeout_s=10)
        assert len(results) == 3
        for i, u in enumerate(uris):
            np.testing.assert_allclose(results[u], x[i] @ W, atol=1e-5)
        np.testing.assert_allclose(q.predict(x[3]), x[3] @ W, atol=1e-5)
    finally:
        serving.stop()


def test_bad_record_degrades_to_nan(m):
    _, im = m.linear()
    br = m.broker.MemoryBroker()
    serving = m.server.ClusterServing(im, br, batch_size=4).start()
    try:
        br.xadd(STREAM, _bad_record("bad1", (2,)))
        wait_for(lambda: br.hget(f"result:{STREAM}", "bad1") is not None,
                 timeout_s=10, interval=0.01)
        assert br.hget(f"result:{STREAM}", "bad1") == "NaN"
        out = m.client.InputQueue(br).predict(np.ones((4,), np.float32))
        assert out.shape == (3,)
        metrics = serving.metrics()
        assert metrics["records_served"] >= 2
        assert metrics["predict"]["count"] >= 1
    finally:
        serving.stop()


# ---------------------------------------------------------------------------
# tests/test_redis_broker.py: the engine over the RESP2 wire
# ---------------------------------------------------------------------------
def test_serving_loop_survives_broker_failure(m):
    srv = m.redis_server.MiniRedisServer().start()
    _, im = m.linear(3, 2)
    broker = m.broker.RedisBroker("127.0.0.1", srv.port)
    serving = m.server.ClusterServing(im, broker, batch_timeout_ms=20)
    serving.start()
    client = m.broker.RedisBroker("127.0.0.1", srv.port)
    try:
        time.sleep(0.1)
        broker._r.close()
        time.sleep(0.2)
        assert serving.is_alive()
        out = m.client.InputQueue(client).predict(
            np.ones(3, np.float32), timeout_s=30)
        assert np.asarray(out).shape == (2,)
    finally:
        serving.stop()
        broker.close()
        client.close()
        srv.stop()


# ---------------------------------------------------------------------------
# tests/test_serving_pipeline.py TestPipelinedServing
# ---------------------------------------------------------------------------
def test_concurrent_clients_mixed_shapes(m):
    im = m.fn_model("sum")
    br = m.broker.MemoryBroker()
    serving = m.server.ClusterServing(im, br, batch_size=16,
                                      decode_workers=3).start()
    try:
        results, errs = {}, []
        lock = threading.Lock()

        def client(seed, dim):
            try:
                rng = np.random.RandomState(seed)
                q = m.client.InputQueue(br)
                mine = {}
                for _ in range(8):
                    x = rng.randn(dim).astype(np.float32)
                    mine[q.enqueue(None, t=x)] = x
                got = wait_results(m, br, list(mine), timeout_s=30)
                with lock:
                    for u, x in mine.items():
                        results[u] = (x, got.get(u))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [threading.Thread(target=client, args=(i, dim))
                   for i, dim in enumerate([3, 5, 8, 3, 5, 8])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs and len(results) == 48
        for x, got in results.values():
            assert got is not None, "a result never landed"
            np.testing.assert_allclose(got, x.sum(keepdims=True),
                                       atol=1e-5)
    finally:
        serving.stop()


def test_decode_failure_degrades_without_stalling(m):
    _, im = m.linear()
    br = m.broker.MemoryBroker()
    serving = m.server.ClusterServing(im, br, batch_size=8).start()
    try:
        q = m.client.InputQueue(br)
        good, bad = [], []
        for i in range(6):
            good.append(q.enqueue(None, t=np.ones((4,), np.float32) * i))
            br.xadd(STREAM, _bad_record(f"bad-{i}"))
            bad.append(f"bad-{i}")
        br.xadd(STREAM, [1, 2, 3])          # not even a dict
        results = wait_results(m, br, good + bad, timeout_s=20)
        assert len(results) == 12
        for u in bad:
            assert isinstance(results[u], float) and np.isnan(results[u])
        for u in good:
            assert np.asarray(results[u]).shape == (3,)
    finally:
        serving.stop()


def test_stop_drains_in_flight_work(m):
    _, im = m.linear()
    br = m.broker.MemoryBroker()
    serving = m.server.ClusterServing(im, br, batch_size=8).start()
    q = m.client.InputQueue(br)
    uris = [q.enqueue(None, t=np.ones((4,), np.float32)) for _ in range(12)]
    try:
        wait_for(lambda: serving.records_read == 12, timeout_s=20,
                 interval=0.01)
    finally:
        serving.stop()
    assert serving.records_served == 12
    out = m.client.OutputQueue(br)
    assert all(out.query(u) is not None for u in uris)
    assert not serving._threads


def test_metrics_expose_stage_percentiles_and_queue_depths(m):
    _, im = m.linear()
    br = m.broker.MemoryBroker()
    serving = m.server.ClusterServing(im, br).start()
    try:
        m.client.InputQueue(br).predict(np.ones((4,), np.float32))
        got = serving.metrics()
        assert got["records_served"] >= 1 and got["pipelined"] is True
        for stage in ("decode", "dispatch", "sink"):
            snap = got["stages"][stage]
            assert snap["count"] >= 1
            for k in ("p50_ms", "p95_ms", "p99_ms"):
                assert snap[k] >= 0.0
        assert set(got["queue_depths"]) == {"decode", "dispatch", "sink"}
        assert got["batch"]["p50_ms"] > 0.0
        assert got["predict"]["p99_ms"] >= got["predict"]["p50_ms"]
        assert got["serving_dtype"] == "float32"
        assert serving.health()["ready"] is True
    finally:
        serving.stop()
    assert serving.health()["ready"] is False


@pytest.mark.parametrize("pipelined", [True, False])
def test_output_filter_through_the_engine(m, pipelined):
    im = m.fn_model("identity")
    br = m.broker.MemoryBroker()
    serving = m.server.ClusterServing(im, br, output_filter="topN(2)",
                                      pipelined=pipelined)
    q = m.client.InputQueue(br)
    uris = [q.enqueue(None, t=np.asarray([0.1, 0.7, 0.2], np.float32))
            for _ in range(3)]
    if pipelined:
        serving.start()
        try:
            results = wait_results(m, br, uris, timeout_s=20)
        finally:
            serving.stop()
    else:
        served = 0
        while served < 3:
            served += serving.serve_once()
        serving._unwire_gauges()
        results = {u: m.client.OutputQueue(br).query(u) for u in uris}
    for u in uris:
        assert results[u] == "[1:0.69999999,2:0.20000000]"


def test_bad_output_filter_fails_at_construction(m):
    with pytest.raises(ValueError, match="Unsupported serving filter"):
        m.server.ClusterServing(m.fn_model("identity"),
                                m.broker.MemoryBroker(),
                                output_filter="argmax()")


# ---------------------------------------------------------------------------
# tests/test_serving_prepost.py
# ---------------------------------------------------------------------------
def test_arrow_codec_roundtrip(m):
    pp = m.pre_post
    arr = np.random.RandomState(0).rand(3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(pp.arrow_decode(pp.arrow_encode(arr)), arr)
    arr = np.random.RandomState(1).rand(7).astype(np.float32)
    np.testing.assert_array_equal(pp.arrow_decode(pp.arrow_encode_b64(arr)),
                                  arr)


def test_decode_record_field_variants(m):
    pp = m.pre_post
    arr = np.random.RandomState(2).rand(2, 3).astype(np.float32)
    for value in (m.broker.encode_ndarray(arr),
                  {"arrow": pp.arrow_encode_b64(arr)},
                  pp.arrow_encode(arr), arr.tolist()):
        np.testing.assert_array_equal(pp.decode_record_field(value), arr)
    with pytest.raises(ValueError, match="Unknown record encoding"):
        pp.decode_record_field({"mystery": 1})


def test_record_meta_and_zero_copy_decode(m):
    pp = m.pre_post
    ids = np.arange(16, dtype=np.int64) * 3
    blob = m.broker.encode_ndarray(ids)
    assert pp.record_meta(blob) == ((16,), "<i8")
    assert pp.record_meta({"arrow": "x"}) is None
    row = np.empty(16, np.int64)
    pp.decode_record_into(blob, row)
    np.testing.assert_array_equal(row, ids)


def test_image_b64_payload(m):
    from PIL import Image
    img = Image.fromarray(
        (np.random.RandomState(3).rand(8, 8, 3) * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    rec = {"image_b64": base64.b64encode(buf.getvalue()).decode()}
    # each package's decode of the payload against the JAX module's
    from analytics_zoo_tpu.serving import pre_post as jpre_post
    want = jpre_post.decode_record_field(rec)
    got = m.pre_post.decode_record_field(rec)
    assert got.shape == (8, 8, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # `image=` bytes go out as the decoded image's record
    broker = m.broker.MemoryBroker()
    m.client.InputQueue(broker).enqueue("u", image=buf.getvalue())
    (record,) = broker._streams["serving_stream"].values()
    assert record["uri"] == "u"
    np.testing.assert_array_equal(
        m.broker.decode_ndarray(record["data"]["image"]), want)


def test_top_n_and_apply_filter(m):
    pp = m.pre_post
    pred = np.asarray([0.1, 0.5, 0.2, 0.15, 0.05])
    assert [i for i, _ in pp.top_n(pred, 3)] == [1, 2, 3]
    s = pp.format_top_n(pred, 2)
    assert s.startswith("[1:0.5") and s.endswith("]")
    assert pp.apply_filter(np.asarray([0.9, 0.1]),
                           "topN(1)").startswith("[0:0.9")
    with pytest.raises(ValueError, match="Unsupported serving filter"):
        pp.apply_filter(pred, "argmax()")


# ---------------------------------------------------------------------------
# tests/test_elastic_serving.py TestAdaptiveController, TestTierTable,
# TestAdmissionController, TestTieredEngine
# ---------------------------------------------------------------------------
def _controller(m, policy="adaptive", deadline=None, batch_size=32,
                timeout_ms=5.0, **kw):
    return m.elastic.AdaptiveBatchController(
        BUCKETS, batch_size, timeout_ms, policy=policy,
        deadline_ms=deadline, registry=m.registry.MetricsRegistry(), **kw)


def test_controller_bad_knobs_raise(m):
    with pytest.raises(ValueError):
        _controller(m, policy="bogus")
    with pytest.raises(ValueError):
        _controller(m, deadline=-1.0)


def test_fixed_static_and_deadline_free_policies(m):
    c = _controller(m, policy="fixed", batch_size=8, timeout_ms=5.0)
    plan = c.plan(3, 0.0, backlog=100)
    assert plan.target == 8 and plan.wait_ms == 5.0
    assert c.plan(8, 0.0, backlog=100).wait_ms == 0.0
    assert c.pad_bucket(3) == 4
    plan = _controller(m, batch_size=8).plan(3, 0.0, backlog=0)
    assert (plan.target, plan.wait_ms, plan.reason) == (8, 5.0, "fixed")
    c = _controller(m, policy="static", batch_size=8, timeout_ms=5.0)
    assert c.cap == 8 and c.pad_bucket(1) == 8
    plan = c.plan(1, 0.0, backlog=0)
    assert plan.target == 8 and plan.wait_ms == 5.0


def test_adaptive_light_deadline_and_heavy_load(m):
    plan = _controller(m, deadline=50.0).plan(3, 0.0, backlog=0)
    assert (plan.target, plan.wait_ms, plan.reason) == (4, 0.0, "light")
    c = _controller(m, deadline=20.0)
    c.cost.seed(4, 10.0)
    plan = c.plan(3, 15.0, backlog=500)
    assert (plan.target, plan.wait_ms, plan.reason) == (4, 0.0, "deadline")
    c = _controller(m, deadline=100.0, timeout_ms=5.0)
    for b, ms in ((1, 5.0), (8, 6.0), (32, 8.0)):
        c.cost.observe(b, ms)
    plan = c.plan(3, 0.0, backlog=500)
    assert plan.reason == "grow" and plan.target == 32
    assert 0 < plan.wait_ms <= 5.0
    assert c.plan(32, 0.0, backlog=500).wait_ms == 0.0


def test_budget_prices_the_dispatched_bucket_not_the_fit(m):
    c = _controller(m, deadline=30.0, margin_ms=2.0)
    c.cost.observe(1, 5.0)
    c.cost.observe(8, 25.0)
    plan = c.plan(1, 10.0, backlog=500)
    assert (plan.target, plan.wait_ms, plan.reason) == (1, 0.0, "deadline")
    c = _controller(m, deadline=50.0, batch_size=8, timeout_ms=5.0)
    plan = c.plan(3, 0.0, backlog=None)
    assert plan.reason == "unknown" and plan.target == 8
    assert 0 < plan.wait_ms <= 5.0
    c = _controller(m, deadline=10.0, timeout_ms=50.0, margin_ms=0.0)
    for b, ms in ((1, 1.0), (32, 2.0)):
        c.cost.observe(b, ms)
    assert c.plan(2, 5.0, backlog=500).wait_ms <= 4.0 + 1e-9


def test_deadline_defaults_from_slo(m):
    _, im = m.linear(4, 2)
    cs = m.server.ClusterServing(im, m.broker.MemoryBroker(),
                                 slo={"latency_ms": 40.0},
                                 registry=m.registry.MetricsRegistry())
    try:
        assert cs.batcher.deadline_ms == 40.0
    finally:
        cs.stop()


def test_tier_table(m):
    t = m.elastic.TierTable(["batch", "standard", "premium"])
    assert (t.level("premium"), t.level("batch")) == (2, 0)
    assert t.level("nonsense") == 0 and t.level(None) == 0
    assert t.top == 2
    with pytest.raises(ValueError):
        m.elastic.TierTable([])
    with pytest.raises(ValueError):
        m.elastic.TierTable(["a", "a"])


def test_admission_controller_tiers(m):
    class DepthBroker(m.broker.MemoryBroker):
        depth, fail = 0, False

        def stream_depth(self, stream):
            if self.fail:
                raise ConnectionError("down")
            return self.depth

    b = DepthBroker()
    a = m.elastic.AdmissionController(
        b, "s", ["batch", "standard", "premium"], max_backlog=90,
        registry=m.registry.MetricsRegistry(), poll_min_interval_s=0.0)
    assert [a.threshold(i) for i in range(3)] == [30, 60, 90]
    b.depth = 45
    assert [a.admit(t)[0] for t in ("batch", "standard", "premium")] == \
        [False, True, True]
    b.depth = 95
    assert a.admit("premium")[0] is False
    b.fail = True
    assert a.admit("batch")[0] is True


def _tier_model(m, width=8):
    _, im = m.linear(width, 4)
    im.warmup(np.zeros((width,), np.float32), buckets=[1, 2, 4, 8])
    return im


def test_shed_lowest_tier_first_high_tier_zero_loss(m):
    broker = m.broker.MemoryBroker()
    q = m.client.InputQueue(broker)
    low = [q.enqueue(None, tier="batch", t=np.ones((8,), np.float32))
           for _ in range(40)]
    high = [q.enqueue(None, tier="premium", t=np.ones((8,), np.float32))
            for _ in range(10)]
    cs = m.server.ClusterServing(
        _tier_model(m), broker, batch_size=8, batch_timeout_ms=2,
        deadline_ms=25.0, admission_tiers=["batch", "premium"],
        shed_backlog=8, registry=m.registry.MetricsRegistry()).start()
    try:
        vals = wait_results(m, broker, low + high, timeout_s=60)
    finally:
        cs.stop()
    assert len(vals) == 50
    assert all(isinstance(vals[u], np.ndarray) for u in high)
    shed = [u for u in low if isinstance(vals[u], str) and vals[u] == "SHED"]
    assert shed
    assert cs._admission_out.value(outcome="shed", tier="batch") == len(shed)
    assert cs._records_total.value(outcome="shed") == len(shed)
    assert cs._records_total.value(outcome="served") == 50 - len(shed)
    assert cs.records_served == 50 - len(shed)


def test_single_tier_never_sheds(m):
    broker = m.broker.MemoryBroker()
    q = m.client.InputQueue(broker)
    uris = [q.enqueue(None, t=np.ones((8,), np.float32)) for _ in range(30)]
    cs = m.server.ClusterServing(
        _tier_model(m), broker, batch_size=8, batch_timeout_ms=2,
        admission_tiers=["only"], shed_backlog=2,
        registry=m.registry.MetricsRegistry()).start()
    try:
        vals = wait_results(m, broker, uris, timeout_s=60)
    finally:
        cs.stop()
    assert len(vals) == 30
    assert all(isinstance(v, np.ndarray) for v in vals.values())


# ---------------------------------------------------------------------------
# tests/test_observability.py TestTracer, TestServingObservability
# ---------------------------------------------------------------------------
def test_tracer_nesting_and_chrome_trace(m):
    tr = m.tracing.Tracer()
    with tr.span("outer", trace_id="req-1"):
        with tr.span("inner", args={"n": 3}):
            time.sleep(0.001)
    inner, outer = tr.spans()
    assert inner.trace_id == "req-1" and inner.parent == "outer"
    assert outer.parent is None
    assert outer.start <= inner.start and inner.end <= outer.end
    assert tr.spans("req-1") == [inner, outer] and tr.spans("x") == []
    tr.add_span("wait", time.perf_counter() - 0.01, time.perf_counter(),
                trace_ids=["req-1", "s"], cat="queue")
    doc = tr.chrome_trace()
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    by_name = {e["name"]: e for e in doc["traceEvents"]}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in by_name.values())
    assert by_name["inner"]["args"]["n"] == 3
    assert by_name["wait"]["args"]["trace_ids"] == ["req-1", "s"]
    assert len(tr.chrome_trace("s")["traceEvents"]) == 1
    d = m.tracing.span_to_dict(inner)
    assert m.tracing.span_from_dict(d).name == "inner"


def test_tracer_ring_and_coverage(m):
    tr = m.tracing.Tracer(max_spans=10)
    for i in range(25):
        tr.add_span(f"s{i}", 0.0, 1.0)
    assert len(tr.spans()) == 10 and tr.dropped == 15
    assert tr.spans()[0].name == "s15"
    tr = m.tracing.Tracer()
    tr.add_span("a", 0.0, 0.5)
    tr.add_span("b", 0.4, 1.0)
    assert m.tracing.span_coverage(tr.spans(), 0.0, 1.0) == \
        pytest.approx(1.0)
    tr = m.tracing.Tracer()
    tr.add_span("a", 0.0, 0.25)
    tr.add_span("b", 0.75, 1.0)
    assert m.tracing.span_coverage(tr.spans(), 0.0, 1.0) == \
        pytest.approx(0.5)
    assert m.tracing.span_coverage([], 0.0, 1.0) == 0.0


def test_request_spans_cover_e2e_latency_and_registry(m):
    tracer = m.tracing.Tracer()
    registry = m.registry.MetricsRegistry()
    broker = m.broker.MemoryBroker()
    serving = m.server.ClusterServing(
        m.fn_model("double"), broker=broker, batch_timeout_ms=1,
        tracer=tracer, registry=registry).start()
    try:
        inq = m.client.InputQueue(broker)
        uri = inq.enqueue(t=np.ones((4,), np.float32))
        assert wait_results(m, broker, [uri], timeout_s=30)
        uris = [inq.enqueue(t=np.ones((4,), np.float32)) for _ in range(2)]
        assert len(wait_results(m, broker, uris, timeout_s=30)) == 2
    finally:
        serving.stop()
    spans = tracer.spans(uri)
    assert {"decode", "dispatch", "sink", "decode_q_wait",
            "dispatch_q_wait", "sink_q_wait"} <= {s.name for s in spans}
    t_read = min(s.start for s in spans)
    first = serving.batch_timer.total if serving.batch_timer.count == 1 \
        else None
    if first is not None:
        assert m.tracing.span_coverage(spans, t_read,
                                       t_read + first) >= 0.95
    assert all(s.covers(uri) for s in spans)
    snap = registry.snapshot()
    c = {s["labels"]["outcome"]: s["value"]
         for s in snap["serving_records_total"]["series"]}
    assert c["read"] == 3 and c["served"] == 3
    stages = {s["labels"]["stage"] for s in snap["serving_stage_ms"]["series"]}
    assert {"decode", "dispatch", "sink"} <= stages
    assert {s["labels"]["queue"]
            for s in snap["serving_queue_depth"]["series"]} == \
        {"decode", "dispatch", "sink"}


# ---------------------------------------------------------------------------
# tests/test_profiling_slo.py TestSLOTracker
# ---------------------------------------------------------------------------
def _tracker(m, **kw):
    defaults = dict(latency_ms=50.0, availability=0.99, window_s=60.0)
    defaults.update(kw)
    return m.slo.SLOTracker(m.slo.SLOObjectives(**defaults),
                            min_interval_s=0.0)


def test_slo_validation_and_vacuous(m):
    O = m.slo.SLOObjectives
    for kw, msg in ((dict(latency_ms=-1), "latency_ms"),
                    (dict(availability=1.5), "availability"),
                    (dict(latency_ms=10, window_s=0), "window_s"),
                    (dict(latency_quantile=1.0), "latency_quantile")):
        with pytest.raises(ValueError, match=msg):
            O(**kw).validate()
    r = _tracker(m).evaluate(force=True)
    assert r["met"] is True and r["latency"]["burn_rate"] == 0.0


def test_slo_burn_rates_and_gauges(m):
    reg = m.registry.get_registry()
    hist = reg.histogram("serving_batch_ms", "e2e")
    recs = reg.counter("serving_records_total", "outcomes")
    tr = _tracker(m)
    tr.evaluate(force=True)
    for _ in range(95):
        hist.observe(10.0)
    for _ in range(5):
        hist.observe(500.0)
    recs.inc(100, outcome="served")
    recs.inc(2, outcome="failed")
    r = tr.evaluate(force=True)
    assert r["latency"]["burn_rate"] == pytest.approx(1.0, rel=0.25)
    assert r["availability"]["burn_rate"] == pytest.approx(2.0, rel=0.05)
    assert r["availability"]["met"] is False and r["met"] is False
    assert reg.get("slo_burn_rate").value(objective="availability") == \
        pytest.approx(2.0, rel=0.05)
    assert reg.get("slo_met").value(objective="all") == 0.0


def test_slo_auto_evaluator_and_engine_drive(m, caplog):
    reg = m.registry.get_registry()
    hist = reg.histogram("serving_batch_ms", "e2e")
    tr = _tracker(m, availability=None, window_s=5.0)
    tr.start_auto(interval_s=0.05)
    try:
        time.sleep(0.12)
        for _ in range(30):
            hist.observe(500.0)
        with caplog.at_level(logging.WARNING,
                             logger=f"{m.log_root}.observability"):
            wait_for(lambda: reg.get("slo_met").value(objective="all")
                     == 0.0, timeout_s=5.0, msg="SLO violation")
        assert any("SLO violated" in r.getMessage()
                   for r in caplog.records)
    finally:
        tr.stop_auto()
    assert tr._auto_thread is None
    _, im = m.linear()
    serving = m.server.ClusterServing(
        im, broker=m.broker.MemoryBroker(), batch_size=4,
        slo=m.slo.SLOObjectives(latency_ms=100.0, window_s=4.0)).start()
    try:
        assert serving.slo._auto_thread is not None
        assert "slo" in serving.health()
    finally:
        serving.stop()
    assert serving.slo._auto_thread is None


# ---------------------------------------------------------------------------
# the fleet plane's knobs, each doing its work (once refused by the port)
# ---------------------------------------------------------------------------
FLEET_KNOBS = {
    "heartbeat": dict(engine_id="e1", heartbeat_interval_s=0.05,
                      fleet_metrics_interval_s=0),
    "fleet_metrics": dict(engine_id="e1", heartbeat_interval_s=0,
                          fleet_metrics_interval_s=0.05),
    "defaults": dict(engine_id="e1"),
    "trace_sample": dict(trace_sample=0.5, trace_export_interval_s=0.05)}


@pytest.mark.parametrize("knobs", sorted(FLEET_KNOBS))
def test_fleet_plane_knobs_do_their_work(m, knobs):
    """Each knob starts its publisher on a broker connection of its own
    and the broker shows its work: a heartbeat row in `engines:<stream>`,
    a registry blob in `metrics:<stream>`, sampled spans in
    `traces:<stream>`. A clean stop deregisters the heartbeat row."""
    kw = FLEET_KNOBS[knobs]
    im = m.fn_model("double")
    br = m.broker.MemoryBroker()
    cs = m.server.ClusterServing(im, br, registry=m.registry.MetricsRegistry(),
                                 batch_timeout_ms=2, **kw).start()
    beats = f"engines:{STREAM}"
    blobs = f"metrics:{STREAM}"
    traces = f"traces:{STREAM}"
    try:
        # a uri the 0.5 head sample keeps (the sampler is deterministic)
        uri = next(f"u{i}" for i in range(64)
                   if m.trace_plane.should_sample(f"u{i}", 0.5))
        q = m.client.InputQueue(br, trace_sample=kw.get("trace_sample",
                                                        0.0))
        q.enqueue(uri=uri, t=np.ones(2, np.float32))
        assert wait_results(m, br, [uri], timeout_s=20)
        if cs.heartbeat is not None:
            wait_for(lambda: br.hget(beats, "e1") is not None,
                     msg="heartbeat row")
            assert json.loads(br.hget(beats, "e1"))["ready"] is True
        if kw.get("fleet_metrics_interval_s"):
            wait_for(lambda: br.hget(blobs, "e1") is not None,
                     msg="registry blob")
            assert "serving_records_total" in json.loads(
                br.hget(blobs, "e1"))["counters"]
        if cs.trace_exporter is not None:
            wait_for(lambda: any(
                sp.get("id") == uri or uri in sp.get("ids", ())
                for blob in br.hgetall(traces).values()
                for sp in json.loads(blob)["spans"]),
                msg="sampled spans")
    finally:
        cs.stop()
    assert (cs.heartbeat is not None) == (knobs in ("heartbeat",
                                                    "defaults"))
    assert (cs.fleet_metrics is not None) == (knobs in ("fleet_metrics",
                                                        "defaults"))
    assert (cs.trace_exporter is not None) == (knobs == "trace_sample")
    assert br.hget(beats, "e1") is None


def test_engine_id_without_the_fleet_plane_names_the_consumer():
    im = InferenceModel(device="cpu").load_fn(lambda p, x: x * 2.0,
                                              nn.Module())
    reg = MetricsRegistry()
    br = MemoryBroker()
    cs = tserver.ClusterServing(im, br, engine_id="e7", registry=reg,
                                heartbeat_interval_s=0,
                                fleet_metrics_interval_s=0).start()
    try:
        out = InputQueue(br).predict(np.ones(2, np.float32), timeout_s=20)
        np.testing.assert_allclose(out, [2.0, 2.0])
    finally:
        cs.stop()
    assert cs.consumer == "e7" and cs.metrics()["engine_id"] == "e7"
    series = reg.get("serving_records_total").snapshot()["series"]
    assert series and all(s["labels"]["engine"] == "e7" for s in series)

