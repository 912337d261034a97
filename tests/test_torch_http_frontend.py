"""The port's HTTP front end (`serving/http_frontend.py`), each case run on
both packages through the `m` fixture: the token bucket, 429s on a flood,
TLS, `POST /model-secure` and the secret wait, `/healthz` through a
supervisor quarantine round trip, `POST /profile`, `/metrics` content
negotiation, `/trace` and the 405 / 404 route table. Held to the cases of
the JAX package's own tests: tests/test_serving_hardening.py
(`TestTokenBucket`, `TestRateLimitedFrontend`, `TestTLS`,
`TestTLSSlowClient`, `TestModelSecure` up to the encrypted load, which
waits for ROADMAP.md queue 1, item 8), tests/test_profiling_slo.py
(`TestHealthz`, `TestProfileEndpoint`) and tests/test_observability.py
(`TestFrontendObservability`). Then the slice: a 2-block, 32-wide BERT
classifier served by each package behind its `FrontEnd`, from the same
weights (`convert.params_from_jax`).
"""

import json
import os
import ssl
import subprocess
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
    IMPLS, STREAM, m, no_stray_threads, wait_for)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    for pkg in IMPLS.values():
        pkg.faults.clear()


def _post(url, payload, ctx=None, timeout=30):
    data = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data)
    return urllib.request.urlopen(req, timeout=timeout, context=ctx)


def _get(url, accept=None, method="GET", data=None, timeout=10):
    headers = {"Accept": accept} if accept else {}
    req = urllib.request.Request(url, headers=headers, method=method,
                                 data=data)
    return urllib.request.urlopen(req, timeout=timeout)


def _engine(m, im, broker, **kw):
    return m.server.ClusterServing(
        im, broker, registry=m.registry.MetricsRegistry(), **kw)


# ---------------------------------------------------------------------------
# tests/test_serving_hardening.py
# ---------------------------------------------------------------------------
def test_token_bucket_burst_then_throttle(m):
    tb = m.http_frontend.TokenBucket(tokens_per_second=5, capacity=3)
    assert [tb.try_acquire() for _ in range(3)] == [True] * 3
    assert tb.try_acquire() is False
    time.sleep(0.25)                  # ~1.25 tokens refilled
    assert tb.try_acquire() is True
    assert tb.try_acquire() is False


def test_token_bucket_timeout_waits_and_rate_checked(m):
    tb = m.http_frontend.TokenBucket(tokens_per_second=20, capacity=1)
    assert tb.try_acquire()
    t0 = time.monotonic()
    assert tb.try_acquire(timeout_ms=500)  # ~50ms until next token
    assert time.monotonic() - t0 < 0.5
    with pytest.raises(ValueError):
        m.http_frontend.TokenBucket(0)


def test_429_on_flood(m):
    _, im = m.linear()
    br = m.broker.MemoryBroker()
    serving = _engine(m, im, br).start()
    fe = m.http_frontend.FrontEnd(
        br, serving, host="127.0.0.1", port=0, tokens_per_second=3,
        token_bucket_capacity=3, token_acquire_timeout_ms=0,
        registry=m.registry.MetricsRegistry()).start()
    try:
        url = f"http://127.0.0.1:{fe.port}/predict"
        codes = []

        def hit():
            try:
                r = _post(url, {"instances": np.ones((1, 4)).tolist()})
                codes.append(r.getcode())
            except urllib.error.HTTPError as e:
                codes.append(e.code)

        threads = [threading.Thread(target=hit) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert codes.count(429) >= 6
        assert codes.count(200) >= 1
        assert set(codes) <= {200, 429}
    finally:
        fe.stop()
        serving.stop()


def test_no_limiter_admits_all(m):
    W, im = m.linear()
    br = m.broker.MemoryBroker()
    serving = _engine(m, im, br).start()
    fe = m.http_frontend.FrontEnd(br, serving, host="127.0.0.1", port=0,
                                  registry=m.registry.MetricsRegistry()
                                  ).start()
    try:
        url = f"http://127.0.0.1:{fe.port}/predict"
        for _ in range(5):
            r = _post(url, {"instances": np.ones((1, 4)).tolist()})
            assert r.getcode() == 200
            np.testing.assert_allclose(json.load(r)["predictions"],
                                       np.ones((1, 4)) @ W, rtol=1e-6)
    finally:
        fe.stop()
        serving.stop()


@pytest.fixture(scope="module")
def tls_cert(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    proc = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1",
         "-subj", "/CN=localhost"], capture_output=True)
    if proc.returncode != 0:
        pytest.skip("openssl unavailable for self-signed cert")
    return cert, key


def test_https_round_trip_and_stalled_handshake(m, tls_cert):
    import socket
    cert, key = tls_cert
    _, im = m.linear()
    br = m.broker.MemoryBroker()
    serving = _engine(m, im, br).start()
    fe = m.http_frontend.FrontEnd(br, serving, host="127.0.0.1", port=0,
                                  tls_certfile=cert, tls_keyfile=key,
                                  registry=m.registry.MetricsRegistry()
                                  ).start()
    stalled = None
    try:
        assert fe.tls
        ctx = ssl.create_default_context(cafile=cert)
        ctx.check_hostname = False  # CN=localhost vs 127.0.0.1
        url = f"https://127.0.0.1:{fe.port}"
        r = _post(url + "/predict",
                  {"instances": np.ones((2, 4)).tolist()}, ctx=ctx)
        assert np.asarray(json.loads(r.read())["predictions"]).shape == \
            (2, 3)
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{fe.port}/",
                                   timeout=5)
        # a client that connects and never handshakes stalls only itself
        stalled = socket.create_connection(("127.0.0.1", fe.port))
        time.sleep(0.2)
        r = _post(url + "/predict", {"instances": np.ones((1, 4)).tolist()},
                  ctx=ctx, timeout=15)
        assert r.getcode() == 200
    finally:
        if stalled is not None:
            stalled.close()
        fe.stop()
        serving.stop()


def test_post_model_secure_stores_on_broker(m):
    br = m.broker.MemoryBroker()
    fe = m.http_frontend.FrontEnd(br, None, host="127.0.0.1", port=0,
                                  registry=m.registry.MetricsRegistry()
                                  ).start()
    try:
        url = f"http://127.0.0.1:{fe.port}/model-secure"
        assert _post(url, b"secret=s3cr3t&salt=pepper").getcode() == 200
        key = m.http_frontend.MODEL_SECURED_KEY
        assert br.hget(key, "secret") == "s3cr3t"
        assert br.hget(key, "salt") == "pepper"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, b"garbage")
        assert ei.value.code == 500
    finally:
        fe.stop()


def test_wait_model_secret_times_out_reads_and_scrubs(m):
    wait = m.config.wait_model_secret
    with pytest.raises(TimeoutError):
        wait(m.broker.MemoryBroker(), timeout_s=0.3)
    key = m.http_frontend.MODEL_SECURED_KEY
    br = m.broker.MemoryBroker()
    br.hset(key, "secret", "s")
    br.hset(key, "salt", "t")
    assert wait(br, timeout_s=5) == ("s", "t")
    assert wait(br, timeout_s=5) == ("s", "t")     # left readable
    assert wait(br, timeout_s=5, scrub=True) == ("s", "t")
    assert br.hget(key, "secret") is None and br.hget(key, "salt") is None


# ---------------------------------------------------------------------------
# tests/test_profiling_slo.py TestHealthz, TestProfileEndpoint
# ---------------------------------------------------------------------------
def test_frontend_without_engine_is_alive_and_405(m):
    fe = m.http_frontend.FrontEnd(m.broker.MemoryBroker(), None,
                                  host="127.0.0.1", port=0,
                                  registry=m.registry.MetricsRegistry()
                                  ).start()
    try:
        r = _get(f"http://127.0.0.1:{fe.port}/healthz")
        body = json.loads(r.read())
        assert r.status == 200
        assert body["ready"] is True and body["engine"] is None
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"http://127.0.0.1:{fe.port}/healthz", b"")
        assert exc.value.code == 405
        assert exc.value.headers["Allow"] == "GET"
    finally:
        fe.stop()


def test_healthz_flips_through_supervisor_quarantine(m):
    _, im = m.linear(replicas=2)
    broker = m.broker.MemoryBroker()
    serving = _engine(
        m, im, broker, batch_size=1, batch_timeout_ms=2,
        failure_threshold=2, probe_interval_s=0.1,
        latency_floor_ms=2000.0,
        slo=m.slo.SLOObjectives(latency_ms=1000.0, window_s=30.0)).start()
    fe = m.http_frontend.FrontEnd(broker, serving, host="127.0.0.1",
                                  port=0,
                                  registry=m.registry.MetricsRegistry()
                                  ).start()
    base = f"http://127.0.0.1:{fe.port}"
    try:
        r = _get(base + "/healthz")
        body = json.loads(r.read())
        assert r.status == 200 and body["ready"] is True
        assert body["healthy_replicas"] == 2
        assert "slo" in body
        m.faults.inject("replica.dispatch", m.faults.Fault())
        inq = m.client.InputQueue(broker)
        deadline = time.monotonic() + 20
        while im.healthy_replicas() > 0 and time.monotonic() < deadline:
            inq.enqueue(t=np.ones((4,), np.float32))
            time.sleep(0.01)
        assert im.healthy_replicas() == 0
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(base + "/healthz")
        assert exc.value.code == 503
        payload = json.loads(exc.value.read())
        assert payload["ready"] is False
        assert "quarantined" in payload["reason"]
        assert int(exc.value.headers["Retry-After"]) >= 1
        assert payload["supervisor"]["healthy"] == 0
        m.faults.clear("replica.dispatch")
        wait_for(lambda: im.healthy_replicas() == 2, msg="pool revival")
        r = _get(base + "/healthz")
        assert r.status == 200 and json.loads(r.read())["ready"] is True
    finally:
        fe.stop()
        serving.stop()


@pytest.fixture()
def profiled(m, tmp_path):
    _, im = m.linear()
    broker = m.broker.MemoryBroker()
    serving = _engine(m, im, broker, batch_size=4,
                      batch_timeout_ms=2).start()
    fe = m.http_frontend.FrontEnd(
        broker, serving, host="127.0.0.1", port=0,
        profile_dir=str(tmp_path), profile_max_artifacts=2,
        registry=m.registry.MetricsRegistry()).start()
    yield fe, str(tmp_path)
    fe.stop()
    serving.stop()


def test_post_profile_returns_loadable_artifact(m, profiled):
    fe, root = profiled
    r = _post(f"http://127.0.0.1:{fe.port}/profile?seconds=0.3", b"")
    manifest = json.loads(r.read())
    assert r.status == 200
    assert manifest["dir"].startswith(root) and manifest["files"]
    assert m.observability.load_trace_events(manifest["dir"])
    assert any(name.startswith("serving-")
               for name in manifest["host_stacks"]["threads"])


def test_overlapping_profiles_409_and_rotation(m, profiled):
    fe, root = profiled
    url = f"http://127.0.0.1:{fe.port}/profile"
    results = {}

    def first():
        results["r"] = _post(url + "?seconds=1.2", b"").status

    t = threading.Thread(target=first)
    t.start()
    time.sleep(0.4)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(url + "?seconds=0.2", b"")
        assert exc.value.code == 409
    finally:
        t.join(timeout=30)
    assert results["r"] == 200
    for _ in range(2):
        assert _post(url + "?seconds=0.1", b"").status == 200
    dirs = [d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))]
    assert len(dirs) <= 2             # profile_max_artifacts=2


def test_bad_seconds_400_and_disabled_404(m, profiled):
    fe, _ = profiled
    for q in ("seconds=abc", "seconds=-1", "seconds=9999"):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"http://127.0.0.1:{fe.port}/profile?{q}", b"")
        assert exc.value.code == 400
    off = m.http_frontend.FrontEnd(m.broker.MemoryBroker(), None,
                                   host="127.0.0.1", port=0,
                                   profile_enabled=False,
                                   registry=m.registry.MetricsRegistry()
                                   ).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"http://127.0.0.1:{off.port}/profile?seconds=0.1", b"")
        assert exc.value.code == 404
        assert "disabled" in json.loads(exc.value.read())["error"]
    finally:
        off.stop()


# ---------------------------------------------------------------------------
# tests/test_observability.py TestFrontendObservability
# ---------------------------------------------------------------------------
def _parse_prometheus(text):
    types, samples = {}, []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
        elif line and not line.startswith("#"):
            head, _, value = line.rpartition(" ")
            name, _, rest = head.partition("{")
            labels = dict(p.split("=", 1) for p in rest.rstrip("}").split(
                ",") if p) if rest else {}
            samples.append((name, {k: v.strip('"')
                                   for k, v in labels.items()},
                            float(value)))
    return types, samples


@pytest.fixture()
def traced(m):
    broker = m.broker.MemoryBroker()
    serving = _engine(m, m.fn_model("double"), broker, batch_timeout_ms=1,
                      tracer=m.tracing.Tracer()).start()
    fe = m.http_frontend.FrontEnd(broker, serving, host="127.0.0.1",
                                  port=0,
                                  registry=serving.registry).start()
    yield fe
    fe.stop()
    serving.stop()


def test_metrics_content_negotiation_and_trace(m, traced):
    base = f"http://127.0.0.1:{traced.port}"
    body = json.dumps({"instances": [[1.0, 2.0]]}).encode()
    r = _get(base + "/predict", method="POST", data=body)
    assert json.load(r)["predictions"] == [[2.0, 4.0]]
    r = _get(base + "/metrics")
    assert r.headers["Content-Type"] == "application/json"
    payload = json.load(r)
    assert "registry" in payload and "batch" in payload
    r = _get(base + "/metrics", accept="text/plain")
    assert r.headers["Content-Type"].startswith("text/plain; version=0.0.4")
    types, samples = _parse_prometheus(r.read().decode())
    assert types.get("serving_stage_ms") == "histogram"
    stages = {lb.get("stage") for n, lb, _ in samples
              if n == "serving_stage_ms_count"}
    assert {"decode", "dispatch", "sink", "predict"} <= stages
    assert types.get("http_requests_total") == "counter"
    assert types.get("serving_queue_depth") == "gauge"
    doc = json.load(_get(base + "/trace"))
    assert {"decode", "dispatch", "sink"} <= \
        {e["name"] for e in doc["traceEvents"]}


@pytest.mark.parametrize("method,path,allow", [
    ("POST", "/metrics", "GET"), ("POST", "/trace", "GET"),
    ("GET", "/predict", "POST"), ("PUT", "/predict", "POST"),
    ("DELETE", "/metrics", "GET")])
def test_known_route_wrong_method_is_405(m, traced, method, path, allow):
    url = f"http://127.0.0.1:{traced.port}{path}"
    data = b"{}" if method in ("POST", "PUT") else None
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(url, method=method, data=data)
    assert ei.value.code == 405
    assert ei.value.headers["Allow"] == allow


def test_unknown_route_stays_404(m, traced):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(f"http://127.0.0.1:{traced.port}/nope")
    assert ei.value.code == 404


# ---------------------------------------------------------------------------
# the port's own: JSON integer instances stay int64 to the model
# ---------------------------------------------------------------------------
def test_port_instances_keep_integer_ids():
    from analytics_zoo_tpu_torch.serving.http_frontend import \
        instances_array
    ids = instances_array([[1, 2, 3], [4, 5, 6]])
    assert ids.dtype == np.int64 and ids.shape == (2, 3)
    assert instances_array([[1, 2.5]]).dtype == np.float32
    assert instances_array([[True, False]]).dtype == np.float32


# ---------------------------------------------------------------------------
# the slice: BERT behind each package's FrontEnd, the same weights
# ---------------------------------------------------------------------------
BERT_CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=8,
                intermediate_size=64)


@pytest.fixture(scope="module")
def bert_models():
    jm = JClassifier(3, use_flash=True, **BERT_CFG)
    params = jax.device_get(jm.build(jax.random.PRNGKey(3)))
    tm = BERTClassifier(3, use_flash=True, device="cpu", **BERT_CFG)
    tm.load_state_dict(convert.params_from_jax(params))
    return {"jax": (jm, params), "port": (tm, None)}


def _serve_bert(m, bert_models):
    net, params = bert_models[m.name]
    if m.name == "jax":
        im = m.inference_model.InferenceModel(max_batch=4).load_keras(
            net, params=params)
    else:
        im = m.inference_model.InferenceModel(
            max_batch=4, device="cpu").load_keras(net)
    im.warmup(np.zeros(BERT_CFG["seq_len"], np.int64))
    broker = m.broker.MemoryBroker()
    serving = _engine(m, im, broker, batch_size=4, engine_id="bert-e1",
                      heartbeat_interval_s=0.05,
                      fleet_metrics_interval_s=0.05).start()
    fe = m.http_frontend.FrontEnd(broker, serving, host="127.0.0.1",
                                  port=0, fleet_stream=STREAM,
                                  engine_ttl_s=5.0,
                                  registry=m.registry.MetricsRegistry()
                                  ).start()
    return serving, fe


def test_bert_slice_behind_the_front_end(bert_models):
    rows = np.random.RandomState(5).randint(
        0, BERT_CFG["vocab"], (6, BERT_CFG["seq_len"])).astype(np.int64)
    answers, health_keys, metric_keys = {}, {}, {}
    for name, m in IMPLS.items():
        serving, fe = _serve_bert(m, bert_models)
        base = f"http://127.0.0.1:{fe.port}"
        try:
            got = []
            for row in rows:         # one b64 int64 record a request
                payload = m.broker.encode_ndarray(row)
                got.append(json.load(_post(base + "/predict",
                                           payload))["predictions"])
            answers[name] = np.asarray(got, np.float64)
            if name == "port":
                # JSON integer instances reach the port's model as int64
                # ids (the JAX package casts every instance to float32)
                batch = json.load(_post(base + "/predict", {
                    "instances": rows.tolist()}))["predictions"]
            wait_for(lambda: "bert-e1" in (fe.fleet.poll(force=True) or {}),
                     msg="heartbeat row")
            health = json.load(_get(base + "/healthz"))
            health_keys[name] = (sorted(health),
                                 sorted(health["fleet"]["engines"]
                                        ["bert-e1"]))
            wait_for(lambda: "fleet_scrape_age_s" in _get(
                base + "/metrics", accept="text/plain").read().decode(),
                msg="fleet metrics blob")
            metrics = json.load(_get(base + "/metrics"))
            # the JAX engine's "compile_cache" section counts XLA
            # executables; the port has no compile cache (ROADMAP.md
            # queue 1, item 1)
            metric_keys[name] = (sorted(set(metrics) - {"compile_cache"}),
                                 sorted(metrics["fleet"]))
        finally:
            fe.stop()
            serving.stop()
    assert answers["port"].shape == (6, 3)
    np.testing.assert_allclose(answers["port"], answers["jax"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(batch), answers["jax"], rtol=0,
                               atol=1e-5)
    assert health_keys["port"] == health_keys["jax"]
    assert metric_keys["port"] == metric_keys["jax"]
