"""HTTP frontend — the akka-http gateway analogue
(`serving/http/FrontEndApp.scala:126-232`).

Copied from `analytics_zoo_tpu/serving/http_frontend.py` (L1-1046):
`TokenBucket` (L58), `_Handler` (L93) with every route, `_FrontEndServer`
and `FrontEnd`. What differs in the port: a `{"instances": ...}` body of
integers (token ids) is enqueued as int64 rows, where the JAX package
casts every instance to float32; a body with any non-integer number
stays float32. The engine keeps a record's dtype from the codec header to
the card, so ids reach an embedding as int64. `POST /profile` captures
with `torch.profiler` (`observability/capture.py`).

Routes preserved: `POST /predict` (sync prediction: enqueue to the broker,
await the result — `FrontEndApp.scala:163`), `GET /metrics` (timer snapshots
as JSON, `:131,241` — with a pipelined ClusterServing attached this
includes per-stage decode/dispatch/sink p50/p95/p99 and live queue-depth
gauges, so an operator can see which stage is the bottleneck), `POST
/model-secure` ("secret=xxx&salt=yyy" stored on the broker for
encrypted-model loading, `:140-152`), plus `GET /` liveness
("welcome to analytics zoo web serving frontend").

Hardening, matching the reference's front-end options:
- token-bucket rate limiting (`FrontEndApp.scala:59-60` guava RateLimiter,
  `tryAcquire` at `:167`): `tokens_per_second` caps admission; a request
  that can't get a token within `token_acquire_timeout_ms` is rejected
  with 429.
- TLS (`:225-227` httpsEnabled/keystore): pass `tls_certfile`/`tls_keyfile`
  (PEM) and the listener speaks HTTPS via stdlib ssl.

Stdlib ThreadingHTTPServer: no extra dependency, one thread per in-flight
request, the device work itself is serialized by the serving loop behind
the broker."""

from __future__ import annotations

import json
import os
import ssl
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union
from urllib.parse import parse_qs

import numpy as np

from analytics_zoo_tpu_torch.observability.prometheus import (
    CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE, render_prometheus)
from analytics_zoo_tpu_torch.observability.registry import (MetricsRegistry,
                                                      get_registry)
from analytics_zoo_tpu_torch.serving.broker import Broker, connect_broker
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.server import ClusterServing
from analytics_zoo_tpu_torch.serving.timer import Timer

# broker keys for the model-secure flow (`Conventions.scala:33-35`)
MODEL_SECURED_KEY = "model_secured"
MODEL_SECURED_SECRET = "secret"
MODEL_SECURED_SALT = "salt"

# route tables: a known route hit with the wrong method answers 405 with
# an Allow header (silent 404s made method typos indistinguishable from
# wrong URLs); unknown paths stay 404
ROUTES_GET = ("/", "/metrics", "/trace", "/healthz", "/rollout/status")
ROUTES_POST = ("/predict", "/model-secure", "/profile", "/rollout")


def instances_array(instances) -> np.ndarray:
    """The rows of a `{"instances": [...]}` body: int64 when every value
    is an integer (token ids keep their type to the embedding), else
    float32 (the JAX package's cast for every body)."""
    arr = np.asarray(instances)
    if arr.dtype.kind in "iu":
        return arr.astype(np.int64)
    return arr.astype(np.float32)


class TokenBucket:
    """Continuous-refill token bucket (the guava RateLimiter role,
    `FrontEndApp.scala:59`). Thread-safe; `try_acquire` waits up to the
    given timeout for a token."""

    def __init__(self, tokens_per_second: float,
                 capacity: Optional[float] = None):
        if tokens_per_second <= 0:
            raise ValueError("tokens_per_second must be > 0")
        self.rate = float(tokens_per_second)
        self.capacity = float(capacity if capacity is not None
                              else max(1.0, tokens_per_second))
        self._tokens = self.capacity
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.capacity,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_acquire(self, timeout_ms: float = 0.0) -> bool:
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            with self._lock:
                now = time.monotonic()
                self._refill(now)
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return True
                wait = min((1.0 - self._tokens) / self.rate,
                           deadline - now)
            if wait <= 0:
                return False
            time.sleep(wait)


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet
        pass

    def _count_request(self, code: int):
        counter = getattr(self.server, "http_requests", None)
        if counter is not None:
            route = self.path.split("?", 1)[0]
            if route.startswith("/trace/"):
                # per-request trace ids must not explode label
                # cardinality — every /trace/<id>[/summary] hit counts
                # as the one /trace route
                route = "/trace"
            if route not in ROUTES_GET and route not in ROUTES_POST:
                route = "other"   # bound label cardinality against scans
            counter.inc(route=route, code=str(code),
                        method=self.command or "GET")

    def _send_bytes(self, code: int, body: bytes, content_type: str,
                    allow: Optional[str] = None,
                    extra_headers: Optional[dict] = None):
        self._count_request(code)
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if allow:
            self.send_header("Allow", allow)
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _send(self, code: int, payload, allow: Optional[str] = None,
              extra_headers: Optional[dict] = None):
        self._send_bytes(code, json.dumps(payload).encode(),
                         "application/json", allow=allow,
                         extra_headers=extra_headers)

    def _method_not_allowed(self, allow: str):
        self._send(405, {"error": f"method {self.command} not allowed; "
                                  f"allowed: {allow}"}, allow=allow)

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path == "/":
            payload = {"message": "welcome to analytics zoo web "
                                  "serving frontend"}
            serving = self.server.serving
            # deployment at a glance: replicated-vs-sharded, replica
            # count, device count (mesh axes when sharded); guarded like
            # server.py — the engine only requires predict_async, so a
            # duck-typed model must not break the liveness probe
            info = getattr(getattr(serving, "model", None),
                           "placement_info", None)
            if info is not None:
                payload["placement"] = info()
            self._send(200, payload)
        elif path == "/metrics":
            self._metrics()
        elif path == "/trace":
            self._trace()
        elif path.startswith("/trace/"):
            self._trace_request(path)
        elif path == "/healthz":
            self._healthz()
        elif path == "/rollout/status":
            self._rollout_status()
        elif path in ROUTES_POST:
            self._method_not_allowed("POST")
        else:
            self._send(404, {"error": "not found"})

    def _rollout_status(self):
        """Live rollout view: the controller's state machine
        on a gateway, the agent's last-swap record on an engine; 404
        when no rollout is wired."""
        rollout = self.server.rollout
        if rollout is None:
            self._send(404, {"error": "rollout not configured; start "
                                      "with params.rollout.model_dir "
                                      "(engine) or gateway "
                                      "--rollout-dir (controller)"})
            return
        try:
            self._send(200, rollout.status())
        except Exception as e:  # noqa: BLE001 — a probe must answer
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def _rollout(self):
        """`POST /rollout`: ask the controller to converge
        the fleet — body `{"version": N}` pins a published version
        (manual roll-forward OR rollback); an empty body just pokes the
        watcher. 409 on a quarantined version, 404 on an unpublished
        one or when no controller runs here."""
        rollout = self.server.rollout
        if rollout is None or not hasattr(rollout, "request"):
            self._send(404, {"error": "no rollout controller on this "
                                      "frontend (engines follow "
                                      "directives; POST to the "
                                      "gateway)"})
            return
        version = None
        unpin = False
        try:
            body = self._read_body()
            if body.strip():
                req = json.loads(body)
                if isinstance(req, dict):
                    if req.get("version") is not None:
                        version = int(req["version"])
                    unpin = bool(req.get("unpin"))
        except (TypeError, ValueError) as e:
            self._send(400, {"error": f"bad body: {e}"})
            return
        try:
            status = rollout.request(version, unpin=unpin)
        except ValueError as e:       # quarantined
            self._send(409, {"error": str(e)})
            return
        except FileNotFoundError as e:
            self._send(404, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — frontend must not die
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(202, status)

    def _metrics(self):
        """Content negotiation: `Accept: text/plain` (Prometheus scrape)
        gets 0.0.4 exposition text of the process-wide registry —
        serving per-stage histograms, queue gauges, HTTP counters, and
        any training metrics published in-process; everything else keeps
        the original JSON timer snapshot (now with the registry snapshot
        alongside)."""
        accept = self.headers.get("Accept", "") or ""
        registry: MetricsRegistry = self.server.registry
        # freshen the SLO gauges before ANY exposition: a Prometheus-only
        # deployment (text scrape) must see slo_burn_rate/slo_met move
        # without anything polling /healthz (the tracker rate-limits
        # itself, so per-scrape evaluation is one window sample)
        slo = getattr(self.server.serving, "slo", None) \
            if self.server.serving else None
        if slo is not None:
            try:
                slo.evaluate()
            except Exception:  # noqa: BLE001 — scrape must answer
                pass
        if "text/plain" in accept or "openmetrics" in accept:
            agg = self.server.fleet_metrics
            if agg is not None:
                # fleet scrape: merge every alive engine's
                # published registry blob with the gateway's own —
                # counters summed into scope="fleet" rollups, histograms
                # merged bucket-wise, gauges engine-labeled. A merge
                # failure degrades to the local registry: the scrape
                # must always answer.
                try:
                    registry = agg.merged(registry)
                except Exception:  # noqa: BLE001
                    pass
            self._send_bytes(200, render_prometheus(registry).encode(),
                             PROMETHEUS_CONTENT_TYPE)
            return
        serving: Optional[ClusterServing] = self.server.serving
        timers = {"frontend": self.server.request_timer.snapshot()}
        if serving is not None:
            timers.update(serving.metrics())
        if self.server.fleet is not None:
            # gateway view: per-engine heartbeat rows plus
            # the alive/ready counts the `serving_engines_*` families
            # export to Prometheus
            timers["fleet"] = self.server.fleet.summary()
        if self.server.fleet_metrics is not None:
            timers["fleet_metrics"] = self.server.fleet_metrics.summary()
        timers["registry"] = registry.snapshot()
        self._send(200, timers)

    def _healthz(self):
        """Readiness probe: with a LOCAL engine attached,
        aggregates its supervisor/quarantine/breaker/SLO state via
        `ClusterServing.health()` — 200 while the engine can accept
        traffic, 503 (with Retry-After on a quarantined pool) when it
        cannot. With FLEET tracking configured (the gateway role), the
        claim is about the fleet: 200 while >= 1 engine heartbeats
        alive+ready, 503 + Retry-After when none do — or when the
        broker itself is unreachable, since then the gateway can
        neither know the fleet nor move a record. Only a truly
        standalone frontend (no engine, no fleet) keeps the legacy
        unconditional 200 with `engine: null` — it is alive as a
        gateway; readiness of engines it doesn't track is not its
        claim to make."""
        serving = self.server.serving
        fleet = self.server.fleet
        gateway = self._gateway_block()
        health_fn = getattr(serving, "health", None) if serving else None
        if not callable(health_fn):
            if fleet is None:
                payload = {"ready": True, "engine": None}
                if gateway is not None:
                    payload["gateway"] = gateway
                self._send(200, payload)
                return
            summary = fleet.summary()
            ready = summary.get("ready")
            payload = {"ready": bool(ready), "engine": None,
                       "fleet": summary}
            if gateway is not None:
                payload["gateway"] = gateway
            if ready:
                self._send(200, payload)
                return
            payload["reason"] = "broker unreachable" \
                if summary.get("broker") == "unreachable" \
                else "no serving engine alive"
            self._send(503, payload, extra_headers={
                "Retry-After": str(fleet.retry_after_s)})
            return
        try:
            h = health_fn()
        except Exception as e:  # noqa: BLE001 — a probe must answer
            self._send(503, {"ready": False,
                             "reason": f"{type(e).__name__}: {e}"})
            return
        if fleet is not None:
            h["fleet"] = fleet.summary()
        if gateway is not None:
            h["gateway"] = gateway
        if h.get("ready"):
            self._send(200, h)
        else:
            retry_s = getattr(serving, "retry_after_s", 1)
            self._send(503, h,
                       extra_headers={"Retry-After": str(retry_s)})

    def _gateway_block(self) -> Optional[dict]:
        """Replicated-gateway identity for /healthz: which
        replica answered, its current role, and who it believes leads.
        None on a frontend running without a gateway_id."""
        lease = getattr(self.server, "leader_lease", None)
        if lease is None:
            return None
        return {"id": lease.gateway_id,
                "role": "leader" if lease.is_leader() else "follower",
                "leader": lease.leader()}

    def _profile(self):
        """`POST /profile?seconds=N`: one bounded torch.profiler
        capture into the frontend's rotated artifact dir, with the
        host-side stack-sampler report for the serving pipeline threads
        alongside. Single-flight: a second POST while one runs gets 409
        (two concurrent profiler sessions would corrupt each other).
        Blocks the requesting connection for the capture window — that
        is the point; other requests ride their own handler threads."""
        from analytics_zoo_tpu_torch.observability.capture import (
            MAX_CAPTURE_SECONDS, CaptureActiveError)
        qs = parse_qs(self.path.partition("?")[2])
        try:
            seconds = float(qs.get("seconds", ["2"])[0])
        except ValueError:
            self._send(400, {"error": "seconds must be a number"})
            return
        if not (0 < seconds <= MAX_CAPTURE_SECONDS):
            self._send(400, {"error": f"seconds must be in "
                                      f"(0, {MAX_CAPTURE_SECONDS:g}]"})
            return
        capture = self.server.profile_capture
        if capture is None:
            self._send(404, {"error": "profiling disabled "
                                      "(params.profile_enabled: false)"})
            return
        try:
            manifest = capture.capture(seconds, tag="http")
        except CaptureActiveError as e:
            self._send(409, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — frontend must not die
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(200, manifest)

    def _trace(self):
        """Chrome trace-event JSON of the serving pipeline's spans
        (open in Perfetto); 404 when no tracer is attached."""
        serving: Optional[ClusterServing] = self.server.serving
        tracer = getattr(serving, "tracer", None) if serving else None
        if tracer is None:
            self._send(404, {"error": "tracing not enabled; attach a "
                                      "Tracer to ClusterServing"})
            return
        self._send(200, tracer.chrome_trace())

    def _trace_request(self, path: str):
        """`GET /trace/<request_id>`: ONE merged
        cross-process Chrome timeline for the request, assembled from
        every engine's published span blobs — served from broker state,
        so ANY gateway replica answers identically.
        `GET /trace/<request_id>/summary` instead returns the
        critical-path breakdown (wire / queue / decode / device /
        writeback milliseconds) plus span coverage of the request
        window."""
        from urllib.parse import unquote
        collector = self.server.trace_collector
        if collector is None:
            self._send(404, {"error": "trace collection not available "
                                      "on this frontend"})
            return
        rest = path[len("/trace/"):]
        want_summary = False
        if rest.endswith("/summary"):
            want_summary = True
            rest = rest[:-len("/summary")]
        request_id = unquote(rest)
        if not request_id:
            self._send(400, {"error": "empty request id"})
            return
        try:
            out = (collector.summary(request_id) if want_summary
                   else collector.assemble(request_id))
        except Exception as e:  # noqa: BLE001 — frontend must not die
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if out is None:
            self._send(404, {
                "error": f"no published spans cover request id "
                         f"{request_id!r} (not sampled, expired from "
                         "the export window, or not yet published)"})
            return
        self._send(200, out)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length)

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        if path == "/model-secure":
            self._model_secure()
            return
        if path == "/profile":
            self._profile()
            return
        if path == "/rollout":
            self._rollout()
            return
        if path != "/predict":
            if path in ROUTES_GET:
                self._method_not_allowed("GET")
            else:
                self._send(404, {"error": "not found"})
            return
        limiter: Optional[TokenBucket] = self.server.rate_limiter
        if limiter is not None and not limiter.try_acquire(
                self.server.token_acquire_timeout_ms):
            # `FrontEndApp.scala:167` tryAcquire failure → reject
            self._send(429, {"error": "too many requests"})
            return
        # tiered admission: the cheap early 429. The tier
        # arrives in the header (wins) or the "tier" body field —
        # "cheap" means the record never touches the broker and no
        # engine capacity is spent; the body is parsed early ONLY when
        # admission needs the field spelling (with no admission
        # configured, the quarantine/dead-fleet 503 gates below keep
        # answering without paying a body parse). Backlog past the
        # requester's tier threshold → reject with a Retry-After; the
        # expensive 503s below stay the last line, and a batch job's
        # burst throttles long before a premium tenant feels it.
        tier = self.headers.get(self.server.admission_header) or None
        req = None
        admission = self.server.admission
        if admission is not None:
            if tier is None:
                try:
                    req = json.loads(self._read_body())
                except Exception as e:  # noqa: BLE001 — must not die
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                if isinstance(req, dict):
                    tier = req.pop("tier", None)
            ok, retry_s = admission.admit(tier)
            if not ok:
                self._send(429, {
                    "error": "backlog over this tier's admission "
                             "threshold; retry shortly",
                    "tier": admission.tiers.name(
                        admission.tiers.level(tier))},
                    extra_headers={
                        "Retry-After": str(max(1, int(round(retry_s))))})
                return
        # every model replica quarantined: answer 503 +
        # Retry-After sized to the canary-probe cadence instead of
        # letting the request hang to its timeout behind a fully-sick
        # pool. The records already in the pipeline wait for revival;
        # new admissions are the frontend's to refuse.
        serving = self.server.serving
        if serving is not None:
            healthy_fn = getattr(serving, "healthy_replicas", None)
            if callable(healthy_fn) and healthy_fn() == 0:
                retry_s = getattr(serving, "retry_after_s", 1)
                self._send(503, {"error": "every model replica is "
                                          "quarantined; retry shortly"},
                           extra_headers={"Retry-After": str(retry_s)})
                return
        elif self.server.fleet is not None:
            # gateway role: with zero engines alive the
            # record would sit in the stream until its client timeout —
            # refuse admission up front, like the quarantined-pool 503
            if not self.server.fleet.alive_count():
                self._send(503, {"error": "no serving engine alive; "
                                          "retry shortly"},
                           extra_headers={"Retry-After": str(
                               self.server.fleet.retry_after_s)})
                return
        qs = parse_qs(self.path.split("?", 1)[1]) \
            if "?" in self.path else {}
        with self.server.request_timer.timing():
            try:
                if req is None:
                    req = json.loads(self._read_body())
                if tier is None and isinstance(req, dict):
                    # field spelling still rides to the engine's tiered
                    # scheduler even without gateway admission
                    tier = req.pop("tier", None)
                if qs.get("stream", ["0"])[0] in ("1", "true"):
                    # generative streaming: SSE per token
                    self._predict_stream(req, tier)
                    return
                # {"instances": [[...], ...]} tf-serving-style (each
                # instance is ONE serving record — they batch inside the
                # serving loop), or {"b64","dtype","shape"} raw tensor
                if "instances" in req:
                    arr = instances_array(req["instances"])
                    uris, t_ing, t0 = self._request_ids(len(arr))
                    results = self.server.input_queue.predict_batch(
                        arr, timeout_s=self.server.timeout_s, tier=tier,
                        uris=uris)
                    self._gateway_span(uris, t_ing, t0)
                    if any(r == "SHED" for r in results
                           if isinstance(r, str)):
                        self._shed_response(
                            shed=sum(1 for r in results if isinstance(
                                r, str) and r == "SHED"),
                            total=len(results))
                    elif any(isinstance(r, float) and np.isnan(r)
                             for r in results):
                        self._send(500, {"error": "inference failure (NaN)"})
                    else:
                        payload = {"predictions": np.asarray(results)
                                   .tolist()}
                        if uris is not None:
                            payload["request_ids"] = uris
                        self._send(200, payload)
                    return
                from analytics_zoo_tpu_torch.serving.broker import \
                    decode_ndarray
                arr = decode_ndarray(req)
                uris, t_ing, t0 = self._request_ids(1)
                result = self.server.input_queue.predict(
                    arr, timeout_s=self.server.timeout_s, tier=tier,
                    uri=uris[0] if uris else None)
                self._gateway_span(uris, t_ing, t0)
                if isinstance(result, str) and result == "SHED":
                    self._shed_response()
                elif isinstance(result, float) and np.isnan(result):
                    self._send(500, {"error": "inference failure (NaN)"})
                else:
                    payload = {"predictions": np.asarray(result)
                               .tolist()}
                    if uris is not None:
                        payload["request_ids"] = uris
                    self._send(200, payload)
            except Exception as e:  # noqa: BLE001 — frontend must not die
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    def _predict_stream(self, req, tier):
        """`POST /predict?stream=1` — server-sent events for one
        generative request (decode-mode engines). The body
        carries ``{"prompt": [token ids...], "max_new": N, "eos": id}``;
        the record is enqueued with the ``stream`` flag so the engine
        writes per-token rows, and this handler relays each row as one
        ``data:`` event the moment its poll sweep sees it, closing with
        an ``event: done`` carrying the full token array (exactly what
        the non-streaming path would have returned). One request per
        SSE response — batching streams would interleave sequences on
        one ordered connection.

        Streaming continuity: every token frame carries an
        SSE ``id:`` line (the token index), idle gaps emit periodic
        ``: keepalive`` comments so proxies hold the connection open,
        and a dropped client reconnects by POSTing its ``request_id``
        with a ``Last-Event-ID`` header (or ``last_event_id`` body
        field) — the record is NOT re-enqueued; the relay resumes from
        the durable token rows at ``last + 1``, so every index is
        observed exactly once across connections. When no row lands for
        the stall window AND the fleet's heartbeats flatline, the relay
        closes with ``event: error`` (``engine-dead``) instead of
        hanging to the timeout."""
        last_id = self.headers.get("Last-Event-ID")
        if last_id is None and isinstance(req, dict):
            last_id = req.get("last_event_id")
        resume_uri = req.get("request_id") if isinstance(req, dict) \
            else None
        start = 0
        if resume_uri is not None:
            # reconnect: the stream already exists under this uri —
            # re-enqueueing would decode the prompt a second time
            if last_id is not None:
                try:
                    start = int(last_id) + 1
                except (TypeError, ValueError):
                    self._send(400, {
                        "error": "Last-Event-ID must be the integer "
                                 "index of the last token frame "
                                 "received"})
                    return
            uri = str(resume_uri)
            uris, t_ing, t0 = None, 0.0, 0.0
        else:
            prompt = req.get("prompt") if isinstance(req, dict) else None
            if prompt is None and isinstance(req, dict) \
                    and len(req.get("instances") or []) == 1:
                prompt = req["instances"][0]
            if prompt is None:
                self._send(400, {"error": "streaming /predict needs a "
                                          "\"prompt\" token-id list "
                                          "(or one-element \"instances\")"})
                return
            arr = np.asarray(prompt, np.int32).reshape(-1)
            uris, t_ing, t0 = self._request_ids(1)
            uri = uris[0] if uris else str(uuid.uuid4())
            extra = {}
            if isinstance(req, dict) and "max_new" in req:
                extra["max_new"] = int(req["max_new"])
            if isinstance(req, dict) and "eos" in req:
                extra["eos"] = int(req["eos"])
            self.server.input_queue.enqueue(uri, tier=tier, t=arr,
                                            stream=1, **extra)
        self._count_request(200)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        # the reconnect handle, known BEFORE any frame arrives (the
        # done payload repeats it, but a dropped connection never saw
        # that)
        self.send_header("X-Request-Id", uri)
        self.end_headers()
        replayed = 0
        try:
            for evt in self.server.output_queue.stream_tokens(
                    uri, timeout_s=self.server.timeout_s, start=start,
                    keepalive_s=self.server.stream_keepalive_s,
                    stall_timeout_s=self.server.stream_stall_timeout_s):
                if evt.get("keepalive"):
                    # SSE comment: ignored by clients, resets proxy
                    # idle timers, never advances Last-Event-ID
                    self.wfile.write(b": keepalive\n\n")
                elif evt.get("done"):
                    if evt.get("error"):
                        payload = {"error": evt["error"],
                                   "request_id": uri}
                        name = b"error" if evt["error"] == "engine-dead" \
                            else b"done"
                        self.wfile.write(
                            b"event: " + name + b"\ndata: "
                            + json.dumps(payload).encode() + b"\n\n")
                    else:
                        payload = {"tokens":
                                   np.asarray(evt["tokens"]).tolist(),
                                   "gen": evt.get("gen", {}),
                                   "request_id": uri}
                        self.wfile.write(
                            b"event: done\ndata: "
                            + json.dumps(payload).encode() + b"\n\n")
                else:
                    if resume_uri is not None:
                        replayed += 1
                    self.wfile.write(
                        b"id: " + str(evt["i"]).encode() + b"\ndata: "
                        + json.dumps(evt).encode() + b"\n\n")
                self.wfile.flush()
            if uris:
                self._gateway_span(uris, t_ing, t0)
        except TimeoutError:
            self.wfile.write(b"event: error\ndata: "
                             b"{\"error\": \"timeout\"}\n\n")
            self.wfile.flush()
        finally:
            if replayed:
                self.server.token_replays.inc(replayed,
                                              surface="frontend")

    def _request_ids(self, n: int):
        """Pre-generated request ids (= trace ids) for a traced
        `/predict`: returned to the client as `request_ids` so
        `GET /trace/<id>` is addressable, and used as the enqueued
        records' uris so every engine span carries the same id.
        `(None, ..)` when gateway tracing is off — the wire payload
        stays byte-identical to the untraced frontend."""
        t_ing = time.time()
        t0 = time.perf_counter()
        if self.server.gateway_tracer is None:
            return None, t_ing, t0
        return [str(uuid.uuid4()) for _ in range(n)], t_ing, t0

    def _gateway_span(self, uris, t_ing: float, t0: float):
        """The gateway's own hop on the request timeline: enqueue →
        result readback, anchored on the ingest wall clock (`t_ingest`
        is the collector's skew-safe anchor for this process)."""
        tracer = self.server.gateway_tracer
        if tracer is None or not uris:
            return
        tracer.add_span("gateway_request", t0, time.perf_counter(),
                        cat="serving.gateway", trace_ids=uris,
                        args={"t_ingest": t_ing})

    def _shed_response(self, shed=None, total=None):
        """The engine shed this record under overload: an
        explicit 503 with Retry-After — the record was answered, not
        lost, and the client should back off like any overload. For a
        multi-instance request the shed/total counts say how much of
        the batch was actually refused — a retry of the whole request
        recomputes the served siblings too, so clients under overload
        should shrink their batches (or raise their tier)."""
        admission = self.server.admission
        retry_s = admission.retry_after_s if admission is not None else 1
        payload = {"error": "record shed under overload; retry shortly"}
        if shed is not None:
            payload["shed"] = shed
            payload["total"] = total
        self._send(503, payload,
                   extra_headers={
                       "Retry-After": str(max(1, int(round(retry_s))))})

    def _unsupported_method(self):
        path = self.path.split("?", 1)[0]
        if path in ROUTES_GET:
            self._method_not_allowed("GET")
        elif path in ROUTES_POST:
            self._method_not_allowed("POST")
        else:
            self._send(404, {"error": "not found"})

    do_PUT = _unsupported_method
    do_DELETE = _unsupported_method
    do_PATCH = _unsupported_method

    def _model_secure(self):
        """`FrontEndApp.scala:140-152`: body `secret=xxx&salt=yyy` → broker
        hash, where the serving side polls for it before decrypting an
        encrypted model."""
        try:
            fields = parse_qs(self._read_body().decode(),
                              strict_parsing=True)
            secret = fields["secret"][0]
            salt = fields["salt"][0]
            broker: Broker = self.server.broker
            broker.hset(MODEL_SECURED_KEY, MODEL_SECURED_SECRET, secret)
            broker.hset(MODEL_SECURED_KEY, MODEL_SECURED_SALT, salt)
            self._send(200, {"message": "model secured secret and salt "
                                        "succeed to put on broker"})
        except Exception as e:  # noqa: BLE001
            self._send(500, {"error": f"{type(e).__name__}: {e}; please "
                             "post a content like secret=xxx&salt=xxxx"})


class _FrontEndServer(ThreadingHTTPServer):
    """TLS is wrapped per-connection in the handler thread (not on the
    listening socket): a client that connects and never handshakes must
    stall only its own thread, not the accept loop."""

    ssl_context: Optional[ssl.SSLContext] = None
    handshake_timeout_s: float = 10.0

    def finish_request(self, request, client_address):
        if self.ssl_context is not None:
            request.settimeout(self.handshake_timeout_s)
            try:
                request = self.ssl_context.wrap_socket(request,
                                                       server_side=True)
            except (ssl.SSLError, OSError):
                # bad/absent handshake (port scan, slow-loris, plain HTTP
                # against the TLS port): drop the connection quietly
                request.close()
                return
            request.settimeout(None)
        self.RequestHandlerClass(request, client_address, self)


class FrontEnd:
    """`FrontEndApp` equivalent: HTTP(S) server in front of a broker
    stream, with optional token-bucket admission control."""

    def __init__(self, broker: Union[Broker, str, None] = None,
                 serving: Optional[ClusterServing] = None,
                 host: str = "0.0.0.0", port: int = 10020,
                 timeout_s: float = 30.0,
                 tokens_per_second: Optional[float] = None,
                 token_bucket_capacity: Optional[float] = None,
                 token_acquire_timeout_ms: float = 100.0,
                 tls_certfile: Optional[str] = None,
                 tls_keyfile: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 profile_dir: Optional[str] = None,
                 profile_max_artifacts: int = 8,
                 profile_enabled: bool = True,
                 fleet_stream: Optional[str] = None,
                 engine_ttl_s: float = 6.0,
                 admission=None,
                 admission_header: str = "X-Priority",
                 rollout=None,
                 partitions: int = 1,
                 gateway_id: Optional[str] = None,
                 leader_ttl_s: float = 3.0,
                 trace_sample: float = 0.0,
                 trace_buffer_spans: int = 20000,
                 trace_export_interval_s: float = 0.5,
                 stream_keepalive_s: Optional[float] = None,
                 stream_stall_timeout_s: Optional[float] = None):
        """`fleet_stream` turns the frontend into a fleet
        gateway: a `FleetTracker` watches engine heartbeats on
        `engines:<fleet_stream>`, `/healthz` answers for the FLEET
        (200 while >= 1 engine is alive+ready, 503 + Retry-After when
        none are), and `serving_engines_alive`/`serving_engines_total`
        appear on `/metrics`. An engine is alive while its heartbeat
        keeps progressing within `engine_ttl_s` (observed on this
        host's clock — cross-host skew can't flap the fleet).

        `admission`: an `elastic.AdmissionController` for
        tiered early 429s on `/predict` — the requester's priority
        class arrives in the `admission_header` header (or a "tier"
        body field) and is forwarded on the enqueued record for the
        engine's tiered scheduler.

        `partitions` routes enqueued records across the
        partitioned request plane — it must match the engines'
        partition count (the broker-persisted meta row is the
        authority; engines validate it on startup).

        `gateway_id` makes this frontend one REPLICA of a
        replicated gateway: a `GatewayLeaderLease` on
        `gateway:<fleet_stream>` elects one leader among the replicas.
        Every replica serves `/predict`, `/healthz`, `/metrics`,
        `/rollout` and `/rollout/status` from broker-derived state;
        only the leader's control loops (rollout convergence,
        autoscaling) act — wire `leader_fn=frontend.is_leader` into
        `RolloutController`/`FleetAutoscaler`. Kill the leader and a
        surviving replica takes the lease within ~`leader_ttl_s`.

        `trace_sample` turns on the fleet trace plane at
        this gateway: `/predict` pre-generates request ids (returned as
        `request_ids`), stamps trace context on every enqueued record,
        and the gateway's own `gateway_request` spans export to the
        broker alongside the engines'. `GET /trace/<request_id>` serves
        the merged cross-process timeline from ANY replica (the
        collector is broker-state only, so it works even with
        `trace_sample=0` as long as engines sample)."""
        if not 0.0 <= float(trace_sample) <= 1.0:
            raise ValueError(
                f"trace_sample must be in [0, 1], got {trace_sample}")
        self.trace_sample = float(trace_sample)
        self.broker = broker if isinstance(broker, Broker) \
            else connect_broker(broker)
        self._srv = _FrontEndServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self._srv.input_queue = InputQueue(self.broker,
                                           partitions=partitions,
                                           trace_sample=self.trace_sample,
                                           trace_parent="gateway_request")
        self._srv.broker = self.broker
        # generative streaming: SSE on /predict?stream=1
        # polls token rows straight off the result hash
        self._srv.output_queue = OutputQueue(self.broker)
        # streaming continuity: keepalive comment cadence and
        # heartbeat-aware stall cutoff for the SSE relay, plus the
        # counter the Last-Event-ID reconnect path bumps
        self._srv.stream_keepalive_s = stream_keepalive_s
        self._srv.stream_stall_timeout_s = stream_stall_timeout_s
        self._srv.serving = serving
        self._srv.request_timer = Timer("http_predict")
        self.registry = registry if registry is not None else get_registry()
        self._srv.registry = self.registry
        self._srv.http_requests = self.registry.counter(
            "http_requests_total",
            "frontend responses by route, method and status code")
        self._srv.token_replays = self.registry.counter(
            "serving_token_replays_total",
            "token rows replayed instead of served fresh — surface="
            "engine: deterministic re-decode of already-durable tokens "
            "when a resume context outruns the prefill ladder; surface="
            "frontend: rows re-sent to a reconnecting SSE client "
            "honoring Last-Event-ID")
        req_hist = self.registry.histogram(
            "http_request_ms", "frontend /predict round-trip duration")
        self._srv.request_timer.add_observer(
            lambda s: req_hist.observe(s * 1e3))
        # on-demand profiler capture (POST /profile): bounded + rotated
        # under one root; inert (zero request-path cost) until a capture
        # request arrives. `profile_enabled=False` (config:
        # params.profile_enabled) leaves the endpoint answering 404 —
        # a capture pins a handler thread for its whole window, which an
        # internet-facing frontend may not want to offer
        self._srv.profile_capture = None
        if profile_enabled:
            import tempfile
            from analytics_zoo_tpu_torch.observability.capture import \
                ProfileCapture
            root = profile_dir or os.environ.get("ZOO_PROFILE_DIR") \
                or os.path.join(tempfile.gettempdir(), "zoo_profiles")
            self._srv.profile_capture = ProfileCapture(
                root, max_artifacts=profile_max_artifacts,
                registry=self.registry)
        # fleet tracking (gateway role): reads heartbeats over the same
        # broker the data plane uses — one shared dependency, no second
        # membership service
        self.fleet = None
        if fleet_stream:
            from analytics_zoo_tpu_torch.serving.fleet import FleetTracker
            self.fleet = FleetTracker(self.broker, fleet_stream,
                                      ttl_s=engine_ttl_s,
                                      registry=self.registry)
        self._srv.fleet = self.fleet
        # replicated gateway: leader election over the same
        # broker as everything else. The lease thread gets its own
        # connection (clone) so a long /predict poll on the shared
        # socket can never delay a renewal past the ttl
        self.leader_lease = None
        self.gateway_id = gateway_id
        if gateway_id is not None:
            from analytics_zoo_tpu_torch.serving.client import STREAM
            from analytics_zoo_tpu_torch.serving.partitions import \
                GatewayLeaderLease
            clone = getattr(self.broker, "clone", None)
            lease_broker = clone() if callable(clone) else self.broker
            self.leader_lease = GatewayLeaderLease(
                lease_broker, fleet_stream or STREAM, gateway_id,
                ttl_s=leader_ttl_s, registry=self.registry)
        self._srv.leader_lease = self.leader_lease
        # fleet trace plane. The collector is UNCONDITIONAL:
        # it reads only broker state, so any replica — even one started
        # with tracing off — can serve GET /trace/<id> for requests the
        # engines sampled.
        from analytics_zoo_tpu_torch.serving.trace_plane import (SpanExporter,
                                                           TraceCollector)
        # engines publish under their DATA stream's key; in a fleet
        # deployment that is the same name the heartbeat plane uses
        obs_stream = fleet_stream or self._srv.input_queue.stream
        self._srv.trace_collector = TraceCollector(self.broker, obs_stream)
        self.gateway_tracer = None
        self.trace_exporter = None
        self._te_broker = None
        if self.trace_sample > 0:
            from analytics_zoo_tpu_torch.observability.tracing import Tracer
            gw_name = gateway_id or f"gateway-{os.getpid()}"
            self.gateway_tracer = Tracer(
                max_spans=int(trace_buffer_spans),
                registry=self.registry, engine=gw_name)
            clone = getattr(self.broker, "clone", None)
            if callable(clone):
                # own connection: a publish must never queue behind a
                # handler thread's blocking result poll
                self._te_broker = clone()
            self.trace_exporter = SpanExporter(
                self._te_broker or self.broker, obs_stream, gw_name,
                self.gateway_tracer, sample=self.trace_sample,
                interval_s=float(trace_export_interval_s),
                buffer_spans=int(trace_buffer_spans),
                registry=self.registry)
        self._srv.gateway_tracer = self.gateway_tracer
        # fleet metrics aggregation: /metrics on any replica
        # exposes the whole fleet's registry, not just this process
        self.fleet_metrics = None
        if fleet_stream:
            from analytics_zoo_tpu_torch.serving.fleet_metrics import \
                FleetMetricsAggregator
            self.fleet_metrics = FleetMetricsAggregator(
                self.broker, fleet_stream, self.registry,
                alive_fn=self._alive_engines)
        self._srv.fleet_metrics = self.fleet_metrics
        self.admission = admission
        self._srv.admission = admission
        self._srv.admission_header = admission_header
        # versioned rollout: a RolloutController (gateway
        # role — POST /rollout accepted) or an EngineRolloutAgent
        # (engine role — status only); attach later via set_rollout
        # when the controller is built after the frontend
        self.rollout = rollout
        self._srv.rollout = rollout
        self._srv.timeout_s = timeout_s
        self._srv.rate_limiter = (
            TokenBucket(tokens_per_second, token_bucket_capacity)
            if tokens_per_second else None)
        self._srv.token_acquire_timeout_ms = token_acquire_timeout_ms
        self.tls = bool(tls_certfile)
        if tls_certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_certfile, tls_keyfile)
            self._srv.ssl_context = ctx
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    def set_rollout(self, rollout):
        """Attach the rollout controller/agent after construction (the
        gateway builds the controller with the frontend's own
        FleetTracker, which exists only once the frontend does)."""
        self.rollout = rollout
        self._srv.rollout = rollout

    def _alive_engines(self):
        """Alive-engine id set for the fleet metrics merge; None (the
        filter degrades open) while the broker view is unknown or no
        fleet tracking is configured."""
        if self.fleet is None:
            return None
        engines = self.fleet.poll()
        if engines is None:
            return None
        return {eid for eid, row in engines.items() if row.get("alive")}

    def is_leader(self) -> bool:
        """True when this replica's control loops should act. A
        frontend started WITHOUT a gateway_id is the only gateway
        there is — trivially the leader — so `leader_fn=...is_leader`
        is always safe to wire."""
        return self.leader_lease is None or self.leader_lease.is_leader()

    def start(self) -> "FrontEnd":
        if self.leader_lease is not None:
            self.leader_lease.start()
        if self.trace_exporter is not None:
            self.trace_exporter.start()
        self._thread.start()
        return self

    def stop(self, release_lease: bool = True):
        """`release_lease=False` is the kill-the-leader chaos analogue:
        the HTTP listener dies but the lease row stays unreleased in
        the broker, exactly as a SIGKILLed gateway would leave it — a
        surviving replica must win it only by expiry."""
        self._srv.shutdown()
        self._srv.server_close()
        if self.trace_exporter is not None:
            self.trace_exporter.stop(flush=True)
        if self._te_broker is not None:
            try:
                self._te_broker.close()
            except Exception:  # noqa: BLE001 — stopping regardless
                pass
        if self.leader_lease is not None:
            self.leader_lease.stop(release=release_lease)
        if self.fleet is not None:
            self.fleet.close()
