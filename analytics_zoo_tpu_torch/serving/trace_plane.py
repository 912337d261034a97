"""Fleet trace plane: span export + cross-process assembly.

Copied from `analytics_zoo_tpu/serving/trace_plane.py` as it is
(L1-415): `should_sample`, `SpanExporter` (L90) and `TraceCollector`
(L258).

The `Tracer` is strictly process-local — spans die with the
process that produced them, and a request that crossed a gateway and an
engine has no single timeline anywhere. This module is the Dapper-style
glue over the broker substrate:

- `should_sample(trace_id, rate)` — deterministic head sampling keyed
  on the trace id (salted CRC32), so every process reaches the *same*
  keep/drop decision without propagating a sampled bit on the wire.
- `SpanExporter` — taps a `Tracer`'s span flow into a bounded local
  ring (overflow counted in `serving_trace_dropped_total`), and a
  background thread publishes the sampled window as one JSON blob per
  engine into the `traces:<stream>` broker hash (HSET overwrite: the
  structure is bounded by construction, and — unlike a consumer-group
  stream — every gateway replica can read it without racing an ack).
  `force(uris)` adds engine-local forced sampling for failed or
  SLO-violating requests, on top of the head-sampled set.
- `TraceCollector` — reads every engine's blob from any replica and
  assembles one merged timeline per request. Clock-skew safety follows
  the FleetTracker discipline: never compare wall clocks across hosts
  directly. Each engine's spans are internally consistent on its own
  monotonic clock; its "wire" spans carry the client ingest wall time
  and the engine read wall time, and the collector anchors each
  engine's span group on the client timeline at
  ``t_ingest + (delta_r - min_delta_e)`` where ``delta_r`` is that
  request's read-minus-ingest delta and ``min_delta_e`` the minimum
  delta observed for the engine across its published window — the
  per-engine skew term cancels, leaving a non-negative wire+queue
  estimate. Output is a merged Chrome trace (tid namespaced
  ``engine:thread``) plus a `wire / queue / decode / device /
  writeback` critical-path breakdown.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence

from analytics_zoo_tpu_torch.observability.tracing import (Span, Tracer,
                                                     span_coverage,
                                                     span_to_dict)

logger = logging.getLogger(__name__)

TRACES_KEY_PREFIX = "traces:"

# Stage vocabulary → critical-path column for /trace/<id>/summary.
# "device" covers the dispatch (host launch) plus the result wait; the
# residual inside "sink" (encode, buffering) is visible in the full
# trace but not a column of its own.
_CRITICAL_PATH = {
    "wire": "wire",
    "decode_q_wait": "queue",
    "dispatch_q_wait": "queue",
    "sink_q_wait": "queue",
    "decode": "decode",
    "dispatch": "device",
    "device": "device",
    "writeback": "writeback",
}

SUMMARY_COLUMNS = ("wire", "queue", "decode", "device", "writeback")


def traces_key(stream: str) -> str:
    """Broker hash holding one spans blob per publishing process."""
    return TRACES_KEY_PREFIX + stream


def should_sample(trace_id: str, rate: float) -> bool:
    """Deterministic head sampling: same id + rate → same decision in
    every process. The hash is salted so the decision decorrelates from
    `partitions.stream_for`'s routing hash (both use CRC32 of the
    uri)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = zlib.crc32(b"trace:" + str(trace_id).encode("utf-8", "replace"))
    return (h % 10000) < rate * 10000


class SpanExporter:
    """Ships a tracer's spans into the `traces:<stream>` broker hash.

    Retention and sampling are separate: *every* span lands in the
    bounded local ring (so a failure detected at the sink — the last
    stage — can still force-export the request's earlier spans), while
    head sampling plus the forced set gate what goes on the wire. The
    publish is a rolling window (HSET overwrite of this engine's field),
    so a lost publish is healed by the next one and replicated readers
    never contend."""

    def __init__(self, broker, stream: str, engine: str, tracer: Tracer,
                 sample: float = 0.01, interval_s: float = 0.5,
                 buffer_spans: int = 20000, max_publish_spans: int = 2000,
                 registry=None):
        self.broker = broker
        self.key = traces_key(stream)
        self.engine = engine
        self.tracer = tracer
        self.sample = float(sample)
        self.interval_s = float(interval_s)
        self.max_publish_spans = int(max_publish_spans)
        self._lock = threading.Lock()
        # ring entries: [span, head_sampled, counted_as_sampled]
        self._entries: "collections.deque[list]" = collections.deque(
            maxlen=max(16, int(buffer_spans)))
        self._forced: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._down = False
        self._labels = {"engine": engine}
        reg = registry
        self._spans_total = self._sampled_total = self._dropped_total = None
        if reg is not None:
            self._spans_total = reg.counter(
                "serving_trace_spans_total",
                "spans observed by the fleet span exporter")
            self._sampled_total = reg.counter(
                "serving_trace_sampled_total",
                "spans selected for fleet export (head-sampled or "
                "force-sampled failed/SLO-violating requests)")
            self._dropped_total = reg.counter(
                "serving_trace_dropped_total",
                "spans evicted from the exporter's bounded local ring "
                "before they could be published")
        self._dropped = 0
        tracer.add_sink(self._on_span)

    # -- span intake -------------------------------------------------------
    def _head_sampled(self, span: Span) -> bool:
        if span.trace_id is not None:
            if should_sample(span.trace_id, self.sample):
                return True
        if span.trace_ids:
            return any(should_sample(t, self.sample)
                       for t in span.trace_ids)
        if span.trace_id is None and not span.trace_ids:
            # id-less spans (user/scoped spans) follow the global rate
            return self.sample >= 1.0
        return False

    def _on_span(self, span: Span) -> None:
        if self._spans_total is not None:
            self._spans_total.inc(**self._labels)
        head = self._head_sampled(span)
        with self._lock:
            if len(self._entries) == self._entries.maxlen:
                self._dropped += 1
                if self._dropped_total is not None:
                    self._dropped_total.inc(**self._labels)
            self._entries.append([span, head, False])

    def force(self, trace_ids: Sequence[str]) -> None:
        """Force-sample every span covering any of `trace_ids` (failed
        or SLO-violating requests), regardless of the head decision."""
        with self._lock:
            for t in trace_ids:
                self._forced[str(t)] = None
            while len(self._forced) > 8192:
                self._forced.popitem(last=False)

    def _is_forced(self, span: Span) -> bool:
        if span.trace_id is not None and span.trace_id in self._forced:
            return True
        if span.trace_ids:
            return any(t in self._forced for t in span.trace_ids)
        return False

    # -- publishing --------------------------------------------------------
    def publish_once(self) -> bool:
        with self._lock:
            selected: List[Span] = []
            for entry in self._entries:
                span, head, counted = entry
                if head or self._is_forced(span):
                    if not counted:
                        entry[2] = True
                        if self._sampled_total is not None:
                            self._sampled_total.inc(**self._labels)
                    selected.append(span)
            selected = selected[-self.max_publish_spans:]
            dropped = self._dropped
            self._seq += 1
            seq = self._seq
        epoch = self.tracer.epoch
        blob = {
            "engine": self.engine,
            "pid": os.getpid(),
            "seq": seq,
            "wall": time.time(),
            # wall time corresponding to the tracer's perf_counter
            # epoch: a *rough* anchor for blobs with no wire span —
            # cross-host comparisons go through the delta model instead
            "epoch_wall": time.time() - (time.perf_counter() - epoch),
            "dropped": dropped,
            "spans": [span_to_dict(s, epoch=epoch) for s in selected],
        }
        try:
            self.broker.hset(self.key, self.engine, json.dumps(blob))
        except Exception as e:  # noqa: BLE001 — broker outage: warn
            if not self._down:  # once, keep serving, retry next tick
                logger.warning("span exporter %s: publish failed (%s); "
                               "retrying each interval", self.engine, e)
                self._down = True
            return False
        if self._down:
            logger.info("span exporter %s: broker back, publishing "
                        "resumed", self.engine)
            self._down = False
        return True

    def stats(self) -> Dict[str, Any]:
        """Engine `/metrics` JSON section: the exporter's own health."""
        with self._lock:
            return {"sample": self.sample, "seq": self._seq,
                    "buffered_spans": len(self._entries),
                    "forced_ids": len(self._forced),
                    "dropped": self._dropped}

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.publish_once()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="serving-trace-exporter", daemon=True)
        self._thread.start()

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        self.tracer.remove_sink(self._on_span)
        if flush:
            self.publish_once()


def _covers(sd: Dict[str, Any], trace_id: str) -> bool:
    return (sd.get("id") == trace_id
            or trace_id in (sd.get("ids") or ()))


class TraceCollector:
    """Assembles one merged cross-process timeline per request from the
    `traces:<stream>` hash. Stateless over the broker — any gateway
    replica (or an engine's own frontend) can serve `GET /trace/<id>`
    with nothing but a broker handle."""

    def __init__(self, broker, stream: str):
        self.broker = broker
        self.key = traces_key(stream)

    # -- fetch -------------------------------------------------------------
    def blobs(self) -> Dict[str, Dict[str, Any]]:
        try:
            raw = self.broker.hgetall(self.key) or {}
        except Exception as e:  # noqa: BLE001 — a scrape during a
            logger.warning("trace collector: hgetall failed: %s", e)
            return {}           # broker blip degrades to "no spans"
        out = {}
        for eng, blob in raw.items():
            try:
                d = json.loads(blob)
            except (TypeError, ValueError):
                continue
            if isinstance(d, dict):
                out[str(eng)] = d
        return out

    # -- assembly ----------------------------------------------------------
    def _groups(self, trace_id: str):
        """Per publishing process: (engine, pid, [(span_dict, wall_start,
        wall_dur)]) with every span placed on the client wall
        timeline via the min-delta skew model."""
        groups = []
        for eng, blob in self.blobs().items():
            all_spans = [s for s in blob.get("spans", [])
                         if isinstance(s, dict)]
            mine = [s for s in all_spans if _covers(s, trace_id)]
            if not mine:
                continue
            # engine-wide minimum read-minus-ingest delta ≈ skew plus
            # the minimum wire latency this window observed
            deltas = []
            for s in all_spans:
                a = s.get("args") or {}
                if s.get("name") == "wire" and "t_ingest" in a \
                        and "t_read_wall" in a:
                    try:
                        deltas.append(float(a["t_read_wall"])
                                      - float(a["t_ingest"]))
                    except (TypeError, ValueError):
                        pass
            min_delta = min(deltas) if deltas else 0.0
            offset = None          # engine-relative seconds -> wall
            wire_fix = {}          # id(span dict) -> (start, dur) override
            for s in mine:
                a = s.get("args") or {}
                if s.get("name") == "wire" and "t_ingest" in a \
                        and "t_read_wall" in a:
                    t_ing = float(a["t_ingest"])
                    delta_r = float(a["t_read_wall"]) - t_ing
                    skew_free = max(0.0, delta_r - min_delta)
                    read_rel = float(s["s"]) + float(s["d"])
                    offset = (t_ing + skew_free) - read_rel
                    wire_fix[id(s)] = (read_rel - skew_free, skew_free)
                    break
            if offset is None:
                for s in mine:
                    a = s.get("args") or {}
                    if s.get("name") == "gateway_request" \
                            and "t_ingest" in a:
                        offset = float(a["t_ingest"]) - float(s["s"])
                        break
            if offset is None:
                # no anchor: fall back to the blob's rough wall epoch
                offset = float(blob.get("epoch_wall", 0.0))
            placed = []
            for s in mine:
                start_rel, dur = float(s["s"]), float(s["d"])
                if id(s) in wire_fix:
                    start_rel, dur = wire_fix[id(s)]
                placed.append((s, offset + start_rel, dur))
            groups.append((eng, blob.get("pid", eng), placed))
        return groups

    def assemble(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Merged Chrome trace for one request, or None when no process
        published a span covering it. `anchor_wall` is the wall-clock
        second the trace's `ts=0` corresponds to (on the client/ingest
        clock), so callers can line events up against their own
        measurements."""
        groups = self._groups(trace_id)
        if not groups:
            return None
        anchor = min(w for _, _, placed in groups for _, w, _ in placed)
        events = []
        engines = []
        for eng, pid, placed in groups:
            engines.append(eng)
            for sd, wall, dur in placed:
                args = dict(sd.get("args") or {})
                if sd.get("id") is not None:
                    args["trace_id"] = sd["id"]
                if sd.get("ids"):
                    args["trace_ids"] = list(sd["ids"])
                if sd.get("parent") is not None:
                    args["parent"] = sd["parent"]
                events.append({
                    "name": sd.get("name", ""),
                    "cat": sd.get("cat", "serving"),
                    "ph": "X",
                    "ts": round((wall - anchor) * 1e6, 3),
                    "dur": round(dur * 1e6, 3),
                    "pid": pid,
                    # satellite: tid namespaced by (engine, thread) so
                    # merged views never collide across processes
                    "tid": f"{eng}:{sd.get('tid', '')}",
                    "args": args,
                })
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "request_id": trace_id, "anchor_wall": anchor,
                "engines": sorted(engines)}

    def summary(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Critical-path breakdown (`wire / queue / decode / device /
        writeback` milliseconds) plus coverage of the gateway-observed
        request window."""
        groups = self._groups(trace_id)
        if not groups:
            return None
        cols = {c: 0.0 for c in SUMMARY_COLUMNS}
        placed_all = []
        gw_window = None
        n_spans = 0
        for eng, _pid, placed in groups:
            for sd, wall, dur in placed:
                n_spans += 1
                placed_all.append(Span(sd.get("name", ""),
                                       sd.get("cat", "serving"),
                                       wall, dur))
                col = _CRITICAL_PATH.get(sd.get("name", ""))
                if col is not None:
                    cols[col] += dur * 1e3
                if sd.get("name") == "gateway_request":
                    gw_window = (wall, wall + dur)
        lo = min(s.start for s in placed_all)
        hi = max(s.end for s in placed_all)
        window = gw_window or (lo, hi)
        out = {
            "request_id": trace_id,
            "engines": sorted(e for e, _, _ in groups),
            "spans": n_spans,
            "e2e_ms": round((window[1] - window[0]) * 1e3, 3),
            "critical_path_ms": {c: round(v, 3)
                                 for c, v in cols.items()},
            "coverage": round(span_coverage(placed_all, *window), 4),
        }
        return out
