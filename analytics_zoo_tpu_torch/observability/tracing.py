"""Request-scoped span tracing with Chrome trace-event export.

Copied from `analytics_zoo_tpu/observability/tracing.py` as it is (L1-292):
`Span` (L36), `_ScopedSpan` (L69), `Tracer` (L109), `span_to_dict` (L242),
`span_from_dict` (L262) and `span_coverage` (L272).

The reference's only tracing is `Supportive.timing` log lines — spans
that exist for one `grep` and die. This tracer keeps them: finished
spans land in a bounded ring buffer and export as Chrome trace-event
JSON (`chrome://tracing` / Perfetto's legacy JSON loader), so "where did
this request spend its time" is answerable per request, per stage.

Two ways to produce spans:

- `with tracer.span("decode", trace_id=uri): ...` — scoped, nests via a
  thread-local stack (children inherit the enclosing span's trace_id and
  record their parent's name).
- `tracer.add_span("queue_wait", t0, t1, ...)` — explicit timestamps,
  for intervals that start in one thread and end in another (the
  inter-stage queue waits in `serving/server.py`).

Request-ID propagation: a span carries `trace_id` (one request) or
`trace_ids` (a batch span covering many records — the serving pipeline
batches, so per-stage spans tag every record they carried instead of
multiplying span count by batch size). `tracer.spans(trace_id=uri)`
matches both. Timestamps are `time.perf_counter()` seconds rebased to
the tracer's epoch, so spans from different threads order correctly.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


class Span:
    __slots__ = ("name", "cat", "start", "duration", "trace_id",
                 "trace_ids", "tid", "parent", "args")

    def __init__(self, name: str, cat: str, start: float, duration: float,
                 trace_id: Optional[str] = None,
                 trace_ids: Optional[Tuple[str, ...]] = None,
                 tid: str = "", parent: Optional[str] = None,
                 args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.cat = cat
        self.start = start            # perf_counter seconds
        self.duration = duration     # seconds
        self.trace_id = trace_id
        self.trace_ids = trace_ids
        self.tid = tid
        self.parent = parent
        self.args = args or {}

    @property
    def end(self) -> float:
        return self.start + self.duration

    def covers(self, trace_id: str) -> bool:
        return (self.trace_id == trace_id
                or (self.trace_ids is not None
                    and trace_id in self.trace_ids))

    def __repr__(self):
        return (f"Span({self.name} {self.duration * 1e3:.3f}ms "
                f"trace_id={self.trace_id})")


class _ScopedSpan:
    """Context manager returned by `Tracer.span`."""

    __slots__ = ("_tracer", "name", "cat", "trace_id", "trace_ids",
                 "args", "_t0", "_parent")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 trace_id: Optional[str],
                 trace_ids: Optional[Sequence[str]],
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.trace_ids = tuple(trace_ids) if trace_ids else None
        self.args = args

    def __enter__(self) -> "_ScopedSpan":
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else None
        if self.trace_id is None and self._parent is not None:
            self.trace_id = self._parent.trace_id
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._emit(Span(
            self.name, self.cat, self._t0, end - self._t0,
            trace_id=self.trace_id, trace_ids=self.trace_ids,
            tid=threading.current_thread().name,
            parent=self._parent.name if self._parent else None,
            args=self.args))
        return False


class Tracer:
    """Bounded span collector. `max_spans` caps memory: a serving
    process tracing forever keeps the most recent window (the Chrome
    JSON is a debugging view, not an archive).

    `engine` names the producing process (engine id / gateway id) and
    namespaces the Chrome-trace `tid` as ``engine:thread`` so merged
    multi-process views never interleave unrelated stages onto one row.
    `registry` mirrors ring overflow into
    `observability_spans_dropped_total` so an unscraped long-running
    engine's span loss is visible on a scrape, not only in `.dropped`.
    `add_sink(fn)` registers a callable invoked with every finished span
    (the fleet span exporter taps the flow here); sink errors are
    swallowed — telemetry must never fail the serving path."""

    def __init__(self, max_spans: int = 20000,
                 registry=None, engine: Optional[str] = None):
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=max_spans)
        self._lock = threading.Lock()
        self._local = threading.local()
        self.epoch = time.perf_counter()
        self.dropped = 0
        self.engine = engine
        self._sinks: List[Any] = []
        self._dropped_counter = None
        if registry is not None:
            self._dropped_counter = registry.counter(
                "observability_spans_dropped_total",
                "finished spans evicted from the tracer's bounded ring "
                "(the trace window is smaller than the traffic it saw)")

    def _stack(self) -> List[_ScopedSpan]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add_sink(self, fn) -> None:
        """Register `fn(span)` to observe every finished span."""
        self._sinks.append(fn)

    def remove_sink(self, fn) -> None:
        try:
            self._sinks.remove(fn)
        except ValueError:
            pass

    def _emit(self, span: Span):
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
                if self._dropped_counter is not None:
                    labels = {"engine": self.engine} if self.engine else {}
                    self._dropped_counter.inc(**labels)
            self._spans.append(span)
        for sink in self._sinks:
            try:
                sink(span)
            except Exception:  # noqa: BLE001 — a broken exporter must
                pass           # never fail the traced code path

    # -- producing ---------------------------------------------------------
    def span(self, name: str, trace_id: Optional[str] = None,
             cat: str = "serving",
             trace_ids: Optional[Sequence[str]] = None,
             args: Optional[Dict[str, Any]] = None) -> _ScopedSpan:
        return _ScopedSpan(self, name, cat, trace_id, trace_ids, args)

    def add_span(self, name: str, start: float, end: float,
                 trace_id: Optional[str] = None, cat: str = "serving",
                 trace_ids: Optional[Sequence[str]] = None,
                 tid: Optional[str] = None,
                 args: Optional[Dict[str, Any]] = None):
        """Record a span from explicit `time.perf_counter()` endpoints —
        the cross-thread case (queue waits begin at the producer's `put`
        and end at the consumer's `get`)."""
        self._emit(Span(name, cat, start, max(0.0, end - start),
                        trace_id=trace_id,
                        trace_ids=tuple(trace_ids) if trace_ids else None,
                        tid=tid or threading.current_thread().name,
                        args=args))

    # -- consuming ---------------------------------------------------------
    def spans(self, trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            spans = list(self._spans)
        if trace_id is None:
            return spans
        return [s for s in spans if s.covers(trace_id)]

    def clear(self):
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def chrome_trace(self, trace_id: Optional[str] = None
                     ) -> Dict[str, Any]:
        """Chrome trace-event JSON (the `traceEvents` array form): open
        in Perfetto (ui.perfetto.dev → legacy JSON) or chrome://tracing.
        Complete events (`ph: "X"`), microsecond timestamps rebased to
        the tracer epoch, one row per producing thread."""
        events = []
        pid = os.getpid()
        for s in self.spans(trace_id):
            args: Dict[str, Any] = dict(s.args)
            if s.trace_id is not None:
                args["trace_id"] = s.trace_id
            if s.trace_ids is not None:
                args["trace_ids"] = list(s.trace_ids)
            if s.parent is not None:
                args["parent"] = s.parent
            events.append({
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": round((s.start - self.epoch) * 1e6, 3),
                "dur": round(s.duration * 1e6, 3),
                "pid": pid,
                "tid": (f"{self.engine}:{s.tid}" if self.engine
                        else s.tid),
                "args": args,
            })
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str,
                           trace_id: Optional[str] = None) -> str:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(trace_id), fh)
        return path


def span_to_dict(span: Span, epoch: float = 0.0) -> Dict[str, Any]:
    """Wire form of a span: start rebased to `epoch` (the producing
    tracer's epoch, so exported times are process-relative seconds),
    empty fields omitted. Inverse of `span_from_dict`."""
    d: Dict[str, Any] = {"name": span.name, "cat": span.cat,
                         "s": round(span.start - epoch, 9),
                         "d": round(span.duration, 9)}
    if span.trace_id is not None:
        d["id"] = span.trace_id
    if span.trace_ids:
        d["ids"] = list(span.trace_ids)
    if span.tid:
        d["tid"] = span.tid
    if span.parent is not None:
        d["parent"] = span.parent
    if span.args:
        d["args"] = span.args
    return d


def span_from_dict(d: Dict[str, Any]) -> Span:
    ids = d.get("ids")
    return Span(d.get("name", ""), d.get("cat", "serving"),
                float(d.get("s", 0.0)), float(d.get("d", 0.0)),
                trace_id=d.get("id"),
                trace_ids=tuple(ids) if ids else None,
                tid=d.get("tid", ""), parent=d.get("parent"),
                args=d.get("args"))


def span_coverage(spans: Iterable[Span], start: float, end: float) -> float:
    """Fraction of [start, end] (perf_counter seconds) covered by the
    union of the spans' intervals — the acceptance metric for "spans
    cover >= 95% of the request's measured end-to-end latency"."""
    if end <= start:
        return 0.0
    ivals = sorted((max(s.start, start), min(s.end, end)) for s in spans)
    covered = 0.0
    cur_lo = cur_hi = None
    for lo, hi in ivals:
        if hi <= lo:
            continue
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        covered += cur_hi - cur_lo
    return covered / (end - start)
