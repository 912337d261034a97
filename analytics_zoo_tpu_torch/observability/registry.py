"""Process-wide metrics registry — the telemetry spine.

Copied from `analytics_zoo_tpu/observability/registry.py` as it is
(`LogHistogram`, `Counter`, `Gauge`, `Histogram`, `MetricsRegistry`,
`get_registry`); the decode engine and its pools publish here.

Before this layer, every subsystem kept private, incompatible counters:
the serving `Timer` window (`serving/timer.py`), the trainer's ad-hoc
throughput print (`learn/trainer.py`), the frontend's request timer, and
`StepTimer` in `utils/profiling.py`. The reference platform is no better —
`Supportive.timing` span logs and a per-batch window print
(`serving/utils/Supportive.scala`, `http/FrontEndApp.scala:131,241`) are
its whole observability story. This module gives them ONE API:

- `Counter` — monotonic, `_total`-suffixed (Prometheus convention).
- `Gauge` — last-write-wins scalar, or a live callable evaluated at
  snapshot time (queue depths).
- `Histogram` — the log-bucketed streaming histogram already proven in
  `serving/timer.py` (O(1) memory, O(1) record, ~9% bounded relative
  error from the bucket growth factor), generalized to any unit.

All three support labels (bounded-cardinality key=value pairs → one
child series per distinct label set) and are thread-safe. `snapshot()`
returns a plain-dict view; `delta(prev)` subtracts counter/histogram
accumulation so reporters can log rates. Prometheus text exposition
lives in `observability/prometheus.py`; span tracing in
`observability/tracing.py`.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-z][a-z0-9]*(_[a-z0-9]+)*$")

# Histogram geometry (shared with serving/timer.py, which uses base=1e-6
# for seconds): bucket i covers [base*growth^i, base*growth^(i+1)).
# The default base=1e-3 suits millisecond-valued metrics: 1 µs .. ~300 s.
DEFAULT_HIST_BASE = 1e-3
DEFAULT_HIST_GROWTH = 1.2
DEFAULT_HIST_BUCKETS = 107


class LogHistogram:
    """Streaming log-bucketed histogram: geometrically-spaced buckets,
    percentiles interpolated within the bucket crossing the target rank
    and clamped to the observed min/max. NOT thread-safe on its own —
    owners (`Histogram` family, serving `Timer`) hold their own lock."""

    __slots__ = ("base", "growth", "_log_growth", "n_buckets", "counts",
                 "count", "total", "vmin", "vmax")

    def __init__(self, base: float = DEFAULT_HIST_BASE,
                 growth: float = DEFAULT_HIST_GROWTH,
                 n_buckets: int = DEFAULT_HIST_BUCKETS):
        self.base = base
        self.growth = growth
        self._log_growth = math.log(growth)
        self.n_buckets = n_buckets
        self.clear()

    def clear(self):
        self.counts = [0] * self.n_buckets
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = 0.0

    def bucket_index(self, v: float) -> int:
        if v <= self.base:
            return 0
        i = int(math.log(v / self.base) / self._log_growth)
        return min(i, self.n_buckets - 1)

    def bucket_upper(self, i: int) -> float:
        return self.base * (self.growth ** (i + 1))

    def observe(self, v: float):
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.counts[self.bucket_index(v)] += 1

    def percentile(self, q: float) -> float:
        """Value at quantile q in [0, 1]: find the bucket crossing rank
        q*count, interpolate linearly inside it, clamp to min/max so
        bucket-edge estimates never exceed reality."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if seen + c >= target:
                lo = self.base * (self.growth ** i)
                hi = lo * self.growth
                est = lo + (hi - lo) * (target - seen) / c
                return min(max(est, self.vmin), self.vmax)
            seen += c
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Base family: child series keyed by sorted (label, value) tuples."""

    kind = "untyped"

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    def label_keys(self) -> List[Tuple[Tuple[str, str], ...]]:
        with self._lock:
            return list(self._series)

    def _series_snapshot(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "description": self.description,
                "series": self._series_snapshot()}


class Counter(_Metric):
    """Monotonic counter. `inc()` with labels creates the child series on
    first use; negative increments raise (monotonicity is what makes
    rate() well-defined downstream)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {value})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0.0)

    def _series_snapshot(self):
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._series.items())]


class Gauge(_Metric):
    """Last-write-wins scalar. `set_function` installs a zero-argument
    callable evaluated at snapshot time — live views (queue depths,
    pool sizes) without a writer thread.

    Callback hardening: a raising callback can
    never propagate out of `snapshot()`, `value()`, the Prometheus
    render, or the reporter digest — the series reads NaN for that
    evaluation and the failure is counted
    (`observability_gauge_errors_total{gauge=...}` via the registry's
    `_on_error` hook), so one bad gauge degrades to one bad series
    instead of killing every scrape."""

    kind = "gauge"
    _on_error: Optional[Callable[[str], None]] = None   # registry hook

    def _callback_failed(self, exc: BaseException):
        hook = self._on_error
        if hook is None:
            return
        try:
            hook(self.name)
        except Exception:  # noqa: BLE001 — error accounting must never
            pass           # become a second error

    def set(self, value: float, **labels):
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels):
        key = _label_key(labels)
        with self._lock:
            cur = self._series.get(key, 0.0)
            if callable(cur):
                raise ValueError(
                    f"gauge {self.name}{dict(key)} is callable-backed")
            self._series[key] = cur + value

    def dec(self, value: float = 1.0, **labels):
        self.inc(-value, **labels)

    def set_function(self, fn: Callable[[], float], **labels):
        with self._lock:
            self._series[_label_key(labels)] = fn

    def release_function(self, fn: Callable[[], float],
                         freeze: bool = False, **labels):
        """Compare-and-release the closure installed by `set_function` —
        the uninstall: a retiring provider (a stopped server, a closed
        replica pool) must not leave a closure pinning it in the
        process-wide registry. A no-op when another provider has since
        replaced the series (label keys are process-global, so an
        unconditional removal would destroy the NEWER owner's live
        telemetry). With ``freeze=True`` the series keeps its final
        float value instead of disappearing."""
        key = _label_key(labels)
        with self._lock:
            if self._series.get(key) is not fn:
                return
            if freeze:
                try:
                    self._series[key] = float(fn())
                    return
                except Exception:  # noqa: BLE001 — dead provider:
                    pass           # drop rather than freeze a NaN
            self._series.pop(key, None)

    def value(self, **labels) -> float:
        with self._lock:
            v = self._series.get(_label_key(labels), 0.0)
        if not callable(v):
            return v
        try:
            return float(v())
        except Exception as e:  # noqa: BLE001 — same contract as
            # snapshot: a raising provider reads NaN, never raises
            self._callback_failed(e)
            return float("nan")

    def _series_snapshot(self):
        with self._lock:
            items = sorted(self._series.items())
        out = []
        for k, v in items:
            if callable(v):
                try:
                    v = float(v())
                except Exception as e:  # noqa: BLE001 — a dead provider
                    # (e.g. a stopped server's queue) must not break
                    # snapshots; counted so the failure is visible
                    self._callback_failed(e)
                    v = float("nan")
            out.append({"labels": dict(k), "value": v})
        return out


class Histogram(_Metric):
    """Labeled family of `LogHistogram`s. Observations are in the unit
    the name's suffix declares (`_ms`, `_bytes`); the default bucket
    geometry spans 1e-3 .. ~3e5 in that unit."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 base: float = DEFAULT_HIST_BASE,
                 growth: float = DEFAULT_HIST_GROWTH,
                 n_buckets: int = DEFAULT_HIST_BUCKETS):
        super().__init__(name, description)
        self._geometry = (base, growth, n_buckets)

    def observe(self, value: float, **labels):
        key = _label_key(labels)
        with self._lock:
            h = self._series.get(key)
            if h is None:
                h = self._series[key] = LogHistogram(*self._geometry)
            h.observe(value)

    def percentile(self, q: float, **labels) -> float:
        with self._lock:
            h = self._series.get(_label_key(labels))
            return h.percentile(q) if h is not None else 0.0

    def child(self, **labels) -> LogHistogram:
        """The raw LogHistogram for one label set (exposition needs the
        bucket counts; mutate only under this family's lock)."""
        key = _label_key(labels)
        with self._lock:
            h = self._series.get(key)
            if h is None:
                h = self._series[key] = LogHistogram(*self._geometry)
            return h

    def _series_snapshot(self):
        with self._lock:
            return [{"labels": dict(k),
                     "count": h.count,
                     "sum": round(h.total, 6),
                     "min": round(h.vmin, 6) if h.count else 0.0,
                     "max": round(h.vmax, 6),
                     "p50": round(h.percentile(0.50), 6),
                     "p95": round(h.percentile(0.95), 6),
                     "p99": round(h.percentile(0.99), 6)}
                    for k, h in sorted(self._series.items())]


_COUNTER_SUFFIX = ("_total",)
_HIST_SUFFIXES = ("_ms", "_bytes", "_seconds")


class MetricsRegistry:
    """Name → metric family. Registration is get-or-create: two
    subsystems asking for the same (name, kind) converge on one family
    (that is the point — process-wide convergence); a kind conflict
    raises. Naming is validated at registration so a bad name fails at
    import/construction, not in a Grafana query:

    - snake_case (`^[a-z][a-z0-9_]*$`, no leading/trailing/double `_`)
    - counters end `_total`
    - histograms end with a unit suffix (`_ms`, `_bytes`, `_seconds`)
    - gauges must NOT end `_total` (that claims monotonicity)

    `scripts/check_metric_names.py` enforces the same rules statically
    across the codebase as a tier-1 test."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    # -- registration ------------------------------------------------------
    def _get_or_create(self, cls, name: str, description: str, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} is not snake_case "
                "([a-z0-9_], segments separated by single underscores)")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, requested {cls.kind}")
                return existing
            m = cls(name, description, **kwargs)
            if cls is Gauge:
                m._on_error = self._count_gauge_error
            self._metrics[name] = m
            return m

    def _count_gauge_error(self, gauge_name: str):
        """One bad callback = one counted error, not a dead scrape. The
        counter itself is get-or-create, so it exists from the first
        failure on (and survives a test's clear())."""
        if gauge_name == "observability_gauge_errors_total":
            return          # never recurse into our own accounting
        self.counter(
            "observability_gauge_errors_total",
            "gauge callbacks that raised during evaluation (the series "
            "read NaN for that snapshot)").inc(gauge=gauge_name)

    def counter(self, name: str, description: str = "") -> Counter:
        if not name.endswith(_COUNTER_SUFFIX):
            raise ValueError(
                f"counter {name!r} must end with '_total' "
                "(unit-suffix convention)")
        return self._get_or_create(Counter, name, description)

    def gauge(self, name: str, description: str = "") -> Gauge:
        if name.endswith(_COUNTER_SUFFIX):
            raise ValueError(
                f"gauge {name!r} must not end with '_total' "
                "(that suffix claims a monotonic counter)")
        return self._get_or_create(Gauge, name, description)

    def histogram(self, name: str, description: str = "",
                  base: float = DEFAULT_HIST_BASE,
                  growth: float = DEFAULT_HIST_GROWTH,
                  n_buckets: int = DEFAULT_HIST_BUCKETS) -> Histogram:
        if not name.endswith(_HIST_SUFFIXES):
            raise ValueError(
                f"histogram {name!r} must carry a unit suffix "
                f"({', '.join(_HIST_SUFFIXES)})")
        return self._get_or_create(Histogram, name, description,
                                   base=base, growth=growth,
                                   n_buckets=n_buckets)

    # -- introspection -----------------------------------------------------
    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def families(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def unregister(self, name: str):
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self):
        """Drop every family — test isolation for the process-global
        registry."""
        with self._lock:
            self._metrics.clear()

    # -- views -------------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {m.name: m.snapshot() for m in self.families()}

    def delta(self, prev: Optional[Dict[str, Dict[str, Any]]]
              ) -> Dict[str, Dict[str, Any]]:
        """Current snapshot with counter values and histogram count/sum
        reduced by `prev` (a prior `snapshot()`). Gauges pass through
        (they are levels, not accumulations); series absent from `prev`
        keep their full value."""
        cur = self.snapshot()
        if not prev:
            return cur
        for name, fam in cur.items():
            pfam = prev.get(name)
            if not pfam or pfam.get("kind") != fam["kind"]:
                continue
            pseries = {_label_key(s["labels"]): s
                       for s in pfam.get("series", [])}
            for s in fam["series"]:
                p = pseries.get(_label_key(s["labels"]))
                if p is None:
                    continue
                if fam["kind"] == "counter":
                    s["value"] = max(0.0, s["value"] - p["value"])
                elif fam["kind"] == "histogram":
                    s["count"] = max(0, s["count"] - p["count"])
                    s["sum"] = round(max(0.0, s["sum"] - p["sum"]), 6)
        return cur


# The process-wide default: serving, training and the HTTP frontend all
# publish here unless handed an explicit registry.
_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry
