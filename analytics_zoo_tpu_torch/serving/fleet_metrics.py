"""Fleet metrics aggregation: one Prometheus scrape sees every engine.

Copied from `analytics_zoo_tpu/serving/fleet_metrics.py` as it is
(L1-360): `metrics_key` (L55), `registry_blob` (L62),
`FleetMetricsPublisher` (L143) and `FleetMetricsAggregator` (L199).

Monarch-style push-aggregate over the broker substrate. Engines cannot
be scraped individually — they may sit behind NAT, churn under the
autoscaler, or share a host — so each
engine's `FleetMetricsPublisher` periodically publishes its registry as
one JSON blob into the `metrics:<stream>` broker hash (HSET overwrite:
bounded by construction, readable from every gateway replica without
consumer-group coordination, exactly the `engines:<stream>` heartbeat
discipline).

Blobs are **full cumulative snapshots**, not deltas: a restarting
engine's first blob is self-describing, a missed publish is healed by
the next one, and merging needs no per-source history. Histograms ship
their raw log-bucket counts plus geometry so the gateway can merge them
bucket-wise without losing percentile fidelity.

The gateway-side `FleetMetricsAggregator` builds a fresh merged
`MetricsRegistry` per scrape:

- every engine-published series carries an `engine` label (the
  publisher stamps it when absent), so per-engine series coexist;
- counters and histograms additionally roll up into a `scope="fleet"`
  series per label set (engine label stripped): counters summed,
  LogHistograms merged bucket-wise when geometry matches;
- gauges stay engine-labeled (summing levels is meaningless);
- local gateway series whose `engine` label names an engine that also
  published a blob are dropped in favour of the blob (the
  engine-and-gateway-in-one-process deployment would otherwise double
  count);
- `fleet_scrape_age_s{engine=...}` reports staleness from *seq
  progress observed on the aggregator's own monotonic clock* — never a
  cross-host wall-clock comparison (the FleetTracker discipline).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional, Set

from analytics_zoo_tpu_torch.observability.registry import (Counter, Gauge,
                                                      Histogram,
                                                      LogHistogram,
                                                      MetricsRegistry,
                                                      _label_key)

logger = logging.getLogger(__name__)

METRICS_KEY_PREFIX = "metrics:"


def metrics_key(stream: str) -> str:
    """Broker hash holding one registry blob per publishing engine."""
    return METRICS_KEY_PREFIX + stream


# -- snapshot/export ---------------------------------------------------------

def registry_blob(registry: MetricsRegistry, engine: Optional[str],
                  seq: int) -> Dict[str, Any]:
    """Full cumulative export of a registry. When `engine` is given,
    every series lacking an `engine` label is stamped with it, so the
    fleet view can attribute and deduplicate per engine."""

    def _stamp(labels: Dict[str, str]) -> Dict[str, str]:
        if engine is not None and "engine" not in labels:
            labels = dict(labels)
            labels["engine"] = engine
        return labels

    counters: Dict[str, Any] = {}
    gauges: Dict[str, Any] = {}
    hists: Dict[str, Any] = {}
    for fam in registry.families():
        if isinstance(fam, Counter):
            counters[fam.name] = {
                "help": fam.description,
                "series": [[_stamp(s["labels"]), s["value"]]
                           for s in fam._series_snapshot()]}
        elif isinstance(fam, Gauge):
            gauges[fam.name] = {
                "help": fam.description,
                "series": [[_stamp(s["labels"]), s["value"]]
                           for s in fam._series_snapshot()]}
        elif isinstance(fam, Histogram):
            series = []
            for key in fam.label_keys():
                with fam._lock:
                    h = fam._series.get(key)
                    if h is None:
                        continue
                    sd = {"base": h.base, "growth": h.growth,
                          "n": h.n_buckets,
                          "counts": {str(i): c
                                     for i, c in enumerate(h.counts)
                                     if c},
                          "count": h.count, "total": h.total,
                          "vmin": h.vmin if h.count else 0.0,
                          "vmax": h.vmax}
                series.append([_stamp(dict(key)), sd])
            hists[fam.name] = {"help": fam.description, "series": series}
    return {"engine": engine, "seq": seq, "wall": time.time(),
            "counters": counters, "gauges": gauges, "hists": hists}


def _hist_from_blob(sd: Dict[str, Any]) -> Optional[LogHistogram]:
    try:
        h = LogHistogram(base=float(sd["base"]),
                         growth=float(sd["growth"]),
                         n_buckets=int(sd["n"]))
        for i, c in (sd.get("counts") or {}).items():
            h.counts[int(i)] = int(c)
        h.count = int(sd.get("count", 0))
        h.total = float(sd.get("total", 0.0))
        h.vmin = float(sd.get("vmin", 0.0)) if h.count else float("inf")
        h.vmax = float(sd.get("vmax", 0.0))
        return h
    except (KeyError, TypeError, ValueError, IndexError):
        return None


def _merge_hist(dst: LogHistogram, src: LogHistogram) -> bool:
    """Bucket-wise merge; refuses on geometry mismatch (adding counts
    across different bucket edges would fabricate percentiles)."""
    if (dst.base, dst.growth, dst.n_buckets) != \
            (src.base, src.growth, src.n_buckets):
        return False
    for i, c in enumerate(src.counts):
        if c:
            dst.counts[i] += c
    dst.count += src.count
    dst.total += src.total
    dst.vmin = min(dst.vmin, src.vmin)
    dst.vmax = max(dst.vmax, src.vmax)
    return True


# -- publisher (engine side) -------------------------------------------------

class FleetMetricsPublisher:
    """Background thread publishing this engine's registry snapshot into
    the fleet metrics hash every `interval_s`."""

    def __init__(self, broker, stream: str, engine: str,
                 registry: MetricsRegistry, interval_s: float = 2.0):
        self.broker = broker
        self.key = metrics_key(stream)
        self.engine = engine
        self.registry = registry
        self.interval_s = float(interval_s)
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._down = False

    def publish_once(self) -> bool:
        self._seq += 1
        blob = registry_blob(self.registry, self.engine, self._seq)
        try:
            self.broker.hset(self.key, self.engine, json.dumps(blob))
        except Exception as e:  # noqa: BLE001 — broker outage: warn
            if not self._down:  # once, keep serving, retry next tick
                logger.warning("fleet metrics %s: publish failed (%s); "
                               "retrying each interval", self.engine, e)
                self._down = True
            return False
        if self._down:
            logger.info("fleet metrics %s: broker back, publishing "
                        "resumed", self.engine)
            self._down = False
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.publish_once()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="serving-fleet-metrics", daemon=True)
        self._thread.start()

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        if flush:
            self.publish_once()


# -- aggregator (gateway side) -----------------------------------------------

class FleetMetricsAggregator:
    """Merges engine blobs (plus the gateway's own registry) into one
    scrape-ready registry. `alive_fn` (typically the gateway
    FleetTracker's alive set) filters dead engines' stale blobs out of
    the merge; when it returns None the filter degrades open."""

    def __init__(self, broker, stream: str, registry: MetricsRegistry,
                 alive_fn: Optional[Callable[[], Optional[Set[str]]]]
                 = None):
        self.broker = broker
        self.key = metrics_key(stream)
        self.registry = registry           # gateway-local registry
        self.alive_fn = alive_fn
        self._age_gauge = registry.gauge(
            "fleet_scrape_age_s",
            "seconds since each engine's fleet metrics blob last made "
            "seq progress, on this gateway's monotonic clock")
        # engine -> (last_seq, monotonic time the seq last advanced)
        self._progress: Dict[str, Any] = {}
        self._last: Dict[str, Dict[str, Any]] = {}

    # -- fetch -------------------------------------------------------------
    def _fetch(self) -> Dict[str, Dict[str, Any]]:
        try:
            raw = self.broker.hgetall(self.key) or {}
        except Exception as e:  # noqa: BLE001 — a scrape during a
            logger.warning("fleet metrics: hgetall failed: %s", e)
            return self._last   # broker blip serves the last view
        blobs: Dict[str, Dict[str, Any]] = {}
        now = time.monotonic()
        for eng, blob in raw.items():
            try:
                d = json.loads(blob)
            except (TypeError, ValueError):
                continue
            if not isinstance(d, dict):
                continue
            eng = str(eng)
            blobs[eng] = d
            seq = d.get("seq", 0)
            prev = self._progress.get(eng)
            if prev is None or prev[0] != seq:
                self._progress[eng] = (seq, now)
        for eng in blobs:
            self._age_gauge.set(now - self._progress[eng][1],
                                engine=eng)
        self._last = blobs
        return blobs

    # -- merge -------------------------------------------------------------
    def merged(self, local: Optional[MetricsRegistry] = None
               ) -> MetricsRegistry:
        """A fresh registry holding every alive engine's series plus
        the local registry's, with `scope="fleet"` rollups for counters
        and histograms."""
        blobs = self._fetch()
        alive = self.alive_fn() if self.alive_fn is not None else None
        if alive is not None:
            blobs = {e: b for e, b in blobs.items() if e in alive}
        published = set(blobs)
        merged = MetricsRegistry()
        if local is None:
            local = self.registry
        sources = [(True, registry_blob(local, None, 0))]
        sources.extend((False, b) for b in blobs.values())
        for is_local, blob in sources:
            for name, fam in (blob.get("counters") or {}).items():
                self._merge_counter(merged, name, fam, is_local,
                                    published)
            for name, fam in (blob.get("gauges") or {}).items():
                self._merge_gauge(merged, name, fam, is_local, published)
            for name, fam in (blob.get("hists") or {}).items():
                self._merge_hist_family(merged, name, fam, is_local,
                                        published)
        return merged

    @staticmethod
    def _skip_local(is_local: bool, labels: Dict[str, str],
                    published: Set[str]) -> bool:
        # blob wins over the local registry for engines that publish —
        # the engine-plus-gateway single-process deployment would
        # otherwise count its own series twice
        return is_local and labels.get("engine") in published

    def _merge_counter(self, merged, name, fam, is_local, published):
        try:
            c = merged.counter(name, fam.get("help", ""))
        except ValueError:
            return
        for labels, value in fam.get("series") or []:
            labels = dict(labels)
            if self._skip_local(is_local, labels, published):
                continue
            try:
                c.inc(float(value), **labels)
            except (TypeError, ValueError):
                continue
            if not is_local:
                roll = {k: v for k, v in labels.items() if k != "engine"}
                c.inc(float(value), scope="fleet", **roll)

    def _merge_gauge(self, merged, name, fam, is_local, published):
        try:
            g = merged.gauge(name, fam.get("help", ""))
        except ValueError:
            return
        for labels, value in fam.get("series") or []:
            labels = dict(labels)
            if self._skip_local(is_local, labels, published):
                continue
            try:
                g.set(float(value), **labels)
            except (TypeError, ValueError):
                continue

    def _merge_hist_family(self, merged, name, fam, is_local, published):
        try:
            hfam = merged.histogram(name, fam.get("help", ""))
        except ValueError:
            return
        for labels, sd in fam.get("series") or []:
            labels = dict(labels)
            if self._skip_local(is_local, labels, published):
                continue
            lh = _hist_from_blob(sd)
            if lh is None:
                continue
            self._insert_hist(hfam, labels, lh)
            if not is_local:
                roll = {k: v for k, v in labels.items() if k != "engine"}
                roll["scope"] = "fleet"
                self._insert_hist(hfam, roll, _hist_from_blob(sd))

    @staticmethod
    def _insert_hist(hfam: Histogram, labels: Dict[str, str],
                     lh: Optional[LogHistogram]) -> None:
        if lh is None:
            return
        key = _label_key(labels)
        with hfam._lock:
            existing = hfam._series.get(key)
            if existing is None:
                hfam._series[key] = lh
            elif not _merge_hist(existing, lh):
                logger.warning(
                    "fleet metrics: histogram %s%s geometry mismatch — "
                    "series skipped from the merge", hfam.name, labels)

    # -- views -------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        blobs = self._fetch()
        now = time.monotonic()
        alive = self.alive_fn() if self.alive_fn is not None else None
        return {
            "published": len(blobs),
            "engines": {
                eng: {"seq": b.get("seq", 0),
                      "age_s": round(now - self._progress[eng][1], 3),
                      "alive": (None if alive is None
                                else eng in alive)}
                for eng, b in sorted(blobs.items())},
        }
