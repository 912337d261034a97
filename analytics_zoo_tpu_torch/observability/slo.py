"""Declarative SLOs with burn-rate evaluation.

Copied from `analytics_zoo_tpu/observability/slo.py` as it is (L1-336):
`SLOObjectives` (L46), `_Sample` (L78), `_window_quantile` (L96) and
`SLOTracker` (L117).

The serving config declares objectives —

    params:
      slo:
        latency_ms: 50          # p-quantile latency target
        latency_quantile: 0.95
        availability: 0.999     # non-degraded fraction of results
        window_s: 300

— and `SLOTracker` evaluates them against the metrics the pipeline
already publishes: windowed latency quantiles from the
`serving_batch_ms` log-histogram's bucket counts (delta between ring
samples, so the window really is a window, not process-lifetime), and
availability from `serving_records_total{outcome=served|failed}` (the
sink counts NaN-degraded records as `failed`).

Burn rate is the standard SRE ratio — how fast the error budget is
being spent relative to its sustainable rate:

- availability: (1 - observed) / (1 - target); 1.0 = spending exactly
  the budget, >1 = burning it down.
- latency: fraction of window observations over the target, over the
  allowed fraction (1 - quantile).

`MetricsReporter(slo=tracker)` evaluates on its digest cadence (so the
burn gauges stay fresh for scrapes), and `ClusterServing.health()` /
the frontend's `/healthz` evaluate on demand (internally rate-limited).
Evaluation publishes `slo_latency_ms`, `slo_availability`,
`slo_burn_rate{objective}`, and `slo_met{objective}` gauges.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger("analytics_zoo_tpu_torch.observability")


@dataclass
class SLOObjectives:
    """The declarative objective set (all optional — an SLO block with
    only latency, or only availability, is legal)."""

    latency_ms: Optional[float] = None
    latency_quantile: float = 0.95
    availability: Optional[float] = None
    window_s: float = 300.0
    latency_family: str = "serving_batch_ms"

    def validate(self) -> "SLOObjectives":
        if self.latency_ms is not None and self.latency_ms <= 0:
            raise ValueError(
                f"slo.latency_ms={self.latency_ms} must be > 0")
        if not (0.0 < self.latency_quantile < 1.0):
            raise ValueError(
                f"slo.latency_quantile={self.latency_quantile} must be "
                "in (0, 1)")
        if self.availability is not None and not (
                0.0 < self.availability <= 1.0):
            raise ValueError(
                f"slo.availability={self.availability} must be in (0, 1]")
        if self.window_s <= 0:
            raise ValueError(
                f"slo.window_s={self.window_s} must be > 0")
        return self

    @property
    def empty(self) -> bool:
        return self.latency_ms is None and self.availability is None


class _Sample:
    """One ring entry: cumulative state at time t, so (cur - old) is the
    window accumulation."""

    __slots__ = ("t", "counts", "count", "served", "failed", "base",
                 "growth")

    def __init__(self, t, counts, count, served, failed,
                 base=1e-3, growth=1.2):
        self.t = t
        self.counts = counts       # summed histogram bucket counts
        self.count = count
        self.served = served
        self.failed = failed
        self.base = base
        self.growth = growth


def _window_quantile(counts: List[int], q: float, base: float,
                     growth: float) -> float:
    """Quantile over a delta bucket-count vector, interpolated inside
    the crossing bucket (same estimator as LogHistogram.percentile,
    minus the min/max clamp a delta view cannot know)."""
    total = sum(counts)
    if not total:
        return 0.0
    target = q * total
    seen = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        if seen + c >= target:
            lo = base * (growth ** i)
            hi = lo * growth
            return lo + (hi - lo) * (target - seen) / c
        seen += c
    return base * (growth ** len(counts))


class SLOTracker:
    """Evaluate declared objectives over a sliding window of registry
    state. Thread-safe; `evaluate()` is internally rate-limited (at most
    one fresh evaluation per `min_interval_s` — healthz polls and the
    reporter can both call it freely)."""

    def __init__(self, objectives: SLOObjectives, registry=None,
                 min_interval_s: float = 1.0):
        from analytics_zoo_tpu_torch.observability.registry import get_registry
        self.objectives = objectives.validate()
        self.registry = registry if registry is not None else get_registry()
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._ring: List[_Sample] = []
        self._last: Optional[Dict[str, Any]] = None
        self._last_t = 0.0
        self._was_met = True
        self._auto_stop = threading.Event()
        self._auto_thread: Optional[threading.Thread] = None

    # -- self-driving evaluation ------------------------------------------
    def start_auto(self, interval_s: Optional[float] = None
                   ) -> "SLOTracker":
        """Keep the window warm from a daemon thread: without one, SLO
        detection silently depends on something polling /metrics or
        /healthz more often than `window_s` — scrapes farther apart
        than the window would empty the ring and every evaluation would
        be vacuously met. `ClusterServing.start()` drives this when
        objectives are configured; the interval defaults to window_s/4
        capped at 15 s."""
        if self._auto_thread is not None:
            return self
        interval = interval_s if interval_s is not None \
            else min(self.objectives.window_s / 4.0, 15.0)
        self._auto_stop.clear()

        def loop():
            while not self._auto_stop.wait(interval):
                try:
                    self.evaluate(force=True)
                except Exception as e:  # noqa: BLE001 — keep sampling
                    log.debug("slo auto-evaluation failed: %s: %s",
                              type(e).__name__, e)

        self._auto_thread = threading.Thread(target=loop,
                                             name="slo-evaluator",
                                             daemon=True)
        self._auto_thread.start()
        return self

    def stop_auto(self):
        self._auto_stop.set()
        if self._auto_thread is not None:
            self._auto_thread.join(timeout=5)
            self._auto_thread = None

    # -- raw state ---------------------------------------------------------
    def _histogram_state(self) -> Tuple[List[int], int, float, float]:
        """Summed bucket counts across every series of the latency
        family (plus geometry); zeros when the family doesn't exist."""
        from analytics_zoo_tpu_torch.observability.registry import Histogram
        fam = self.registry.get(self.objectives.latency_family)
        if not isinstance(fam, Histogram):
            return [], 0, 1e-3, 1.2
        counts: List[int] = []
        total = 0
        base, growth = 1e-3, 1.2
        for key in fam.label_keys():
            h = fam.child(**dict(key))
            with fam._lock:
                base, growth = h.base, h.growth
                if not counts:
                    counts = list(h.counts)
                else:
                    counts = [a + b for a, b in zip(counts, h.counts)]
                total += h.count
        return counts, total, base, growth

    def _record_state(self) -> Tuple[float, float]:
        fam = self.registry.get("serving_records_total")
        if fam is None:
            return 0.0, 0.0
        return fam.value(outcome="served"), fam.value(outcome="failed")

    # -- evaluation --------------------------------------------------------
    def evaluate(self, force: bool = False) -> Dict[str, Any]:
        with self._lock:
            now = time.monotonic()
            if (not force and self._last is not None
                    and now - self._last_t < self.min_interval_s):
                return self._last
            counts, count, base, growth = self._histogram_state()
            served, failed = self._record_state()
            cur = _Sample(now, counts, count, served, failed,
                          base=base, growth=growth)
            window = self.objectives.window_s
            # baseline: the oldest sample still inside the window
            self._ring = [s for s in self._ring if now - s.t <= window]
            old = self._ring[0] if self._ring else None
            self._ring.append(cur)
            result = self._evaluate_pair(old, cur)
            self._publish(result)
            # one WARNING per met → violated edge, owned HERE so every
            # caller (auto thread, reporter, healthz, scrape) shares a
            # single edge detector instead of each logging its own
            met = bool(result.get("met", True))
            if not met and self._was_met:
                log.warning(
                    "SLO violated: burn rates %s",
                    {k: v.get("burn_rate") for k, v in result.items()
                     if isinstance(v, dict) and "burn_rate" in v})
            self._was_met = met
            self._last, self._last_t = result, now
            return result

    def _evaluate_pair(self, old: Optional[_Sample],
                       cur: _Sample) -> Dict[str, Any]:
        obj = self.objectives
        out: Dict[str, Any] = {
            "met": True,
            "window_s": round(cur.t - old.t, 1) if old else 0.0,
        }
        if obj.latency_ms is not None:
            if old is None:
                # no baseline yet: process-lifetime cumulative counts are
                # NOT a window — a first /healthz poll hours after an old,
                # recovered outage must not report it as a live violation
                dcounts, n = [], 0
            elif old.counts and cur.counts:
                dcounts = [c - o for c, o in zip(cur.counts, old.counts)]
                n = cur.count - old.count
            else:
                dcounts, n = list(cur.counts), cur.count
            base, growth = cur.base, cur.growth
            lat: Dict[str, Any] = {"target_ms": obj.latency_ms,
                                   "quantile": obj.latency_quantile,
                                   "count": max(0, n)}
            if n > 0:
                observed = _window_quantile(dcounts, obj.latency_quantile,
                                            base, growth)
                # observations strictly above the target's bucket are
                # over target; the crossing bucket itself counts pro
                # rata of where the target falls inside it
                over = 0.0
                for i, c in enumerate(dcounts):
                    if c <= 0:
                        continue
                    lo = base * (growth ** i)
                    hi = lo * growth
                    if lo >= obj.latency_ms:
                        over += c
                    elif hi > obj.latency_ms:
                        over += c * (hi - obj.latency_ms) / (hi - lo)
                frac_over = min(1.0, over / n)
                burn = frac_over / max(1e-9, 1.0 - obj.latency_quantile)
                lat.update(observed_ms=round(observed, 3),
                           frac_over_target=round(frac_over, 6),
                           burn_rate=round(burn, 3),
                           met=burn <= 1.0)
            else:
                lat.update(observed_ms=None, frac_over_target=0.0,
                           burn_rate=0.0, met=True)   # no data: vacuous
            out["latency"] = lat
            out["met"] = out["met"] and lat["met"]
        if obj.availability is not None:
            # same no-baseline rule as latency: the first sample only
            # seeds the ring
            dserved = cur.served - old.served if old else 0.0
            dfailed = cur.failed - old.failed if old else 0.0
            avail: Dict[str, Any] = {"target": obj.availability,
                                     "served": dserved,
                                     "failed": dfailed}
            if dserved > 0:
                observed = max(0.0, (dserved - dfailed) / dserved)
                budget = max(1e-9, 1.0 - obj.availability)
                burn = (1.0 - observed) / budget
                avail.update(observed=round(observed, 6),
                             burn_rate=round(burn, 3),
                             met=burn <= 1.0)
            else:
                avail.update(observed=None, burn_rate=0.0, met=True)
            out["availability"] = avail
            out["met"] = out["met"] and avail["met"]
        return out

    def _publish(self, result: Dict[str, Any]) -> None:
        reg = self.registry
        burn_g = reg.gauge(
            "slo_burn_rate",
            "error-budget burn rate per objective (1.0 = spending "
            "exactly the budget; >1 = burning it down)")
        met_g = reg.gauge(
            "slo_met", "1 when the objective holds over the window, "
            "else 0, per objective (and 'all')")
        lat = result.get("latency")
        if lat is not None:
            reg.gauge("slo_latency_target_ms",
                      "declared latency objective").set(lat["target_ms"])
            if lat.get("observed_ms") is not None:
                reg.gauge(
                    "slo_latency_ms",
                    "observed windowed latency at the objective's "
                    "quantile").set(lat["observed_ms"],
                                    quantile=str(lat["quantile"]))
            burn_g.set(lat["burn_rate"], objective="latency")
            met_g.set(1.0 if lat["met"] else 0.0, objective="latency")
        avail = result.get("availability")
        if avail is not None:
            reg.gauge("slo_availability_target",
                      "declared availability objective"
                      ).set(avail["target"])
            if avail.get("observed") is not None:
                reg.gauge("slo_availability",
                          "observed windowed availability "
                          "(non-degraded fraction of served records)"
                          ).set(avail["observed"])
            burn_g.set(avail["burn_rate"], objective="availability")
            met_g.set(1.0 if avail["met"] else 0.0,
                      objective="availability")
        met_g.set(1.0 if result["met"] else 0.0, objective="all")
