"""Periodic one-line metrics digest — the "is it healthy" glance.

Copied from `analytics_zoo_tpu/observability/reporter.py` (`digest`,
`MetricsReporter`). The `slo` argument takes an
`observability.slo.SLOTracker` (or any object with an `evaluate()`
method).

`MetricsReporter` wakes every `interval_s`, snapshots the registry, and
logs one INFO line: counters as value with rate-since-last-report,
gauges as current value, histograms as `n/p50/p99`. Optionally mirrors
the snapshot into a TensorBoard `SummaryWriter`
(`utils/tensorboard.write_metrics_snapshot`), so long trainings get the
same numbers in TB that the log line shows.

Used by `learn/trainer.fit_keras(metrics_report_s=...)` and available
standalone around any workload:

    with MetricsReporter(interval_s=30):
        serve_forever()
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional

from analytics_zoo_tpu_torch.observability.registry import (MetricsRegistry,
                                                            get_registry)

log = logging.getLogger("analytics_zoo_tpu_torch.observability")


def digest(snapshot: Dict[str, Dict[str, Any]],
           delta: Optional[Dict[str, Dict[str, Any]]] = None,
           interval_s: Optional[float] = None) -> str:
    """Compress a registry snapshot into one log line. `delta` (from
    `MetricsRegistry.delta`) plus `interval_s` adds per-second rates to
    counters. Empty families are skipped."""
    parts = []
    for name, fam in snapshot.items():
        dseries = {}
        if delta and name in delta:
            dseries = {tuple(sorted(s["labels"].items())): s
                       for s in delta[name].get("series", [])}
        for s in fam.get("series", []):
            lbl = "".join(
                f"[{v}]" for _, v in sorted(s["labels"].items()))
            if fam["kind"] == "counter":
                txt = f"{name}{lbl}={s['value']:g}"
                d = dseries.get(tuple(sorted(s["labels"].items())))
                if d is not None and interval_s:
                    txt += f"({d['value'] / interval_s:.1f}/s)"
                parts.append(txt)
            elif fam["kind"] == "gauge":
                parts.append(f"{name}{lbl}={s['value']:g}")
            else:  # histogram
                if not s["count"]:
                    continue
                parts.append(
                    f"{name}{lbl}=n{s['count']}"
                    f"/p50:{s['p50']:g}/p99:{s['p99']:g}")
    return " ".join(parts) if parts else "(no metrics)"


class MetricsReporter:
    """Daemon thread logging a digest every `interval_s`. `start()` is
    idempotent-ish (a second start raises); `stop()` joins and logs one
    final digest so short runs still leave a record."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 30.0,
                 logger: Optional[logging.Logger] = None,
                 writer=None, slo=None):
        """`slo`: an `observability.slo.SLOTracker` — evaluated on every
        report BEFORE the digest, so the burn-rate/`slo_met` gauges are
        fresh in the logged line and for any scrape that follows the
        same cadence. The tracker itself owns the one-WARNING-per-
        (met → violated)-edge logging, so it fires whichever driver
        evaluates first."""
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.registry = registry if registry is not None else get_registry()
        self.interval_s = interval_s
        self.log = logger or log
        self.writer = writer       # optional tensorboard SummaryWriter
        self.slo = slo
        self._prev: Optional[Dict[str, Dict[str, Any]]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._step = 0

    def _evaluate_slo(self):
        if self.slo is None:
            return
        try:
            self.slo.evaluate()
        except Exception as e:  # noqa: BLE001 — SLO math must never
            # take down the digest thread it rides on
            self.log.debug("slo evaluation failed: %s: %s",
                           type(e).__name__, e)

    def _report(self):
        self._evaluate_slo()
        snap = self.registry.snapshot()
        d = self.registry.delta(self._prev) if self._prev else None
        self.log.info("metrics: %s", digest(snap, d, self.interval_s))
        if self.writer is not None:
            from analytics_zoo_tpu_torch.utils.tensorboard import \
                write_metrics_snapshot
            self._step += 1
            write_metrics_snapshot(self.writer, snap, self._step)
        self._prev = snap

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self._report()

    def start(self) -> "MetricsReporter":
        if self._thread is not None:
            raise RuntimeError("reporter already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="metrics-reporter",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None
        self._report()             # final digest: short runs still report

    def __enter__(self) -> "MetricsReporter":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
