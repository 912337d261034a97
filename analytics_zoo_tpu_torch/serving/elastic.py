"""Elastic traffic management: the per-bucket cost model.

Copied from `analytics_zoo_tpu/serving/elastic.py` (`BucketCostModel`,
L45): live per-bucket service cost, an EWMA over measured call times,
mirrored into the ``serving_bucket_ms`` histogram (labelled by bucket) and
the ``serving_bucket_cost_ms`` gauges. The decode scheduler keeps one per
phase (decode step, prefill). `AdaptiveBatchController`, `TierTable` and
`AdmissionController` wait for the serving plane (ROADMAP.md queue 1,
item 4).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence


class BucketCostModel:
    """EWMA service-time model per batch bucket, fed by the pipeline.

    ``observe(bucket, ms)`` is called by the sink for every materialized
    batch (dispatch→materialize wall time — the cost a queued record
    actually pays once it boards that bucket). ``seed()`` installs a
    one-shot prior for callers that have a trustworthy estimate (tests,
    the bench); the engine deliberately does NOT seed from the warmup
    report — those times include compile/cache-load and would
    overstate cost by orders of magnitude. Thread-safe.
    """

    def __init__(self, buckets: Sequence[int], registry=None,
                 alpha: float = 0.2, labels: Optional[Dict] = None):
        self.buckets = sorted(int(b) for b in buckets)
        self.alpha = float(alpha)
        self._ewma: Dict[int, float] = {}
        self._lock = threading.Lock()
        self._labels = dict(labels or {})
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._hist = registry.histogram(
            "serving_bucket_ms",
            "per-bucket batch service time, dispatch to materialize "
            "(the adaptive batcher's live cost model)")
        self._cost_gauge = registry.gauge(
            "serving_bucket_cost_ms",
            "EWMA per-bucket service-cost estimate the adaptive batch "
            "controller plans with")

    def observe(self, bucket: int, ms: float) -> None:
        if ms < 0:
            return
        bucket = int(bucket)
        with self._lock:
            prev = self._ewma.get(bucket)
            cur = ms if prev is None else \
                prev + self.alpha * (ms - prev)
            self._ewma[bucket] = cur
        self._hist.observe(ms, bucket=str(bucket), **self._labels)
        self._cost_gauge.set(cur, bucket=str(bucket), **self._labels)

    def seed(self, bucket: int, ms: float) -> None:
        """Pre-load one bucket's estimate (warmup run time) without
        polluting the histogram — a compile-adjacent first run is a
        prior, not an observation."""
        with self._lock:
            self._ewma.setdefault(int(bucket), float(ms))

    def cost_ms(self, bucket: int) -> Optional[float]:
        with self._lock:
            if bucket in self._ewma:
                return self._ewma[bucket]
            # nearest known smaller bucket is a usable floor (per-batch
            # cost grows with bucket size on every measured model here)
            known = [b for b in self._ewma if b <= bucket]
            return self._ewma[max(known)] if known else None

    def throughput_optimal(self, cap: int) -> Optional[int]:
        """The bucket maximizing records/sec (= bucket / cost) among
        buckets with estimates, bounded by `cap` (the warmed reachable
        range); None until at least two buckets have costs — one point
        says nothing about the shape of the curve."""
        with self._lock:
            known = [(b, c) for b, c in self._ewma.items() if c > 0]
        if len(known) < 2:
            return None
        reachable = [(b, c) for b, c in known if b <= cap]
        if not reachable:
            return None
        return max(reachable, key=lambda bc: bc[0] / bc[1])[0]

    def snapshot(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._ewma)
