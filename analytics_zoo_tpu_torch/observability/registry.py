"""Streaming log-bucketed histogram.

Copied from `analytics_zoo_tpu/observability/registry.py` (`LogHistogram`
and the default geometry); the rest of that registry (counters, gauges,
labelled families) is not yet part of the port.
"""

from __future__ import annotations

import math

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
    owners (serving `Timer`) hold their own lock."""

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
