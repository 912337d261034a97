"""Per-stage serving timers: running min/max/avg, top-N slowest, and
p50/p95/p99 from a streaming log-bucketed histogram.

Copied from `analytics_zoo_tpu/serving/timer.py` (`Timer`, `_Span`). The
port's `InferenceModel` records predict latency here. Timer records
SECONDS: bucket base 1 µs, growth 1.2, so relative error of a percentile
is bounded by ~9%.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, Dict, List, Optional

from analytics_zoo_tpu_torch.observability.registry import LogHistogram

# Timer records SECONDS: base=1µs, growth=1.2 → 107 buckets reach ~300 s.
_HIST_BASE = 1e-6
_HIST_GROWTH = 1.2
_HIST_BUCKETS = 107


class Timer:
    def __init__(self, name: str, top_n: int = 10,
                 observer: Optional[Callable[[float], None]] = None):
        self.name = name
        self.top_n = top_n
        # the lock MUST exist before reset() runs: the old getattr
        # fallback locked a throwaway Lock on first call, leaving that
        # reset racy against a concurrent record()
        self._lock = threading.Lock()
        self._observers: List[Callable[[float], None]] = (
            [observer] if observer is not None else [])
        self.reset()

    def add_observer(self, fn: Callable[[float], None]) -> "Timer":
        """Mirror every recorded duration (seconds) into `fn` — e.g. a
        registry histogram's observe. Called outside this Timer's lock."""
        self._observers.append(fn)
        return self

    def reset(self):
        with self._lock:
            self._top: List[float] = []
            self._hist = LogHistogram(base=_HIST_BASE, growth=_HIST_GROWTH,
                                      n_buckets=_HIST_BUCKETS)

    def record(self, seconds: float):
        with self._lock:
            self._hist.observe(seconds)
            if len(self._top) < self.top_n:
                heapq.heappush(self._top, seconds)
            else:
                heapq.heappushpop(self._top, seconds)
        for fn in self._observers:
            fn(seconds)

    def timing(self):
        """Context manager: `with timer.timing(): ...`"""
        return _Span(self)

    # -- accessors (all lock-guarded reads of the shared histogram) --------
    @property
    def count(self) -> int:
        with self._lock:
            return self._hist.count

    @property
    def total(self) -> float:
        with self._lock:
            return self._hist.total

    @property
    def min(self) -> float:
        with self._lock:
            return self._hist.vmin

    @property
    def max(self) -> float:
        with self._lock:
            return self._hist.vmax

    @property
    def avg(self) -> float:
        with self._lock:
            return self._hist.mean

    def percentile(self, q: float) -> float:
        """Seconds at quantile q in [0, 1] from the streaming histogram."""
        with self._lock:
            return self._hist.percentile(q)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            h = self._hist
            return {
                "name": self.name,
                "count": h.count,
                "avg_ms": round(h.mean * 1e3, 3),
                "min_ms": round(h.vmin * 1e3, 3) if h.count else 0.0,
                "max_ms": round(h.vmax * 1e3, 3),
                "p50_ms": round(h.percentile(0.50) * 1e3, 3),
                "p95_ms": round(h.percentile(0.95) * 1e3, 3),
                "p99_ms": round(h.percentile(0.99) * 1e3, 3),
                "top": sorted((round(t * 1e3, 3) for t in self._top),
                              reverse=True),
            }

    def __repr__(self):
        s = self.snapshot()
        return (f"Timer({self.name}: n={s['count']} avg={s['avg_ms']}ms "
                f"min={s['min_ms']}ms max={s['max_ms']}ms)")


class _Span:
    def __init__(self, timer: Timer):
        self.timer = timer

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.record(time.perf_counter() - self.t0)
        return False
