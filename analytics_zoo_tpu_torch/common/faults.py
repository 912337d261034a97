"""Fault-injection harness — test-addressable failure points.

Copied from `analytics_zoo_tpu/common/faults.py` as it is. The port's
decode engine fires ``decode.prefill``, ``decode.step`` and
``decode.writeback``; its `ResilientBroker` fires ``broker.<op>``.

The reference platform inherits its failure testing from its substrates
(Flink restarts the job, Spark re-runs the task); this reproduction has
no substrate, so the fault-tolerance layer (replica quarantine, broker
circuit breaker, training auto-resume) carries its own chaos harness.

Production code marks each place a real fault would land with ONE call:

    from analytics_zoo_tpu_torch.common import faults
    faults.fire("broker.read_group", role="reader")

`fire` is a no-op (a single dict lookup) when nothing is injected, so
the hooks cost nothing in production. Tests and `bench_serving.py
--chaos` arm them:

    with faults.injected("replica.dispatch",
                         faults.Fault(mode="raise",
                                      match=lambda c: c["replica"] == 1)):
        ...                      # replica 1 now fails every batch

Well-known injection points (grep for `faults.fire` for the live list):

- ``broker.<op>``       every guarded op on a ResilientBroker-wrapped
                        serving connection (``role=reader|sink``)
- ``replica.dispatch``  one batch on one model replica
                        (``replica=<index>, batch=<count>``)
- ``trainer.step``      one training step, before device dispatch
                        (``iteration=<n>, attempt=<k>``)
- ``checkpoint.write``  a checkpoint artifact about to be committed
                        (``path=<temp file>``) — the truncate mode
                        simulates a crash mid-write
- ``decode.prefill``    one generative prefill (contiguous or one paged
                        chunk) about to dispatch
                        (``engine=<id>, uri=<uri>``) — raise simulates
                        an engine crash mid-admission, stall a wedged
                        prefill (the per-sequence watchdog's quarry)
- ``decode.step``       one batched decode step about to dispatch
                        (``engine=<id>``) — raise kills the engine loop
                        mid-decode, leaving records for the claim sweep
- ``decode.writeback``  the decode engine's fused row/final flush
                        (``engine=<id>``) — raise exercises the bounded
                        pending buffer (rows retained, loop keeps
                        stepping, drains on recovery)

Fault modes: ``raise`` (throw ``exc``), ``stall`` (sleep ``delay_s``
then proceed), ``truncate`` (cut the file at ``ctx["path"]`` to
``keep_fraction`` of its bytes). ``after`` skips the first N matching
calls; ``times`` bounds how often the fault trips (None = forever);
``match`` is a predicate over the call context. Thread-safe; faults
count their ``trips`` so tests can assert the site was actually hit.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional

MODES = ("raise", "stall", "truncate")


class FaultError(ConnectionError):
    """Default exception an armed ``raise`` fault throws — a
    ConnectionError subclass so broker-shaped sites treat it exactly
    like a dead transport."""


class Fault:
    def __init__(self, mode: str = "raise",
                 exc: Optional[BaseException] = None,
                 delay_s: float = 0.1,
                 keep_fraction: float = 0.5,
                 after: int = 0,
                 times: Optional[int] = None,
                 match: Optional[Callable[[Dict[str, Any]], bool]] = None):
        if mode not in MODES:
            raise ValueError(f"fault mode {mode!r} not in {MODES}")
        self.mode = mode
        self.exc = exc
        self.delay_s = delay_s
        self.keep_fraction = keep_fraction
        self.after = after
        self.times = times
        self.match = match
        self.trips = 0            # how often the fault actually fired
        self._seen = 0            # matching calls, incl. skipped `after`
        self._lock = threading.Lock()

    def _should_trip(self, ctx: Dict[str, Any]) -> bool:
        if self.match is not None and not self.match(ctx):
            return False
        with self._lock:
            self._seen += 1
            if self._seen <= self.after:
                return False
            if self.times is not None and self.trips >= self.times:
                return False
            self.trips += 1
            return True

    def __call__(self, point: str, ctx: Dict[str, Any]):
        if not self._should_trip(ctx):
            return
        if self.mode == "stall":
            time.sleep(self.delay_s)
            return
        if self.mode == "truncate":
            path = ctx.get("path")
            if path and os.path.exists(path):
                keep = int(os.path.getsize(path) * self.keep_fraction)
                with open(path, "r+b") as fh:
                    fh.truncate(keep)
            return
        raise self.exc if self.exc is not None else FaultError(
            f"injected fault at {point} ({ctx})")


_faults: Dict[str, Fault] = {}
_mutate = threading.Lock()


def inject(point: str, fault: Fault) -> Fault:
    """Arm `fault` at `point` (replacing any previous fault there)."""
    with _mutate:
        _faults[point] = fault
    return fault


def clear(point: Optional[str] = None):
    """Disarm one point, or every point when None."""
    with _mutate:
        if point is None:
            _faults.clear()
        else:
            _faults.pop(point, None)


def active(point: str) -> Optional[Fault]:
    return _faults.get(point)


def fire(point: str, **ctx):
    """The production-side hook: evaluate the fault armed at `point`, if
    any. Reads race-free against inject/clear (CPython dict get is
    atomic); the common disarmed case is one failed lookup."""
    fault = _faults.get(point)
    if fault is not None:
        fault(point, ctx)


class injected:
    """Context manager: arm for the block, disarm on exit (even when the
    block raises — chaos tests must never leak a fault into the next
    test)."""

    def __init__(self, point: str, fault: Optional[Fault] = None, **kw):
        self.point = point
        self.fault = fault if fault is not None else Fault(**kw)

    def __enter__(self) -> Fault:
        return inject(self.point, self.fault)

    def __exit__(self, *exc):
        clear(self.point)
        return False
