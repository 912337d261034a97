"""Broker circuit breaker + reconnect backoff.

Copied from `analytics_zoo_tpu/serving/breaker.py` as it is
(`BackoffPolicy`, `CircuitBreaker`, `ResilientBroker`).

The reference leans on Flink's restart strategy when Redis dies
(`FlinkRedisSource.scala` just throws; the job restarts); our engine's
stage threads must survive a dead broker themselves. Before this layer
the reader retried a dead broker in a hot-ish fixed 1 s loop and the
sink dropped straight to the at-least-once redelivery path. Now every
serving-side broker connection wears:

- a **CircuitBreaker** — closed → open after `failure_threshold`
  consecutive failures (every call fast-fails without touching the
  socket), open → half-open after `reset_timeout_s` (exactly one probe
  call is let through), half-open → closed on probe success / back to
  open on probe failure. State transitions land in the registry
  (`serving_broker_breaker_state` gauge, 0/1/2 =
  closed/open/half-open, plus a transitions counter) and log ONE line
  per transition — not one per failed attempt.
- a **BackoffPolicy** — capped exponential with jitter, used by the
  reader loop between reconnect attempts (replacing the fixed sleep)
  and by the sink's buffered-writeback flush.

`ResilientBroker` wraps any `Broker` with the breaker and carries the
`broker.<op>` fault-injection points the chaos suite drives.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Optional

from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.serving.broker import Broker

log = logging.getLogger("analytics_zoo_tpu_torch.serving")

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitOpenError(ConnectionError):
    """Fast-fail while the breaker is open: the broker was down moments
    ago and the reset window has not elapsed — callers must not pay a
    connect timeout per attempt."""


class BackoffPolicy:
    """Capped exponential backoff with jitter. `delay(attempt)` for
    attempt 1, 2, ... grows `initial_s * factor**(attempt-1)` up to
    `max_s`, then jitters ±`jitter` of the value so a fleet of
    reconnecting clients does not thundering-herd a restarting broker."""

    def __init__(self, initial_s: float = 0.05, max_s: float = 5.0,
                 factor: float = 2.0, jitter: float = 0.25):
        if initial_s <= 0 or max_s < initial_s or factor < 1:
            raise ValueError(
                f"bad backoff policy (initial={initial_s}, max={max_s}, "
                f"factor={factor})")
        self.initial_s = initial_s
        self.max_s = max_s
        self.factor = factor
        self.jitter = max(0.0, min(float(jitter), 1.0))

    def delay(self, attempt: int) -> float:
        base = min(self.initial_s * self.factor ** max(attempt - 1, 0),
                   self.max_s)
        if not self.jitter:
            return base
        return base * (1.0 + self.jitter * (2.0 * random.random() - 1.0))


class CircuitBreaker:
    """Thread-safe closed/open/half-open breaker. `allow()` gates a
    call; `record_success()`/`record_failure()` report its outcome."""

    def __init__(self, name: str = "broker", failure_threshold: int = 3,
                 reset_timeout_s: float = 1.0, registry=None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.registry = registry       # clones rebuild with the same sink
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False     # half-open admits exactly one probe
        self._lock = threading.Lock()
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._state_gauge = registry.gauge(
            "serving_broker_breaker_state",
            "circuit breaker state per serving broker connection "
            "(0=closed, 1=open, 2=half-open)")
        self._transitions = registry.counter(
            "serving_broker_breaker_transitions_total",
            "circuit breaker state transitions, by broker and new state")
        self._state_gauge.set(0, broker=name)

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == OPEN and \
                    time.monotonic() - self._opened_at >= \
                    self.reset_timeout_s:
                return HALF_OPEN      # due for a probe
            return self._state

    def _transition(self, to: str):
        """Caller holds the lock. One log line + one metric update per
        transition — the log-spam cap the reader loop relies on."""
        if to == self._state:
            return
        log.warning("broker breaker %s: %s -> %s", self.name,
                    self._state, to)
        self._state = to
        self._state_gauge.set(_STATE_CODE[to], broker=self.name)
        self._transitions.inc(broker=self.name, to=to)

    def allow(self) -> bool:
        """True if a call may proceed now. While open, returns False
        until `reset_timeout_s` has elapsed, then admits exactly ONE
        half-open probe; further calls fast-fail until the probe
        reports back."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and not self._probing and \
                    time.monotonic() - self._opened_at >= \
                    self.reset_timeout_s:
                self._transition(HALF_OPEN)
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._probing = False
            self._transition(CLOSED)

    def record_failure(self):
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == HALF_OPEN or \
                    self._failures >= self.failure_threshold:
                self._opened_at = time.monotonic()
                self._transition(OPEN)


class ResilientBroker(Broker):
    """A `Broker` wearing a circuit breaker, for the serving engine's
    own connections (reader/sink). Clients keep their raw brokers — a
    client-side timeout is already the right degradation there.

    Every op funnels through `_guard`: fast-fail while the breaker is
    open, record the outcome otherwise. `RESPError` (an application
    error over a WORKING transport) counts as success for breaker
    purposes. Carries the `broker.<op>` fault-injection points."""

    def __init__(self, inner: Broker, role: str = "serving",
                 breaker: Optional[CircuitBreaker] = None,
                 registry=None):
        self.inner = inner
        self.role = role
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            name=role, registry=registry)

    def _guard(self, op: str, *args, **kwargs):
        if not self.breaker.allow():
            raise CircuitOpenError(
                f"{self.role} broker circuit open "
                f"(retry in <= {self.breaker.reset_timeout_s}s)")
        try:
            faults.fire(f"broker.{op}", role=self.role, op=op)
            result = getattr(self.inner, op)(*args, **kwargs)
        except Exception as e:
            from analytics_zoo_tpu_torch.serving.broker import RESPError
            if isinstance(e, RESPError):
                # the transport answered; the command was bad — not a
                # connectivity failure, must not open the circuit
                self.breaker.record_success()
            else:
                self.breaker.record_failure()
            raise
        self.breaker.record_success()
        return result

    def clone(self) -> "ResilientBroker":
        # independent breaker STATE (a clone serves a different stage
        # whose connection fails independently) with the SAME breaker
        # configuration — discarding the configured thresholds/registry
        # here would silently reset a caller's knobs to defaults
        return ResilientBroker(
            self.inner.clone(), role=self.role,
            breaker=CircuitBreaker(
                self.breaker.name,
                failure_threshold=self.breaker.failure_threshold,
                reset_timeout_s=self.breaker.reset_timeout_s,
                registry=self.breaker.registry))

    def close(self):
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    def xadd(self, stream, record):
        return self._guard("xadd", stream, record)

    def read_group(self, stream, group, consumer, count, block_ms=100):
        return self._guard("read_group", stream, group, consumer, count,
                           block_ms)

    def ack(self, stream, group, ids):
        return self._guard("ack", stream, group, ids)

    def claim_stale(self, stream, group, consumer, min_idle_ms, count):
        return self._guard("claim_stale", stream, group, consumer,
                           min_idle_ms, count)

    def pending_count(self, stream, group):
        return self._guard("pending_count", stream, group)

    def stream_depth(self, stream):
        return self._guard("stream_depth", stream)

    def writeback(self, key, mapping, stream, group, ids):
        return self._guard("writeback", key, mapping, stream, group, ids)

    def hset(self, key, field, value):
        return self._guard("hset", key, field, value)

    def hset_many(self, key, mapping):
        return self._guard("hset_many", key, mapping)

    def hget(self, key, field):
        return self._guard("hget", key, field)

    def hmget(self, key, fields):
        # the decode engine's recovery path reads a dead peer's token
        # rows through its resilient connection
        return self._guard("hmget", key, fields)

    def hgetall(self, key):
        return self._guard("hgetall", key)

    def hlen(self, key):
        return self._guard("hlen", key)

    def hdel(self, key, field):
        return self._guard("hdel", key, field)

    def hdel_many(self, key, fields):
        return self._guard("hdel_many", key, fields)
