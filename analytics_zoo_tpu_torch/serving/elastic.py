"""Elastic traffic management: the decisions layer.

Copied from `analytics_zoo_tpu/serving/elastic.py` as it is (L1-429):
`BucketCostModel` (L45), `BatchPlan` (L123), `AdaptiveBatchController`
(L141), `TierTable` (L301) and `AdmissionController` (L333).

The reference platform absorbs bursty traffic with Flink backpressure
and dynamic operator parallelism (PAPER.md L0); our fleet was static —
fixed engine count, fixed ``batch_size``/``batch_timeout_ms``, every
request padded to a power-of-two bucket even at 3 rps. This module holds
the three decision makers that replace those constants, each driven by
telemetry the stack already collects:

- **BucketCostModel** — live per-bucket service cost: an EWMA over the
  measured dispatch→materialize time of every batch, mirrored into the
  ``serving_bucket_ms`` histogram (labeled by bucket) and the
  ``serving_bucket_cost_ms`` gauges. The model learns from traffic —
  before a bucket's first observation its cost reads as unknown and
  the controller plans with the nearest smaller bucket's estimate (or
  optimistically with zero; self-heals after one batch). All buckets
  are pre-warmed, so the model compares *costs*, never compile risk.
- **AdaptiveBatchController** — deadline-aware micro-batching: given the
  queued record count, the oldest record's age, and the broker backlog,
  it picks the target bucket and how long the reader may keep
  accumulating. Under light load it stops padding — dispatch the
  smallest bucket that fits, immediately; under heavy load it grows
  toward the throughput-optimal bucket (max records/sec = bucket /
  cost(bucket)) while the deadline budget allows.
- **AdmissionController** — tiered admission at the gateway: priority
  classes (config-declared, lowest first) each own a slice of the
  backlog headroom, so a cheap early 429 + Retry-After lands on the
  batch tier long before the premium tier feels anything — and long
  before the engine-side 503s. The engine's reader reuses the tier
  table to shed lowest-tier records first under overload
  (``ClusterServing`` writes "SHED" results for them, so accepted
  records are answered, never silently dropped).

`FleetAutoscaler` (the third tentpole leg) lives in `serving/fleet.py`
beside the heartbeat machinery it reads.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple


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


class BatchPlan:
    """One reader-cycle decision: accumulate toward `target` records for
    at most `wait_ms` more, then dispatch."""

    __slots__ = ("target", "wait_ms", "budget_ms", "reason")

    def __init__(self, target: int, wait_ms: float, budget_ms: float,
                 reason: str):
        self.target = int(target)
        self.wait_ms = max(0.0, float(wait_ms))
        self.budget_ms = float(budget_ms)
        self.reason = reason

    def __repr__(self):
        return (f"BatchPlan(target={self.target}, "
                f"wait_ms={self.wait_ms:.1f}, reason={self.reason!r})")


class AdaptiveBatchController:
    """Deadline-aware micro-batching policy (tentpole a).

    Three policies:

    - ``adaptive`` (default): with a deadline configured, each plan
      spends the oldest queued record's remaining budget —
      ``deadline_ms - age - cost(dispatched bucket) - margin`` — on growing the
      batch toward the throughput-optimal bucket, but ONLY while the
      broker backlog says more records exist to grow with. Light load
      (empty backlog) dispatches the smallest fitting bucket with zero
      added wait. Without a deadline it degrades to exactly the legacy
      fixed policy (wait ``batch_timeout_ms`` toward ``batch_size``),
      so default configs behave byte-identically.
    - ``fixed``: the fixed straggler-sweep policy, explicit.
    - ``static``: ALWAYS wait the full timeout and pad every dispatch
      to the largest reachable bucket — the strawman the bench's
      light-load A/B measures the adaptive win against.
    """

    POLICIES = ("adaptive", "fixed", "static")

    def __init__(self, buckets: Sequence[int], batch_size: int,
                 batch_timeout_ms: float, policy: str = "adaptive",
                 deadline_ms: Optional[float] = None,
                 margin_ms: float = 2.0,
                 cost_model: Optional[BucketCostModel] = None,
                 registry=None, labels: Optional[Dict] = None):
        if policy not in self.POLICIES:
            raise ValueError(
                f"batch policy {policy!r} is not one of "
                f"{'/'.join(self.POLICIES)}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms={deadline_ms} must be > 0")
        self.buckets = sorted(int(b) for b in buckets) or [1]
        self.batch_size = int(batch_size)
        self.batch_timeout_ms = float(batch_timeout_ms)
        self.policy = policy
        self.deadline_ms = deadline_ms
        self.margin_ms = float(margin_ms)
        labels = dict(labels or {})
        self.cost = cost_model if cost_model is not None else \
            BucketCostModel(self.buckets, registry=registry,
                            labels=labels)
        # the largest bucket the reader can actually fill: buckets past
        # the one covering batch_size cannot occur (warmup caps there
        # too, so growing past it would COMPILE on the request path)
        self.cap = self._next_bucket(self.batch_size)
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._age_hist = registry.histogram(
            "serving_queue_age_ms",
            "age of the oldest queued record at dispatch time (how much "
            "deadline budget batching consumed)")
        self._chosen = registry.counter(
            "serving_chosen_bucket_total",
            "dispatches by the bucket the adaptive controller chose")
        self._labels = labels

    def _next_bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def pad_bucket(self, n: int) -> int:
        """The bucket a decoded group of `n` records pads to: the
        smallest that fits (adaptive/fixed — no-padding-under-light-load
        is the point), or the largest reachable one (static, the bench
        strawman that pads a 1-record batch all the way up)."""
        if self.policy == "static":
            return max(self.cap, self._next_bucket(n))
        return self._next_bucket(n)

    # -- planning ----------------------------------------------------------
    def plan(self, queued: int, oldest_age_ms: float,
             backlog: Optional[int]) -> BatchPlan:
        """Decide target size and further wait for one reader cycle.

        `backlog` counts records waiting BEYOND the ones in hand — the
        engine subtracts its own in-flight records from the stream
        depth before calling (the stream retains a record until sink
        commit, so raw depth would read this engine's own pipeline as
        other people's load and misclassify a light trickle as heavy).
        None = unknown. `oldest_age_ms` is measured from THIS engine's
        first pickup of the oldest record — records carry no enqueue
        timestamp (cross-host clocks are not trusted anywhere in the
        fleet design), so time spent queued in the broker, or idling
        before a claim sweep, is budgeted by the admission layer's
        backlog thresholds rather than this deadline."""
        queued = max(0, int(queued))
        fit = self._next_bucket(max(queued, 1))
        if self.policy == "static":
            # strawman: always fill/pad to the largest reachable bucket
            wait = 0.0 if queued >= self.cap else self.batch_timeout_ms
            return BatchPlan(self.cap, wait, float("inf"), "static")
        if self.policy == "fixed" or self.deadline_ms is None:
            # legacy straggler-sweep semantics, bit-for-bit: one
            # batch_timeout_ms wait toward batch_size when short
            wait = 0.0 if queued >= self.batch_size \
                else self.batch_timeout_ms
            return BatchPlan(self.batch_size, wait, float("inf"),
                             "fixed")
        # adaptive with a deadline: budget is what's left of the oldest
        # record's deadline after the target bucket's estimated service
        # time and a safety margin
        cost = self.cost.cost_ms(fit) or 0.0
        budget = self.deadline_ms - oldest_age_ms - cost - self.margin_ms
        if queued and budget <= 0:
            # already eating into the deadline: dispatch NOW, smallest
            # fitting bucket (never pad up when late)
            return BatchPlan(fit, 0.0, budget, "deadline")
        if backlog is None:
            # UNKNOWN load (transport without XLEN, probe mid-outage):
            # plan conservatively — the legacy straggler-sweep shape,
            # clipped to the remaining budget. Guessing "light" here
            # would dispatch 1-2 record micro-batches for a whole
            # broker blip under genuinely heavy load.
            wait = 0.0 if queued >= self.batch_size else \
                min(max(budget, 0.0), self.batch_timeout_ms)
            return BatchPlan(self.batch_size, wait, budget, "unknown")
        opt = self.cost.throughput_optimal(self.cap)
        heavy = backlog > 0
        if not heavy:
            # light load: nothing else to batch with — the whole
            # anti-padding win is dispatching `fit` immediately instead
            # of waiting out a straggler window for records that are
            # not coming
            return BatchPlan(fit, 0.0, budget, "light")
        target = max(fit, min(opt if opt is not None else self.cap,
                              self.cap))
        # the budget must price the bucket we'd actually DISPATCH: a
        # larger target costs more service time than `fit`, and
        # budgeting with fit's cost would grow into a bucket whose own
        # service time blows the deadline. If the target is
        # unaffordable, dispatch the smallest fit now instead.
        cost_t = self.cost.cost_ms(target)
        budget_t = self.deadline_ms - oldest_age_ms \
            - (cost_t if cost_t is not None else cost) - self.margin_ms
        if queued and budget_t <= 0:
            return BatchPlan(fit, 0.0, budget, "deadline")
        if queued >= target:
            return BatchPlan(target, 0.0, budget_t, "full")
        # grow toward the throughput-optimal bucket, but never spend
        # more than the remaining budget (or the configured timeout —
        # the broker read is the wait, so arrival latency is covered)
        wait = min(budget_t, self.batch_timeout_ms) if queued \
            else min(max(budget_t, 0.0), self.batch_timeout_ms)
        return BatchPlan(target, wait, budget_t, "grow")

    # -- dispatch-side accounting -----------------------------------------
    def record_dispatch(self, bucket: int, oldest_age_ms: float) -> None:
        self._age_hist.observe(max(0.0, oldest_age_ms), **self._labels)
        self._chosen.inc(bucket=str(int(bucket)), **self._labels)

    def observe_service(self, bucket: int, ms: float) -> None:
        self.cost.observe(bucket, ms)


class TierTable:
    """Config-declared priority classes, lowest first. Records carry the
    tier NAME (a header at the gateway, a field on the broker record);
    unknown or missing names map to the lowest tier — a producer that
    never heard of tiers is batch traffic, not premium."""

    def __init__(self, tiers: Sequence[str]):
        names = [str(t) for t in tiers if str(t).strip()]
        if not names:
            raise ValueError("admission tiers must be a non-empty list "
                             "(lowest priority first)")
        if len(set(names)) != len(names):
            raise ValueError(f"admission tiers {names} contain duplicates")
        self.names = names
        self._level = {n: i for i, n in enumerate(names)}

    def level(self, name) -> int:
        if name is None:
            return 0
        return self._level.get(str(name), 0)

    def name(self, level: int) -> str:
        return self.names[max(0, min(level, len(self.names) - 1))]

    @property
    def top(self) -> int:
        return len(self.names) - 1

    def __len__(self):
        return len(self.names)


class AdmissionController:
    """Tiered early admission at the gateway (tentpole c).

    Each tier owns a slice of the backlog headroom: tier level ``l`` of
    ``n`` admits while ``backlog < max_backlog * (l+1) / n``. As load
    climbs, the batch tier starts seeing cheap 429s (with a Retry-After
    sized to the drain horizon) while the premium tier still has its
    full budget; only past ``max_backlog`` does the top tier throttle.
    This runs BEFORE the record touches the broker — the expensive 503
    paths (quarantined pool, dead fleet) stay as the last line.

    Backlog reads are rate-limited and cached, one poll per
    ``poll_min_interval_s`` shared by every concurrent request; an
    unreachable broker admits (the downstream enqueue will surface the
    real error — admission must not add a failure mode).

    Partitioned plane: `partitions > 1` makes the backlog
    the SUM across the partition streams (total queued work is what
    admission gates on) and exports each stream's depth as a
    ``serving_partition_depth{partition=}`` series — the per-shard view
    that shows a hot partition or an orphaned one (depth climbing with
    no engine holding its lease) before clients feel it."""

    def __init__(self, broker, stream: str, tiers: Sequence[str],
                 max_backlog: int = 512, registry=None,
                 poll_min_interval_s: float = 0.2,
                 retry_after_s: float = 1.0,
                 partitions: int = 1):
        if max_backlog <= 0:
            raise ValueError(f"max_backlog={max_backlog} must be > 0")
        from analytics_zoo_tpu_torch.serving.partitions import (
            partition_streams, validate_partitions)
        self.broker = broker
        self.stream = stream
        self.partitions = validate_partitions(partitions)
        self._streams = partition_streams(stream, self.partitions)
        self.tiers = tiers if isinstance(tiers, TierTable) \
            else TierTable(tiers)
        self.max_backlog = int(max_backlog)
        self.poll_min_interval_s = float(poll_min_interval_s)
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        self._backlog: Optional[int] = None
        self._last_poll = 0.0
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._outcomes = registry.counter(
            "serving_admission_total",
            "admission decisions by outcome (accepted, rejected, shed) "
            "and tier")
        self._backlog_gauge = registry.gauge(
            "serving_backlog_depth",
            "broker stream depth (enqueued records not yet committed) "
            "as last sampled by the elastic layer")
        self._partition_gauge = registry.gauge(
            "serving_partition_depth",
            "per-partition broker stream depth as last sampled by the "
            "elastic layer (series appear only when partitions > 1)")

    def threshold(self, level: int) -> int:
        n = len(self.tiers)
        level = max(0, min(level, n - 1))
        return max(1, int(self.max_backlog * (level + 1) / n))

    def backlog(self) -> Optional[int]:
        now = time.monotonic()
        with self._lock:
            if now - self._last_poll < self.poll_min_interval_s:
                return self._backlog
            self._last_poll = now
        try:
            depths = [int(self.broker.stream_depth(s))
                      for s in self._streams]
            depth = sum(depths)
        except Exception:  # noqa: BLE001 — admission must not add faults
            depth, depths = None, None
        with self._lock:
            self._backlog = depth
        if depth is not None:
            self._backlog_gauge.set(float(depth))
            if self.partitions > 1 and depths is not None:
                for i, d in enumerate(depths):
                    self._partition_gauge.set(float(d),
                                              partition=str(i))
        return depth

    def admit(self, tier_name) -> Tuple[bool, float]:
        """(admitted, retry_after_s). Unknown backlog admits."""
        level = self.tiers.level(tier_name)
        name = self.tiers.name(level)
        depth = self.backlog()
        if depth is not None and depth >= self.threshold(level):
            self._outcomes.inc(outcome="rejected", tier=name)
            return False, self.retry_after_s
        self._outcomes.inc(outcome="accepted", tier=name)
        return True, 0.0
