"""ReplicaSupervisor — quarantine/revival over the replica pool.

Copied from `analytics_zoo_tpu/serving/supervisor.py` as it is (L1-237):
`ReplicaSupervisor` (L44), over the port's replica pool
(`serving/inference_model.py`: `healthy_replicas`, `quarantine_replica`,
`revive_replica`, `probe_replica_async`, `quarantined_replicas` and the
`_on_replica_event` hook).

The reference survives a bad executor because Flink reschedules the
task slot; here one wedged/poisoned chip would keep receiving routed
batches forever, each degrading to "NaN". The supervisor sits above the
router and turns a bad replica into lost CAPACITY instead of lost
correctness:

- every routed batch reports its outcome + dispatch latency through
  `InferenceModel._on_replica_event` (installed by this class);
- `failure_threshold` CONSECUTIVE failures on one replica quarantine
  it (the router stops considering it, queued work re-dispatches to
  healthy replicas, in-flight permits transfer);
- a healthy replica whose dispatch latency is a sustained outlier —
  more than `latency_factor` × the pool's rolling median, above an
  absolute floor, `failure_threshold` times in a row — is quarantined
  too (a chip can be sick without raising);
- a probe thread re-tries each quarantined replica every
  `probe_interval_s` with a **canary batch** (the most recent batch
  any replica dispatched); a probe success revives the replica.

All-quarantined is a legal state: the router fails fast
(`NoHealthyReplicaError`), the dispatch stage parks batches until a
revival, and the HTTP frontend answers 503 + Retry-After instead of
hanging (see `http_frontend.py`).

Registry families: `serving_replica_quarantined_total{replica,reason}`,
`serving_replica_revivals_total{replica}`, `serving_replica_healthy`
(live gauge).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Deque, Dict, Optional

log = logging.getLogger("analytics_zoo_tpu_torch.serving")


class ReplicaSupervisor:
    def __init__(self, model, failure_threshold: int = 3,
                 latency_factor: float = 8.0,
                 latency_floor_ms: float = 50.0,
                 probe_interval_s: float = 0.5,
                 probe_timeout_s: float = 10.0,
                 registry=None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.model = model
        self.failure_threshold = failure_threshold
        self.latency_factor = latency_factor
        self.latency_floor_ms = latency_floor_ms
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self._consec: Dict[int, int] = collections.defaultdict(int)
        self._slow: Dict[int, int] = collections.defaultdict(int)
        self._suspended = False
        # rolling pool-wide latency window: the outlier baseline. One
        # shared deque (not per-replica): a sick replica must stand out
        # against the POOL, not against its own degraded history.
        self._lat_window: Deque[float] = collections.deque(maxlen=128)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self.quarantined_total = registry.counter(
            "serving_replica_quarantined_total",
            "replicas quarantined by the supervisor, by replica and "
            "reason (failures, latency)")
        self.revivals_total = registry.counter(
            "serving_replica_revivals_total",
            "quarantined replicas revived by a successful canary probe")
        self._healthy_gauge = registry.gauge(
            "serving_replica_healthy",
            "replicas currently accepting routed work (live)")
        self._healthy_fn = model.healthy_replicas
        self._healthy_gauge.set_function(self._healthy_fn)
        model._on_replica_event = self._record

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        self._thread = threading.Thread(target=self._probe_loop,
                                        name="replica-supervisor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            # the probe loop never blocks on a replica (async probes),
            # so it exits within one probe interval
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.model._on_replica_event is self._record:
            self.model._on_replica_event = None
        # compare-and-release, same discipline as the engine's gauges:
        # a stopped supervisor must not pin the model in the registry
        self._healthy_gauge.release_function(self._healthy_fn, freeze=True)

    # -- rollout hand-off ---------------------------------------
    def suspend(self):
        """Stop judging outcomes while a model swap is in flight: the
        first post-swap batches of a restructured version pay honest
        re-warmup latency, and counting those as outliers (or a torn
        mid-swap dispatch as a failure streak) would quarantine healthy
        replicas exactly when the rollout needs them. The canary probe
        loop keeps running — revival is still wanted mid-swap."""
        with self._lock:
            self._suspended = True

    def resume(self):
        """Re-arm supervision after a swap, with a CLEAN slate: strikes
        reset and the latency window drops — the new version's latency
        family must build its own baseline, not be judged against the
        old model's."""
        with self._lock:
            self._suspended = False
            self._consec.clear()
            self._slow.clear()
            self._lat_window.clear()

    # -- outcome stream (called from replica worker threads) ---------------
    def _record(self, replica: int, ok: bool, latency_s: float):
        quarantine_as = None
        with self._lock:
            if self._suspended:
                return
            if not ok:
                self._consec[replica] += 1
                if self._consec[replica] >= self.failure_threshold:
                    quarantine_as = "failures"
            else:
                self._consec[replica] = 0
                lat_ms = latency_s * 1e3
                baseline = self._median_ms()
                if baseline is not None and \
                        lat_ms > self.latency_floor_ms and \
                        lat_ms > self.latency_factor * baseline:
                    self._slow[replica] += 1
                    if self._slow[replica] >= self.failure_threshold:
                        quarantine_as = "latency"
                else:
                    self._slow[replica] = 0
                    # only in-family latencies feed the baseline, or a
                    # sustained outage would drag the median up until
                    # the outlier test can never trip again
                    self._lat_window.append(lat_ms)
        if quarantine_as is not None:
            self.quarantine(replica, reason=quarantine_as)

    def _median_ms(self) -> Optional[float]:
        # caller holds the lock; a thin window has no credible baseline
        if len(self._lat_window) < 16:
            return None
        ordered = sorted(self._lat_window)
        return ordered[len(ordered) // 2]

    # -- actions -----------------------------------------------------------
    def quarantine(self, replica: int, reason: str = "manual") -> bool:
        """Pull one replica out of the routing set (idempotent). Returns
        True when this call performed the transition."""
        if not self.model.quarantine_replica(replica):
            return False
        with self._lock:
            self._consec[replica] = 0
            self._slow[replica] = 0
        log.warning("replica %d quarantined (%s); %d healthy remain",
                    replica, reason, self.model.healthy_replicas())
        self.quarantined_total.inc(replica=str(replica), reason=reason)
        return True

    def revive(self, replica: int) -> bool:
        if not self.model.revive_replica(replica):
            return False
        log.info("replica %d revived by canary probe", replica)
        self.revivals_total.inc(replica=str(replica))
        return True

    # -- canary probe loop -------------------------------------------------
    def _probe_loop(self):
        """Async probes, at most ONE outstanding per replica: the loop
        never blocks on a wedged replica (a hung probe would otherwise
        delay every OTHER replica's revival by probe_timeout_s per
        cycle), and a replica that stays wedged accumulates exactly one
        canary job on its queue, not one per cycle."""
        probes: Dict[int, tuple] = {}      # index -> (pending, started)
        while not self._stop.wait(self.probe_interval_s):
            try:
                quarantined = set(self.model.quarantined_replicas())
                for index in list(probes):
                    if index not in quarantined:
                        probes.pop(index)  # revived/retired elsewhere
                for index in quarantined:
                    if self._stop.is_set():
                        return
                    entry = probes.get(index)
                    if entry is not None:
                        pending, _started = entry
                        if not pending._event.is_set():
                            # still in the wedged worker's queue: wait —
                            # re-enqueueing would pile canaries forever.
                            # (If the worker ever drains it, the event
                            # sets and the next cycle reads the verdict.)
                            continue
                        probes.pop(index)
                        try:
                            pending.result()
                        except Exception:  # noqa: BLE001 — the verdict
                            continue       # still sick; re-probe next cycle
                        self.revive(index)
                        continue
                    pending = self.model.probe_replica_async(index)
                    if pending is not None:
                        probes[index] = (pending, time.monotonic())
            except Exception as e:  # noqa: BLE001 — probe loop must
                # survive anything (a raising replica is exactly what
                # it exists to poke at)
                log.debug("canary probe cycle failed: %s", e)

    # -- views -------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "healthy": self.model.healthy_replicas(),
                "quarantined": self.model.quarantined_replicas(),
                "consecutive_failures": dict(self._consec),
                "latency_strikes": dict(self._slow),
                "suspended": self._suspended,
            }
