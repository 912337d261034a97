"""Partitioned request plane: streams, leases, leadership.

Copied from `analytics_zoo_tpu/serving/partitions.py` as it is (L1-532):
the partition map and stream names (L61-110), `_ProgressClock` (L113),
`PartitionLeaseTable` (L139) and `GatewayLeaderLease` (L392).

One broker stream was the request plane's last single bottleneck: every
record funnelled through one append path and one sink commit path, and
every gateway control loop ran in exactly one process. This module holds
the two primitives that shard and replicate it:

- **Partition routing** — `N` streams named ``<stream>.p<i>``, a record
  landing on the partition its uri hashes to (stable CRC32, so any
  client/gateway/engine computes the same route with no coordination).
  ``partitions=1`` keeps the legacy single-stream name byte-for-byte, so
  default configs behave identically. Results from every partition land
  in the ONE ``result:<stream>`` hash — clients poll one place no matter
  how the request fanned out.

- **`PartitionLeaseTable`** — engines own partition *sets* via lease
  rows in the broker hash ``partitions:<stream>``. Liveness is the
  FleetTracker discipline: a lease is held while its row makes
  PROGRESS (content changes under the observer's own monotonic clock),
  never by comparing cross-host timestamps. Expiry generalizes the PR
  10 claim sweep from records to whole partitions: a dead engine's
  partitions are taken over by live peers after ``ttl_s`` of silence,
  and the taken-over partition's unacked records then redeliver through
  the ordinary claim sweep. Membership rows make newcomers visible
  before they own anything, so incumbents shed down to the fair share
  ``ceil(partitions / members)`` and the fleet rebalances without a
  coordinator. Acquisition is write-then-verify: the broker serializes
  HSETs, so whoever's nonce survives the read-back owns the lease —
  brief dual reads during a race are safe because partitions are
  consumer-group streams (co-consumption was already correct).

- **`GatewayLeaderLease`** — the same write-then-verify lease on one
  ``leader`` row in ``gateway:<stream>``, held by whichever gateway
  replica currently runs the fleet control loops (rollout campaign,
  autoscaler). Every replica serves reads (`/predict`, `/healthz`,
  `/rollout` status) from broker-derived state; killing the leader
  just moves the lease after ``ttl_s`` and the new leader re-derives
  the in-flight rollout from the control hash. The per-gateway
  ``gateway_role`` gauge and ``gateway_leader_changes_total`` counter
  make a failover visible on a scrape.

Registry families: ``serving_partitions_owned`` (per-engine gauge),
``serving_partition_lease_changes_total{event,partition}`` (lease
churn), ``gateway_role`` (1 leader / 0 follower),
``gateway_leader_changes_total``.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
import uuid
import zlib
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("analytics_zoo_tpu_torch.serving.partitions")

PARTITIONS_KEY_PREFIX = "partitions:"
GATEWAY_KEY_PREFIX = "gateway:"
MAX_PARTITIONS = 1024


def partitions_key(stream: str) -> str:
    """The broker hash carrying the partition lease table."""
    return PARTITIONS_KEY_PREFIX + stream


def gateway_key(stream: str) -> str:
    """The broker hash carrying the gateway leader lease."""
    return GATEWAY_KEY_PREFIX + stream


def validate_partitions(n) -> int:
    n = int(n)
    if not 1 <= n <= MAX_PARTITIONS:
        raise ValueError(
            f"partitions={n} must be in [1, {MAX_PARTITIONS}]")
    return n


def partition_of(uri: str, partitions: int) -> int:
    """Stable uri -> partition map (CRC32 mod N): every client, gateway
    and engine computes the same route with no shared state. CRC32 is
    deterministic across processes and platforms — `hash()` is salted
    per interpreter and would split one uri across the fleet."""
    if partitions <= 1:
        return 0
    return zlib.crc32(str(uri).encode()) % partitions


def partition_stream(stream: str, index: int, partitions: int) -> str:
    """Partition `index`'s stream name. One partition keeps the legacy
    unsuffixed name so ``partitions=1`` deployments are byte-identical
    with every earlier release (same stream, same PEL, same bench)."""
    if partitions <= 1:
        return stream
    return f"{stream}.p{index}"


def partition_streams(stream: str, partitions: int) -> List[str]:
    return [partition_stream(stream, i, partitions)
            for i in range(max(1, int(partitions)))]


def stream_for(stream: str, uri: str, partitions: int) -> str:
    return partition_stream(stream, partition_of(uri, partitions),
                            partitions)


class _ProgressClock:
    """Content-progress aging, the FleetTracker liveness discipline: a
    row is fresh while its CONTENT keeps changing as observed on THIS
    process's monotonic clock. Cross-host timestamps are never compared
    — a skewed peer that keeps renewing stays alive, a dead one ages
    out no matter what its final timestamp claimed."""

    def __init__(self):
        self._seen: Dict[str, Tuple[str, float]] = {}

    def age(self, field: str, content: Optional[str], now: float) -> float:
        """Seconds since `field`'s content last changed (0.0 on first
        sight or any change). None content forgets the field."""
        if content is None:
            self._seen.pop(field, None)
            return 0.0
        last = self._seen.get(field)
        if last is None or last[0] != content:
            self._seen[field] = (content, now)
            return 0.0
        return now - last[1]

    def forget(self, field: str):
        self._seen.pop(field, None)


class PartitionLeaseTable:
    """One engine's view of (and claim on) the partition lease table.

    The owning engine calls `poll()` from its reader loop (rate-limited
    there, like the claim sweep): each pass renews owned leases,
    refreshes this engine's membership row, takes over expired or
    unclaimed partitions up to the fair share, and sheds surplus ones
    when new members arrive. All broker I/O stays in the caller's
    thread — no thread of its own, nothing to leak on an engine crash
    (the whole point: a crashed engine simply stops renewing).

    Lease row (field ``p<i>``): JSON ``{"owner", "nonce", "ts"}`` — the
    nonce is what write-then-verify compares, ts is a human-debugging
    aid (never compared across hosts). Membership row (field
    ``member:<owner>``): JSON ``{"ts"}`` renewed every poll."""

    def __init__(self, broker, stream: str, partitions: int,
                 owner: str, ttl_s: float = 5.0, registry=None):
        if not owner:
            raise ValueError("partition leases need an owner identity "
                             "(set engine_id)")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s={ttl_s} must be > 0")
        self.broker = broker
        self.stream = stream
        self.partitions = validate_partitions(partitions)
        self.owner = str(owner)
        self.ttl_s = float(ttl_s)
        self.key = partitions_key(stream)
        self._nonce: Dict[int, str] = {}      # partition -> my nonce
        self._clock = _ProgressClock()
        self._lock = threading.Lock()
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._owned_gauge = registry.gauge(
            "serving_partitions_owned",
            "partitions this engine currently holds a lease on")
        self._owned_fn = lambda: float(len(self._nonce))
        self._owned_gauge.set_function(self._owned_fn,
                                       engine=self.owner)
        self._changes = registry.counter(
            "serving_partition_lease_changes_total",
            "partition lease transitions (acquired, takeover, released, "
            "lost) by event and partition")

    # -- meta guard (the resharding gate) ----------------------------------
    def ensure_meta(self, reshard: bool = False) -> int:
        """Record (or verify) the stream's partition count in the lease
        table. A mismatch means records already routed under a
        different count are in flight — joining anyway would strand
        every record whose partition nobody reads. Refused unless the
        operator passes the explicit resharding flag, which rewrites
        the meta row and clears stale leases (the operator owns
        draining or migrating the old partitions)."""
        raw = None
        try:
            raw = self.broker.hget(self.key, "meta")
        except Exception:  # noqa: BLE001 — unreadable meta: write ours
            raw = None
        current = None
        if raw:
            try:
                current = int(json.loads(raw).get("partitions"))
            except (TypeError, ValueError, AttributeError):
                current = None
        if current is not None and current != self.partitions:
            if not reshard:
                raise ValueError(
                    f"stream {self.stream!r} is partitioned "
                    f"{current}-way but this process wants "
                    f"{self.partitions}; changing the partition count "
                    "under a live fleet strands in-flight records — "
                    "drain the fleet or pass the explicit resharding "
                    "flag (--reshard / reshard: true)")
            stale = [f for f in self._all_rows()
                     if f.startswith("p") or f.startswith("member:")]
            if stale:
                self.broker.hdel_many(self.key, stale)
            log.warning("resharding %s: %d -> %d partitions (stale "
                        "leases cleared)", self.stream, current,
                        self.partitions)
        self.broker.hset(self.key, "meta",
                         json.dumps({"partitions": self.partitions,
                                     "by": self.owner,
                                     "ts": time.time()}))
        return self.partitions

    def _all_rows(self) -> Dict[str, str]:
        try:
            return self.broker.hgetall(self.key) or {}
        except Exception:  # noqa: BLE001 — caller treats as empty view
            return {}

    # -- the lease pass ----------------------------------------------------
    def poll(self, now: Optional[float] = None) -> List[int]:
        """One lease pass; returns the partitions owned after it. Safe
        to call at any cadence; the engine paces it at ~ttl/3 so a
        lease survives two missed polls before expiring."""
        now = time.monotonic() if now is None else now
        with self._lock:
            rows = self._all_rows()
            members = self._members(rows, now)
            target = max(1, math.ceil(self.partitions / max(len(members),
                                                            1)))
            # membership heartbeat: content must CHANGE each renewal so
            # peers observe progress (ts is the changing payload)
            try:
                self.broker.hset(self.key, f"member:{self.owner}",
                                 json.dumps({"ts": time.time()}))
            except Exception:  # noqa: BLE001 — renewed next poll
                pass
            claimable: List[int] = []
            for p in range(self.partitions):
                field = f"p{p}"
                raw = rows.get(field)
                lease = self._parse(raw)
                if p in self._nonce:
                    if lease is None or \
                            lease.get("nonce") != self._nonce[p]:
                        # overwritten by a peer (race we lost) or
                        # deleted: the broker's serialized row is the
                        # truth — stop reading this partition
                        self._drop(p, "lost")
                        continue
                    self._renew(p)
                    continue
                age = self._clock.age(field, raw, now)
                if lease is None or age > self.ttl_s:
                    claimable.append(p)
            for p in claimable:
                if len(self._nonce) >= target:
                    break
                self._acquire(p, taken_over=bool(rows.get(f"p{p}")))
            # fair-share shed: newcomers showed up in the member rows —
            # release the highest partitions first so the steady-state
            # assignment is contiguous and deterministic
            while len(self._nonce) > target:
                self._release_one(max(self._nonce))
            self._purge_stale_members(rows, now)
            return sorted(self._nonce)

    def _members(self, rows: Dict[str, str], now: float) -> List[str]:
        alive = {self.owner}
        for field, raw in rows.items():
            if not field.startswith("member:"):
                continue
            if self._clock.age(field, raw, now) <= self.ttl_s:
                alive.add(field[len("member:"):])
        return sorted(alive)

    def _purge_stale_members(self, rows: Dict[str, str], now: float):
        # long-dead member rows (10x ttl, the FleetTracker purge
        # discipline) must not shrink everyone's share forever
        dead = [f for f, raw in rows.items()
                if f.startswith("member:")
                and f != f"member:{self.owner}"
                and self._clock.age(f, raw, now) > 10 * self.ttl_s]
        if dead:
            try:
                self.broker.hdel_many(self.key, dead)
            except Exception:  # noqa: BLE001 — purged next poll
                return
            for f in dead:
                self._clock.forget(f)

    @staticmethod
    def _parse(raw: Optional[str]) -> Optional[Dict]:
        if not raw:
            return None
        try:
            d = json.loads(raw)
            return d if isinstance(d, dict) else None
        except (TypeError, ValueError):
            return None

    def _write(self, p: int, nonce: str):
        self.broker.hset(self.key, f"p{p}", json.dumps(
            {"owner": self.owner, "nonce": nonce, "ts": time.time()}))

    def _acquire(self, p: int, taken_over: bool):
        """Write-then-verify: HSETs serialize at the broker, so the
        nonce that survives the read-back owns the lease. Losing the
        race costs one wasted write, never a wrong owner."""
        nonce = uuid.uuid4().hex
        try:
            self._write(p, nonce)
            back = self._parse(self.broker.hget(self.key, f"p{p}"))
        except Exception:  # noqa: BLE001 — retried next poll
            return
        if back is not None and back.get("nonce") == nonce:
            self._nonce[p] = nonce
            event = "takeover" if taken_over else "acquired"
            self._changes.inc(event=event, partition=str(p))
            log.info("engine %s %s partition %d of %s", self.owner,
                     event, p, self.stream)

    def _renew(self, p: int):
        nonce = uuid.uuid4().hex   # content change IS the heartbeat
        try:
            self._write(p, nonce)
            self._nonce[p] = nonce
        except Exception:  # noqa: BLE001 — a missed renewal is
            pass           # absorbed by the ttl (~3 polls per ttl)

    def _drop(self, p: int, event: str):
        self._nonce.pop(p, None)
        self._changes.inc(event=event, partition=str(p))
        log.warning("engine %s %s partition %d of %s", self.owner,
                    event, p, self.stream)

    def _release_one(self, p: int):
        self._nonce.pop(p, None)
        try:
            self.broker.hdel(self.key, f"p{p}")
        except Exception:  # noqa: BLE001 — peers take it over by ttl
            pass
        self._clock.forget(f"p{p}")
        self._changes.inc(event="released", partition=str(p))

    # -- views / teardown --------------------------------------------------
    def owned(self) -> List[int]:
        with self._lock:
            return sorted(self._nonce)

    def owned_streams(self) -> List[str]:
        return [partition_stream(self.stream, p, self.partitions)
                for p in self.owned()]

    def release(self):
        """Clean shutdown: give every lease and the membership row back
        so peers rebalance immediately instead of waiting out the ttl.
        A SIGKILLed engine never runs this — that is the takeover
        path's job."""
        with self._lock:
            for p in list(self._nonce):
                self._release_one(p)
            try:
                self.broker.hdel(self.key, f"member:{self.owner}")
            except Exception:  # noqa: BLE001 — purged by peers at 10x ttl
                pass
        self._owned_gauge.release_function(self._owned_fn, freeze=True)

    def abandon(self):
        """Crash analogue (chaos tests): forget local state WITHOUT
        touching the broker rows — exactly the table a SIGKILLed engine
        leaves behind. Peers take the partitions over by ttl expiry,
        which is the takeover path under test."""
        with self._lock:
            self._nonce.clear()
        self._owned_gauge.release_function(self._owned_fn, freeze=True)


class GatewayLeaderLease:
    """Replicated-gateway leadership: one ``leader`` row in
    ``gateway:<stream>``, held by write-then-verify with progress-based
    expiry (same discipline as the partition leases). The holder runs
    the fleet control loops; every other replica serves reads and
    watches. `start()` paces the lease on a stop-event-timed daemon
    thread; tests drive `poll(now)` directly."""

    def __init__(self, broker, stream: str, gateway_id: str,
                 ttl_s: float = 3.0, registry=None):
        if not gateway_id:
            raise ValueError("a replicated gateway needs a gateway_id")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s={ttl_s} must be > 0")
        self.broker = broker
        self.stream = stream
        self.gateway_id = str(gateway_id)
        self.ttl_s = float(ttl_s)
        self.key = gateway_key(stream)
        self._nonce: Optional[str] = None
        self._clock = _ProgressClock()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._role_gauge = registry.gauge(
            "gateway_role",
            "this gateway replica's control-plane role "
            "(1 leader, 0 follower)")
        self._role_fn = lambda: 1.0 if self._nonce is not None else 0.0
        self._role_gauge.set_function(self._role_fn,
                                      gateway=self.gateway_id)
        self._changes = registry.counter(
            "gateway_leader_changes_total",
            "leadership transitions observed by this gateway replica "
            "(elected, lost)")

    # -- lease pass --------------------------------------------------------
    def poll(self, now: Optional[float] = None) -> bool:
        """One leadership pass; returns True while this replica leads."""
        now = time.monotonic() if now is None else now
        with self._lock:
            try:
                raw = self.broker.hget(self.key, "leader")
            except Exception:  # noqa: BLE001 — broker blip: keep the
                # current belief; expiry math resumes next poll
                return self._nonce is not None
            row = self._parse(raw)
            if self._nonce is not None:
                if row is None or row.get("nonce") != self._nonce:
                    # a peer overwrote the row (we were partitioned
                    # away past the ttl): demote immediately
                    self._nonce = None
                    self._changes.inc(event="lost")
                    log.warning("gateway %s lost the leader lease",
                                self.gateway_id)
                else:
                    self._write()
                return self._nonce is not None
            age = self._clock.age("leader", raw, now)
            if row is not None and age <= self.ttl_s:
                return False                     # healthy leader exists
            nonce = uuid.uuid4().hex
            try:
                self._write(nonce)
                back = self._parse(self.broker.hget(self.key, "leader"))
            except Exception:  # noqa: BLE001 — retried next poll
                return False
            if back is not None and back.get("nonce") == nonce:
                self._nonce = nonce
                self._changes.inc(event="elected")
                log.info("gateway %s is now the leader for %s",
                         self.gateway_id, self.stream)
            return self._nonce is not None

    def _write(self, nonce: Optional[str] = None):
        nonce = nonce or uuid.uuid4().hex
        self.broker.hset(self.key, "leader", json.dumps(
            {"gateway": self.gateway_id, "nonce": nonce,
             "ts": time.time()}))
        if self._nonce is not None:
            self._nonce = nonce

    @staticmethod
    def _parse(raw: Optional[str]) -> Optional[Dict]:
        if not raw:
            return None
        try:
            d = json.loads(raw)
            return d if isinstance(d, dict) else None
        except (TypeError, ValueError):
            return None

    def is_leader(self) -> bool:
        return self._nonce is not None

    def leader(self) -> Optional[str]:
        """Who holds the lease right now (broker read; None unknown)."""
        try:
            row = self._parse(self.broker.hget(self.key, "leader"))
        except Exception:  # noqa: BLE001 — unknown during a blip
            return None
        return row.get("gateway") if row else None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "GatewayLeaderLease":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop,
                name=f"gateway-leader-{self.gateway_id}", daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        interval = max(0.05, self.ttl_s / 3.0)
        while not self._stop.wait(interval):
            try:
                self.poll()
            except Exception as e:  # noqa: BLE001 — the lease must live
                log.warning("leader lease poll failed (%s: %s)",
                            type(e).__name__, e)

    def stop(self, release: bool = True):
        """`release=False` is the crash analogue (chaos tests): the row
        stays until a peer's ttl expires it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            if release and self._nonce is not None:
                try:
                    self.broker.hdel(self.key, "leader")
                except Exception:  # noqa: BLE001 — peers expire it
                    pass
            if self._nonce is not None:
                self._nonce = None
        self._role_gauge.release_function(self._role_fn, freeze=True)
