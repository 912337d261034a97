"""Queue brokers — the serving data plane, in-process transport.

Copied from `analytics_zoo_tpu/serving/broker.py`: `encode_ndarray` (L32),
`decode_ndarray` (L40), the `Broker` contract (L46), `MemoryBroker`
(L172), `RESPError` (L462), `connect_broker` (L778) and
`new_consumer_name` (L791). The reference's data plane is a Redis stream
with consumer groups (`xadd` records, `read_group` batches with
at-least-once redelivery via pending-ack, `hset`/`hget` results).

Only the in-process `MemoryBroker` is ported: the TCP and Redis transports
(`TCPBroker`, `TCPBrokerServer`, `RedisBroker`) wait for the serving plane
(ROADMAP.md queue 1, item 4), and `connect_broker` of a ``tcp://`` or
``redis://`` url raises NotImplementedError saying so.
"""

from __future__ import annotations

import base64
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

SERVING_PLANE_NOT_PORTED = (
    "the TCP and Redis broker transports are not ported yet (ROADMAP.md "
    "queue 1, item 4: serving plane); use 'memory' or a MemoryBroker")

def encode_ndarray(arr: np.ndarray) -> Dict:
    """b64 ndarray encoding, the client protocol of `serving/client.py:114`
    (reference uses b64 of arrow/raw bytes; raw bytes here)."""
    arr = np.ascontiguousarray(arr)
    return {"b64": base64.b64encode(arr.tobytes()).decode("ascii"),
            "dtype": str(arr.dtype), "shape": list(arr.shape)}


def decode_ndarray(blob: Dict) -> np.ndarray:
    data = base64.b64decode(blob["b64"])
    return np.frombuffer(data, dtype=np.dtype(blob["dtype"])).reshape(
        blob["shape"]).copy()


class Broker:
    """Stream + result-hash contract."""

    def clone(self) -> "Broker":
        """A connection suitable for a SECOND serving thread. Pipelined
        serving reads (blocking XREADGROUP) and writes results from
        different stages concurrently; on a single-socket transport the
        reader would hold the connection lock for its whole block window
        and starve the sink. Default: share (in-process brokers take the
        lock per-op; TCPBroker sockets are per-thread already)."""
        return self

    def xadd(self, stream: str, record: Dict) -> str:
        raise NotImplementedError

    def xadd_many(self, entries: List[Tuple[str, Dict]]) -> List[str]:
        """Batched enqueue — the ingest analogue of the sink's fused
        `writeback`: append a whole burst of (stream, record) pairs in
        ONE broker interaction (a pipelined multi-XADD on Redis, one
        lock acquisition on MemoryBroker, one RPC on TCPBroker) and
        return the record ids in order. Entries may target DIFFERENT
        streams — a hash-partitioned burst fans out across partition
        streams inside the same round trip, so the frontend→broker hop
        costs one RTT per coalesced flush instead of one per record.
        Default loops `xadd` for brokers without a cheaper path."""
        return [self.xadd(stream, record) for stream, record in entries]

    def read_group(self, stream: str, group: str, consumer: str,
                   count: int, block_ms: int = 100
                   ) -> List[Tuple[str, Dict]]:
        raise NotImplementedError

    def ack(self, stream: str, group: str, ids: List[str]) -> None:
        raise NotImplementedError

    def claim_stale(self, stream: str, group: str, consumer: str,
                    min_idle_ms: int, count: int
                    ) -> List[Tuple[str, Dict]]:
        """Claim pending (delivered-but-unacked) entries that have sat
        idle for at least `min_idle_ms` — a dead consumer's in-flight
        work — and hand them to `consumer` (XAUTOCLAIM on Redis). The
        fleet's claim sweep: a killed engine's batches redeliver to a
        live peer instead of rotting in the pending list. Claimed
        entries restart their idle clock, so concurrent sweepers from
        several engines split the backlog rather than all claiming the
        same records."""
        raise NotImplementedError

    def pending_count(self, stream: str, group: str) -> int:
        """Entries delivered to the group but not yet acked (XPENDING
        summary count) — what a crashed consumer may still owe."""
        raise NotImplementedError

    def stream_depth(self, stream: str) -> int:
        """Entries still in the stream (XLEN). The sink XDELs on ack, so
        this is the live backlog: records enqueued but not yet committed
        (undelivered + in-flight). The elastic layer's one load signal —
        the admission controller's 429 threshold, the adaptive batcher's
        light/heavy-load switch, and the autoscaler's scale trigger all
        read it."""
        raise NotImplementedError

    def hset(self, key: str, field: str, value: str) -> int:
        """Returns the number of NEW fields created (0 when `field`
        already existed — Redis HSET semantics). The sink uses this to
        keep redelivered records from double-counting as served."""
        raise NotImplementedError

    def hset_many(self, key: str, mapping: Dict[str, str]) -> int:
        """Batched result writeback: ONE round trip for a whole batch of
        (field, value) pairs (`HSET key f1 v1 f2 v2 ...` on Redis) instead
        of one per record — the pipelined sink stage's write path.
        Returns the number of NEW fields created (overwrites of an
        already-written result — a redelivered record — don't count).
        Default loops hset for brokers without a cheaper path."""
        added = 0
        for field, value in mapping.items():
            added += self.hset(key, field, value) or 0
        return added

    def writeback(self, key: str, mapping: Dict[str, str], stream: str,
                  group: str, ids: List[str]) -> int:
        """The sink's whole batch commit — result HSET + XACK/XDEL — as
        ONE broker interaction (RESP-pipelined on Redis, a single lock
        acquisition on MemoryBroker, one RPC on TCPBroker). The sink
        pays one round-trip latency per batch instead of three; under a
        loaded host (or a real network) those round trips are what cap
        sink throughput. Returns the number of NEW result fields, like
        `hset_many` (the idempotent-writeback dedup). Default chains
        the two calls for brokers without a fused path."""
        added = self.hset_many(key, mapping)
        self.ack(stream, group, ids)
        return added

    def hget(self, key: str, field: str) -> Optional[str]:
        raise NotImplementedError

    def hmget(self, key: str, fields: List[str]) -> List[Optional[str]]:
        """Batched field read (HMGET): one round trip answers a whole
        poll's worth of result lookups — the client's fused
        enqueue+poll path reads every outstanding uri per sweep with
        one command instead of one HGET each. Missing fields come back
        as None, position-matched to `fields`. Default loops `hget`
        for brokers without a cheaper path."""
        return [self.hget(key, field) for field in fields]

    def hgetall(self, key: str) -> Dict[str, str]:
        raise NotImplementedError

    def hlen(self, key: str) -> int:
        """Field count (HLEN) — how result-drain progress is polled
        without serializing the whole hash over the wire each check.
        Default falls back to hgetall for brokers without a cheap path."""
        return len(self.hgetall(key))

    def hdel(self, key: str, field: str) -> None:
        raise NotImplementedError

    def hdel_many(self, key: str, fields) -> None:
        """Batched delete (variadic HDEL): result-drain loops
        (`OutputQueue.dequeue`) clear a whole poll's worth of fields in
        one round trip."""
        for field in fields:
            self.hdel(key, field)


class MemoryBroker(Broker):
    def __init__(self, redeliver_after_s: float = 30.0):
        self._lock = threading.Condition()
        self._streams: Dict[str, OrderedDict] = {}
        # pending entry ledger (the PEL): rid -> (consumer, delivered_at)
        # per (stream, group) — the consumer attribution is what lets a
        # claim sweep take over a DEAD peer's entries specifically
        self._pending: Dict[Tuple[str, str],
                            Dict[str, Tuple[str, float]]] = {}
        self._hashes: Dict[str, Dict[str, str]] = {}
        self._seq = 0
        self.redeliver_after_s = redeliver_after_s

    def xadd(self, stream, record):
        with self._lock:
            self._seq += 1
            rid = f"{int(time.time() * 1000)}-{self._seq}"
            self._streams.setdefault(stream, OrderedDict())[rid] = record
            self._lock.notify_all()
            return rid

    def xadd_many(self, entries):
        with self._lock:  # one lock acquisition for the whole burst
            rids = []
            for stream, record in entries:
                self._seq += 1
                rid = f"{int(time.time() * 1000)}-{self._seq}"
                self._streams.setdefault(stream, OrderedDict())[rid] = \
                    record
                rids.append(rid)
            if rids:
                self._lock.notify_all()
            return rids

    def read_group(self, stream, group, consumer, count, block_ms=100):
        deadline = time.time() + block_ms / 1000.0
        with self._lock:
            while True:
                out = []
                s = self._streams.get(stream, OrderedDict())
                pend = self._pending.setdefault((stream, group), {})
                now = time.time()
                for rid, rec in s.items():
                    if len(out) >= count:
                        break
                    taken = pend.get(rid)
                    # undelivered, or delivered-but-unacked past the
                    # redelivery window (consumer died: at-least-once)
                    if taken is None \
                            or now - taken[1] > self.redeliver_after_s:
                        pend[rid] = (consumer, now)
                        out.append((rid, rec))
                if out or time.time() >= deadline:
                    return out
                self._lock.wait(timeout=max(deadline - time.time(), 0.001))

    def ack(self, stream, group, ids):
        with self._lock:
            s = self._streams.get(stream, OrderedDict())
            pend = self._pending.get((stream, group), {})
            for rid in ids:
                s.pop(rid, None)
                pend.pop(rid, None)

    def writeback(self, key, mapping, stream, group, ids):
        with self._lock:   # one acquisition for write + ack
            h = self._hashes.setdefault(key, {})
            added = sum(1 for f in mapping if f not in h)
            h.update(mapping)
            s = self._streams.get(stream, OrderedDict())
            pend = self._pending.get((stream, group), {})
            for rid in ids:
                s.pop(rid, None)
                pend.pop(rid, None)
            self._lock.notify_all()
            return added

    def claim_stale(self, stream, group, consumer, min_idle_ms, count):
        with self._lock:
            s = self._streams.get(stream, OrderedDict())
            pend = self._pending.setdefault((stream, group), {})
            now = time.time()
            out = []
            for rid, (_owner, delivered) in list(pend.items()):
                if len(out) >= count:
                    break
                if (now - delivered) * 1000.0 < min_idle_ms:
                    continue
                rec = s.get(rid)
                if rec is None:
                    # acked-and-trimmed elsewhere: drop the stale PEL row
                    pend.pop(rid, None)
                    continue
                pend[rid] = (consumer, now)   # idle clock restarts
                out.append((rid, rec))
            return out

    def pending_count(self, stream, group):
        with self._lock:
            return len(self._pending.get((stream, group), {}))

    def stream_depth(self, stream):
        with self._lock:
            return len(self._streams.get(stream, ()))

    def hset(self, key, field, value):
        with self._lock:
            h = self._hashes.setdefault(key, {})
            added = 0 if field in h else 1
            h[field] = value
            self._lock.notify_all()
            return added

    def hset_many(self, key, mapping):
        with self._lock:  # one lock acquisition for the whole batch
            h = self._hashes.setdefault(key, {})
            added = sum(1 for f in mapping if f not in h)
            h.update(mapping)
            self._lock.notify_all()
            return added

    def hget(self, key, field):
        with self._lock:
            return self._hashes.get(key, {}).get(field)

    def hmget(self, key, fields):
        with self._lock:
            h = self._hashes.get(key, {})
            return [h.get(field) for field in fields]

    def hgetall(self, key):
        with self._lock:
            return dict(self._hashes.get(key, {}))

    def hlen(self, key):
        with self._lock:
            return len(self._hashes.get(key, {}))

    def hdel(self, key, field):
        with self._lock:
            self._hashes.get(key, {}).pop(field, None)

    def hdel_many(self, key, fields):
        with self._lock:
            h = self._hashes.get(key, {})
            for field in fields:
                h.pop(field, None)


class RESPError(RuntimeError):
    """A Redis `-ERR ...` reply (kept for `ResilientBroker`, which counts
    it as a working transport)."""


def connect_broker(url: Optional[str] = None) -> Broker:
    """"memory" (the default); "tcp://host:port" and "redis://host:port"
    raise NotImplementedError until the serving plane is ported."""
    if url in (None, "", "memory"):
        return MemoryBroker()
    if url.startswith(("tcp://", "redis://")):
        raise NotImplementedError(SERVING_PLANE_NOT_PORTED)
    raise ValueError(f"Unsupported broker url: {url}")


def new_consumer_name() -> str:
    return f"consumer-{uuid.uuid4().hex[:8]}"
