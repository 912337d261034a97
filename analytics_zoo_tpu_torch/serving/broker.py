"""Queue brokers — the serving data plane.

Copied from `analytics_zoo_tpu/serving/broker.py` as it is (L1-792):
`encode_ndarray` (L32), `decode_ndarray` (L40), the `Broker` contract
(L46), `MemoryBroker` (L172), `_Handler` (L324), `TCPBrokerServer` (L345),
`TCPBroker` (L368), `RESPError` (L462), `_RESPClient` (L466),
`RedisBroker` (L612), `connect_broker` (L778) and `new_consumer_name`
(L791).

The reference's data plane is a Redis stream with consumer groups
(`FlinkRedisSource.scala:66-87` xgroupCreate/xreadGroup, results HSET back,
`FlinkRedisSink.scala:67`). Same contract here — `xadd` records, `read_group`
batches with at-least-once redelivery via pending-ack, `hset`/`hget` results —
over three interchangeable transports:

- MemoryBroker: in-process (single-host serving, tests).
- TCPBroker(Server): stdlib-socket line protocol so clients in other
  processes/hosts can enqueue (this image has no redis server/client).
- RedisBroker: speaks RESP2 to a real Redis over a stdlib-socket client
  (no redis-py dependency — the image has none); keys/streams named as
  the reference (`serving_stream`, result hashes).
"""

from __future__ import annotations

import base64
import json
import socket
import socketserver
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np


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


# ---------------------------------------------------------------------------
# TCP transport: newline-delimited JSON RPC onto a shared MemoryBroker
# ---------------------------------------------------------------------------
class _Handler(socketserver.StreamRequestHandler):
    # see _RESPHandler in redis_server.py: Nagle + delayed ACK stalls
    # small back-to-back reply writes ~40 ms each on pipelined batches
    disable_nagle_algorithm = True

    def handle(self):
        while True:
            line = self.rfile.readline()
            if not line:
                return
            try:
                req = json.loads(line)
                fn = getattr(self.server.broker, req["op"])
                result = fn(*req.get("args", []))
                resp = {"ok": True, "result": result}
            except Exception as e:  # noqa: BLE001 — serve must not die
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class TCPBrokerServer:
    """Serve a MemoryBroker over TCP (the image has no Redis server)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 broker: Optional[MemoryBroker] = None):
        self.broker = broker or MemoryBroker()
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.broker = self.broker
        self.host, self.port = self._srv.server_address
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    def start(self) -> "TCPBrokerServer":
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


class TCPBroker(Broker):
    """Client for TCPBrokerServer; one socket per thread."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379):
        self.host, self.port = host, port
        self._local = threading.local()

    def _conn(self):
        if getattr(self._local, "sock", None) is None:
            sock = socket.create_connection((self.host, self.port), timeout=30)
            # the client half of the Nagle/delayed-ACK fix (see _Handler)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
            self._local.rfile = sock.makefile("rb")
        return self._local.sock, self._local.rfile

    def _call(self, op: str, *args):
        try:
            sock, rfile = self._conn()
            sock.sendall((json.dumps({"op": op, "args": list(args)}) + "\n")
                         .encode())
            resp = json.loads(rfile.readline())
        except Exception:
            # drop the (possibly dead) cached socket so the next call on
            # this thread reconnects instead of reusing a poisoned one
            sock = getattr(self._local, "sock", None)
            if sock is not None:
                try:
                    sock.close()
                finally:
                    self._local.sock = None
            raise
        if not resp.get("ok"):
            raise RuntimeError(f"broker error: {resp.get('error')}")
        result = resp["result"]
        if op in ("read_group", "claim_stale") and result is not None:
            result = [tuple(item) for item in result]
        return result

    def xadd(self, stream, record):
        return self._call("xadd", stream, record)

    def xadd_many(self, entries):
        # one RPC round trip for the whole burst
        return self._call("xadd_many",
                          [[stream, record] for stream, record in entries])

    def read_group(self, stream, group, consumer, count, block_ms=100):
        return self._call("read_group", stream, group, consumer, count,
                          block_ms)

    def ack(self, stream, group, ids):
        return self._call("ack", stream, group, ids)

    def claim_stale(self, stream, group, consumer, min_idle_ms, count):
        return self._call("claim_stale", stream, group, consumer,
                          min_idle_ms, count)

    def pending_count(self, stream, group):
        return self._call("pending_count", stream, group)

    def stream_depth(self, stream):
        return self._call("stream_depth", stream)

    def hset(self, key, field, value):
        return self._call("hset", key, field, value)

    def hset_many(self, key, mapping):
        # one RPC round trip for the whole batch
        return self._call("hset_many", key, mapping)

    def writeback(self, key, mapping, stream, group, ids):
        # fused write + ack: one RPC instead of two
        return self._call("writeback", key, mapping, stream, group, ids)

    def hget(self, key, field):
        return self._call("hget", key, field)

    def hmget(self, key, fields):
        return self._call("hmget", key, list(fields))

    def hgetall(self, key):
        return self._call("hgetall", key)

    def hlen(self, key):
        return self._call("hlen", key)

    def hdel(self, key, field):
        return self._call("hdel", key, field)

    def hdel_many(self, key, fields):
        return self._call("hdel_many", key, list(fields))


class RESPError(RuntimeError):
    """A Redis `-ERR ...` reply."""


class _RESPClient:
    """Minimal RESP2 client over a stdlib socket: sends command arrays,
    parses simple strings / errors / integers / bulk strings / arrays
    (everything the stream + hash commands return). Thread-safe via one
    lock per connection, matching the reference's one-Jedis-per-operator
    usage."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self._host, self._port = host, port
        self._timeout_s = timeout_s
        self._sock = None
        self._buf = None
        self._lock = threading.Lock()
        self._connect()

    def _connect(self):
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout_s)
        # a pipelined request body can span segments; Nagle would hold
        # the tail waiting on the server's delayed ACK (~40 ms) — the
        # server side sets disable_nagle_algorithm for its replies
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = self._sock.makefile("rb")

    def _close_locked(self):
        """Close without taking the lock — only from inside command()."""
        try:
            if self._buf is not None:
                self._buf.close()
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = self._buf = None

    def close(self):
        # taking the lock serializes against an in-flight command; nulling
        # _sock mid-command would raise AttributeError in the other thread
        with self._lock:
            self._close_locked()

    def command(self, *args, timeout_s: Optional[float] = None):
        """Encode `args` as a RESP array of bulk strings; return the
        decoded reply (str for simple/bulk, int, list, or None).
        `timeout_s` overrides the connection default for this command
        (None keeps the default; pass float('inf')-like large values for
        BLOCK 0). A timed-out command closes the connection — the late
        reply would otherwise desynchronize every later command."""
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            data = a if isinstance(a, bytes) else str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(data), data))
        with self._lock:
            if self._sock is None:
                # a previous timeout/failure closed the connection —
                # reconnect so one transient Redis stall doesn't
                # permanently kill a long-running serving loop
                self._connect()
            if timeout_s is not None:
                self._sock.settimeout(timeout_s)
            try:
                self._sock.sendall(b"".join(out))
                return self._read_reply()
            except socket.timeout:
                self._close_locked()
                raise ConnectionError(
                    "redis command timed out; connection closed to avoid "
                    "reply desynchronization (next command reconnects)")
            except (ConnectionError, OSError):
                self._close_locked()
                raise
            finally:
                if timeout_s is not None and self._sock is not None:
                    try:
                        self._sock.settimeout(self._timeout_s)
                    except OSError:
                        pass

    def pipeline(self, *cmds):
        """Send several commands in ONE write and read all replies —
        RESP pipelining. One network round trip (and, against a loaded
        server host, one scheduling wakeup) instead of len(cmds). Every
        reply is read even when an earlier one is an error, keeping the
        connection synchronized; the first error then raises."""
        out = []
        for args in cmds:
            out.append(b"*%d\r\n" % len(args))
            for a in args:
                data = a if isinstance(a, bytes) else str(a).encode()
                out.append(b"$%d\r\n%s\r\n" % (len(data), data))
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                self._sock.sendall(b"".join(out))
                replies, err = [], None
                for _ in cmds:
                    try:
                        replies.append(self._read_reply())
                    except RESPError as e:
                        replies.append(e)
                        err = err or e
                if err is not None:
                    raise err
                return replies
            except socket.timeout:
                self._close_locked()
                raise ConnectionError(
                    "redis pipeline timed out; connection closed to "
                    "avoid reply desynchronization (next command "
                    "reconnects)")
            except (ConnectionError, OSError):
                self._close_locked()
                raise

    def _read_line(self) -> bytes:
        line = self._buf.readline()
        if not line.endswith(b"\r\n"):
            raise ConnectionError("redis connection closed mid-reply")
        return line[:-2]

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RESPError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self._buf.read(n + 2)
            if len(data) < n + 2:
                raise ConnectionError("redis connection closed mid-bulk")
            return data[:-2].decode()
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise ValueError(f"Unsupported RESP type byte {kind!r}")


class RedisBroker(Broker):
    """Real Redis backend, reference-faithful command set
    (`FlinkRedisSource.scala:66-87`): XGROUP CREATE ... MKSTREAM, blocking
    XREADGROUP with `>`, XACK+XDEL on ack, HSET/HGET results."""

    def __init__(self, host: str = "localhost", port: int = 6379):
        self.host, self.port = host, port
        self._r = _RESPClient(host, port)
        self._groups_made = set()

    def clone(self):
        # fresh socket: a blocking XREADGROUP on this connection must not
        # serialize the clone's HSET/XACK behind its block window
        return RedisBroker(self.host, self.port)

    def close(self):
        self._r.close()

    def xadd(self, stream, record):
        return self._r.command("XADD", stream, "*", "json",
                               json.dumps(record))

    def xadd_many(self, entries):
        # ONE pipelined round trip appends the whole burst — the ingest
        # analogue of the sink's fused writeback. Entries may span
        # partition streams; Redis executes the XADDs in order, so the
        # returned ids are position-matched to the input
        entries = list(entries)
        if not entries:
            return []
        replies = self._r.pipeline(
            *(("XADD", stream, "*", "json", json.dumps(record))
              for stream, record in entries))
        return list(replies)

    def _ensure_group(self, stream, group):
        if (stream, group) in self._groups_made:
            return
        try:
            self._r.command("XGROUP", "CREATE", stream, group, "0",
                            "MKSTREAM")
        except RESPError as e:
            if "BUSYGROUP" not in str(e):
                raise
        self._groups_made.add((stream, group))

    def read_group(self, stream, group, consumer, count, block_ms=100):
        self._ensure_group(stream, group)
        if block_ms <= 0:
            # block_ms<=0 means NON-blocking here (the decode loop
            # polls between steps with live sequences seated) — omit
            # BLOCK entirely: passing "BLOCK 0" upstream means block
            # FOREVER and would wedge a live engine loop behind an
            # empty stream
            resp = self._r.command(
                "XREADGROUP", "GROUP", group, consumer, "COUNT", count,
                "STREAMS", stream, ">")
        else:
            # socket deadline must outlast the server-side BLOCK window
            resp = self._r.command(
                "XREADGROUP", "GROUP", group, consumer, "COUNT", count,
                "BLOCK", block_ms, "STREAMS", stream, ">",
                timeout_s=block_ms / 1000.0 + 10.0)
        out = []
        for _, entries in resp or []:
            for rid, fields in entries:
                kv = dict(zip(fields[::2], fields[1::2]))
                out.append((rid, json.loads(kv["json"])))
        return out

    def ack(self, stream, group, ids):
        if ids:
            self._r.command("XACK", stream, group, *ids)
            self._r.command("XDEL", stream, *ids)

    def claim_stale(self, stream, group, consumer, min_idle_ms, count):
        """XAUTOCLAIM (Redis >= 6.2): atomically scan the group's PEL
        and claim entries idle past `min_idle_ms` for this consumer.
        Reply is [next-cursor, entries] (7.0 appends a deleted-ids
        array; ignored). Entries whose record was trimmed come back
        nil and are skipped."""
        self._ensure_group(stream, group)
        resp = self._r.command(
            "XAUTOCLAIM", stream, group, consumer, int(min_idle_ms),
            "0-0", "COUNT", count)
        entries = resp[1] if isinstance(resp, list) and len(resp) > 1 \
            else []
        out = []
        for item in entries or []:
            if not item:
                continue
            rid, fields = item
            kv = dict(zip(fields[::2], fields[1::2]))
            if "json" in kv:
                out.append((rid, json.loads(kv["json"])))
        return out

    def pending_count(self, stream, group):
        self._ensure_group(stream, group)
        # XPENDING summary form: [count, min-id, max-id, consumers]
        resp = self._r.command("XPENDING", stream, group)
        return int(resp[0]) if isinstance(resp, list) and resp else 0

    def stream_depth(self, stream):
        return int(self._r.command("XLEN", stream) or 0)

    def hset(self, key, field, value):
        return self._r.command("HSET", key, field, value)

    def hset_many(self, key, mapping):
        if not mapping:
            return 0
        # variadic HSET (Redis >= 4): one command, one round trip;
        # the integer reply counts NEW fields (overwrites excluded)
        flat = []
        for field, value in mapping.items():
            flat.extend((field, value))
        return self._r.command("HSET", key, *flat)

    def writeback(self, key, mapping, stream, group, ids):
        # ONE pipelined round trip commits the whole batch: HSET the
        # results, XACK + XDEL the stream entries. The sink's commit
        # latency drops from 3 RTTs to 1 — on a busy host each RTT also
        # costs a server-thread scheduling wakeup, which is what caps a
        # fleet's per-engine sink throughput
        cmds = []
        if mapping:
            flat = []
            for field, value in mapping.items():
                flat.extend((field, value))
            cmds.append(("HSET", key, *flat))
        if ids:
            self._ensure_group(stream, group)
            cmds.append(("XACK", stream, group, *ids))
            cmds.append(("XDEL", stream, *ids))
        if not cmds:
            return 0
        replies = self._r.pipeline(*cmds)
        return int(replies[0]) if mapping else 0

    def hget(self, key, field):
        return self._r.command("HGET", key, field)

    def hmget(self, key, fields):
        fields = list(fields)
        if not fields:
            return []
        return list(self._r.command("HMGET", key, *fields) or
                    [None] * len(fields))

    def hgetall(self, key):
        flat = self._r.command("HGETALL", key) or []
        return dict(zip(flat[::2], flat[1::2]))

    def hlen(self, key):
        return int(self._r.command("HLEN", key) or 0)

    def hdel(self, key, field):
        self._r.command("HDEL", key, field)

    def hdel_many(self, key, fields):
        fields = list(fields)
        if fields:
            self._r.command("HDEL", key, *fields)


def connect_broker(url: Optional[str] = None) -> Broker:
    """"memory", "tcp://host:port", or "redis://host:port"; default memory."""
    if url in (None, "", "memory"):
        return MemoryBroker()
    if url.startswith("tcp://"):
        host, _, port = url[6:].partition(":")
        return TCPBroker(host or "127.0.0.1", int(port or 6379))
    if url.startswith("redis://"):
        host, _, port = url[8:].partition(":")
        return RedisBroker(host or "localhost", int(port or 6379))
    raise ValueError(f"Unsupported broker url: {url}")


def new_consumer_name() -> str:
    return f"consumer-{uuid.uuid4().hex[:8]}"
