"""Self-contained RESP2 stream/hash server ("mini redis").

Copied from `analytics_zoo_tpu/serving/redis_server.py` as it is (L1-381):
the command table of `MiniRedisStore` (L39-254), `_RESPHandler` (L256),
`_encode_reply` (L310) and `MiniRedisServer` (L328, with bind to port 0
and restart on the same port, L336-362).

The serving data plane is reference-faithful Redis streams
(`FlinkRedisSource.scala:66-87`), but the deploy image carries no redis
binary — so the framework ships its own small RESP2 server implementing
exactly the command subset the stack uses: XADD / XGROUP CREATE
(MKSTREAM) / XREADGROUP (COUNT, BLOCK, ">") / XACK / XDEL and
HSET/HGET/HGETALL/HDEL. `RedisBroker` (`serving/broker.py`) talks to it
over the real wire protocol, so serving latency can be measured across a
genuine socket hop, and a production Redis can be swapped in with no code
change (same commands, same framing).

Blocking XREADGROUP is implemented with a condition variable: a BLOCK
window parks the reader until XADD signals, instead of busy-polling."""

from __future__ import annotations

import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.serving.broker import RESPError


class Simple(str):
    """Marker for RESP simple-string replies (+OK). Only command handlers
    construct it — a hash VALUE that happens to equal "OK" stays a plain
    str and is encoded as a bulk string, the type real Redis sends."""


# Marker for the *-1 nil-ARRAY reply (timed-out XREADGROUP). A bare None
# encodes as $-1 nil BULK — what real Redis sends for a missing HGET
# (divergence caught by tests/test_resp2_conformance.py).
NIL_ARRAY = object()


class MiniRedisStore:
    """In-memory streams + hashes with consumer-group semantics: per-group
    last-delivered cursor and pending-entries list (PEL). The PEL keeps
    per-entry consumer attribution and delivery time — what XAUTOCLAIM
    (the fleet's stale-pending claim sweep) and XPENDING read."""

    def __init__(self):
        self.streams: Dict[str, List[Tuple[str, List[str]]]] = {}
        self.groups: Dict[Tuple[str, str], Dict] = {}
        self.hashes: Dict[str, Dict[str, str]] = {}
        self.seq = 0
        self.lock = threading.Lock()
        self.data_ready = threading.Condition(self.lock)

    # -- command dispatch --------------------------------------------------
    def execute(self, args: List[str]):
        cmd = args[0].upper()
        handler = getattr(self, "cmd_" + cmd.lower(), None)
        if handler is None:
            raise RESPError(f"ERR unknown command '{cmd}'")
        if cmd == "XREADGROUP":
            # manages its own locking (may park on the condition)
            return handler(args[1:])
        with self.lock:
            return handler(args[1:])

    def cmd_xadd(self, a):
        stream, rid = a[0], a[1]
        if rid != "*":
            raise RESPError("ERR only auto-generated ids are supported")
        self.seq += 1
        rid = f"{self.seq}-0"
        self.streams.setdefault(stream, []).append((rid, list(a[2:])))
        self.data_ready.notify_all()
        return rid

    def cmd_xgroup(self, a):
        if a[0].upper() != "CREATE":
            raise RESPError("ERR only XGROUP CREATE is supported")
        stream, group = a[1], a[2]
        mkstream = any(str(x).upper() == "MKSTREAM" for x in a[4:])
        if stream not in self.streams:
            if not mkstream:
                raise RESPError("ERR The XGROUP subcommand requires the "
                                "key to exist")
            self.streams[stream] = []
        if (stream, group) in self.groups:
            raise RESPError("BUSYGROUP Consumer Group name already exists")
        # pel: rid -> [consumer, delivered_at_monotonic]
        self.groups[(stream, group)] = {"cursor": 0, "pel": {}}
        return Simple("OK")

    def _pop_new(self, stream: str, group: str, consumer: str,
                 count: int):
        g = self.groups.get((stream, group))
        if g is None:
            raise RESPError("NOGROUP No such consumer group")
        entries = self.streams.get(stream, [])
        new = entries[g["cursor"]:g["cursor"] + count]
        g["cursor"] += len(new)
        now = time.monotonic()
        for rid, _ in new:
            g["pel"][rid] = [consumer, now]
        return new

    def cmd_xreadgroup(self, a):
        if a[0].upper() != "GROUP":
            raise RESPError("ERR XREADGROUP must start with GROUP")
        group, consumer = a[1], a[2]
        opts = [str(x).upper() for x in a[3:]]
        count = int(a[3 + opts.index("COUNT") + 1]) \
            if "COUNT" in opts else 10
        block_ms: Optional[int] = None
        if "BLOCK" in opts:
            block_ms = int(a[3 + opts.index("BLOCK") + 1])
        si = opts.index("STREAMS")
        stream, cursor_id = a[3 + si + 1], a[3 + si + 2]
        if cursor_id != ">":
            raise RESPError("ERR only the new-messages cursor '>' is "
                            "supported")
        deadline = None if block_ms is None else (
            None if block_ms == 0 else time.monotonic() + block_ms / 1e3)
        with self.lock:
            while True:
                new = self._pop_new(stream, group, consumer, count)
                if new:
                    return [[stream,
                             [[rid, fields] for rid, fields in new]]]
                if block_ms is None:
                    return NIL_ARRAY
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return NIL_ARRAY
                if not self.data_ready.wait(remaining):
                    return NIL_ARRAY

    def cmd_xack(self, a):
        stream, group, ids = a[0], a[1], a[2:]
        g = self.groups.get((stream, group))
        n = 0
        for rid in ids:
            if g and g["pel"].pop(rid, None) is not None:
                n += 1
        return n

    def cmd_xautoclaim(self, a):
        """XAUTOCLAIM stream group consumer min-idle-time start [COUNT n]:
        claim PEL entries idle >= min-idle-time for `consumer`, restarting
        their idle clock. Reply is the Redis 6.2 shape: [next-cursor,
        [[rid, fields], ...]] — 7.0's third (deleted-ids) element is
        omitted; the broker client ignores it either way. PEL rows whose
        record was XDEL'd are dropped, as real Redis does."""
        if len(a) < 5:
            raise RESPError(
                "ERR wrong number of arguments for 'xautoclaim' command")
        stream, group, consumer = a[0], a[1], a[2]
        min_idle_ms = int(a[3])
        opts = [str(x).upper() for x in a[5:]]
        count = int(a[5 + opts.index("COUNT") + 1]) \
            if "COUNT" in opts else 100
        g = self.groups.get((stream, group))
        if g is None:
            raise RESPError("NOGROUP No such consumer group")
        by_id = dict(self.streams.get(stream, []))
        now = time.monotonic()
        claimed = []
        for rid, owner in list(g["pel"].items()):
            if len(claimed) >= count:
                break
            if (now - owner[1]) * 1000.0 < min_idle_ms:
                continue
            fields = by_id.get(rid)
            if fields is None:
                g["pel"].pop(rid, None)
                continue
            g["pel"][rid] = [consumer, now]
            claimed.append([rid, list(fields)])
        return ["0-0", claimed]

    def cmd_xpending(self, a):
        """Summary form only: [count, min-id, max-id,
        [[consumer, count-str], ...]]."""
        stream, group = a[0], a[1]
        g = self.groups.get((stream, group))
        if g is None:
            raise RESPError("NOGROUP No such consumer group")
        pel = g["pel"]
        if not pel:
            return [0, None, None, NIL_ARRAY]
        ids = sorted(pel, key=lambda r: tuple(map(int, r.split("-"))))
        per_consumer: Dict[str, int] = {}
        for owner, _ts in pel.values():
            per_consumer[owner] = per_consumer.get(owner, 0) + 1
        return [len(pel), ids[0], ids[-1],
                [[c, str(n)] for c, n in sorted(per_consumer.items())]]

    def cmd_xdel(self, a):
        stream, ids = a[0], set(a[1:])
        entries = self.streams.get(stream, [])
        removed = sum(1 for r, _ in entries if r in ids)
        # group cursors are list positions: removing delivered entries in
        # front of a cursor must pull the cursor back with them
        for (s, _), g in self.groups.items():
            if s == stream:
                g["cursor"] -= sum(1 for r, _ in entries[:g["cursor"]]
                                   if r in ids)
        self.streams[stream] = [(r, f) for r, f in entries if r not in ids]
        return removed

    def cmd_xlen(self, a):
        return len(self.streams.get(a[0], ()))

    def cmd_hset(self, a):
        # variadic since Redis 4: HSET key f1 v1 [f2 v2 ...]
        if len(a) < 3 or len(a) % 2 == 0:
            raise RESPError("ERR wrong number of arguments for 'hset' "
                            "command")
        h = self.hashes.setdefault(a[0], {})
        added = 0
        for f, v in zip(a[1::2], a[2::2]):
            if f not in h:
                added += 1
            h[f] = v
        # real Redis replies with the number of NEW fields added
        return added

    def cmd_hget(self, a):
        return self.hashes.get(a[0], {}).get(a[1])

    def cmd_hmget(self, a):
        # HMGET key f1 [f2 ...]: one array reply, nil per missing field
        if len(a) < 2:
            raise RESPError("ERR wrong number of arguments for 'hmget' "
                            "command")
        h = self.hashes.get(a[0], {})
        return [h.get(f) for f in a[1:]]

    def cmd_hgetall(self, a):
        out: List[str] = []
        for k, v in self.hashes.get(a[0], {}).items():
            out.extend([k, v])
        return out

    def cmd_hlen(self, a):
        return len(self.hashes.get(a[0], {}))

    def cmd_hdel(self, a):
        # variadic like real Redis: HDEL key f1 [f2 ...]
        h = self.hashes.get(a[0], {})
        return sum(1 for f in a[1:] if h.pop(f, None) is not None)

    def cmd_ping(self, a):
        # bare PING -> +PONG simple string; PING msg echoes a bulk string
        return Simple("PONG") if not a else a[0]


class _RESPHandler(socketserver.StreamRequestHandler):
    # replies to a pipelined command batch (xadd_many, hmget) go out as
    # many small writes; with Nagle on, each waits for the client's
    # delayed ACK before the next segment leaves — measured ~40 ms per
    # fused call on loopback, dwarfing the round trip it was fusing away
    disable_nagle_algorithm = True

    def setup(self):
        super().setup()
        conns = getattr(self.server, "live_connections", None)
        if conns is not None:
            with self.server.live_lock:
                conns.add(self.request)

    def finish(self):
        conns = getattr(self.server, "live_connections", None)
        if conns is not None:
            with self.server.live_lock:
                conns.discard(self.request)
        super().finish()

    def handle(self):
        while True:
            try:
                args = self._read_command()
            except (ConnectionError, ValueError):
                return
            if args is None:
                return
            try:
                reply = self.server.store.execute(args)
                self.wfile.write(_encode_reply(reply))
            except RESPError as e:
                self.wfile.write(b"-%s\r\n" % str(e).encode())
            except Exception as e:  # noqa: BLE001 — protocol error reply
                self.wfile.write(b"-ERR %s\r\n" % str(e).encode())

    def _read_command(self):
        line = self.rfile.readline()
        if not line:
            return None
        if line[:1] != b"*":
            raise ValueError(f"expected RESP array, got {line!r}")
        n = int(line[1:-2])
        args = []
        for _ in range(n):
            hdr = self.rfile.readline()
            if hdr[:1] != b"$":
                raise ValueError(f"expected bulk string, got {hdr!r}")
            ln = int(hdr[1:-2])
            args.append(self.rfile.read(ln + 2)[:-2].decode())
        return args


def _encode_reply(v) -> bytes:
    if v is NIL_ARRAY:
        return b"*-1\r\n"
    if v is None:
        return b"$-1\r\n"
    if isinstance(v, int):
        return b":%d\r\n" % v
    if isinstance(v, Simple):
        return b"+%s\r\n" % v.encode()
    if isinstance(v, str):
        data = v.encode()
        return b"$%d\r\n%s\r\n" % (len(data), data)
    if isinstance(v, list):
        return b"*%d\r\n" % len(v) + b"".join(
            _encode_reply(x) for x in v)
    raise TypeError(f"cannot encode {type(v)} as RESP")


class MiniRedisServer:
    """Threaded RESP2 server over a MiniRedisStore.

    >>> srv = MiniRedisServer().start()
    >>> broker = connect_broker(srv.url)     # real socket + wire protocol
    >>> srv.stop()
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 store: Optional[MiniRedisStore] = None):
        self.store = store or MiniRedisStore()

        class _Server(socketserver.ThreadingTCPServer):
            # restart-on-same-port (the client-reconnect contract:
            # a broker that comes back at its old address with its old
            # store) must not trip over TIME_WAIT from the old socket
            allow_reuse_address = True

        self._srv = _Server(
            (host, port), _RESPHandler, bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.store = self.store
        # stop() must sever LIVE client connections too, not just the
        # listener: a "restarted broker" whose old sockets keep
        # answering from the old process would make every client-side
        # reconnect test (and real failover) a lie
        self._srv.live_connections = set()
        self._srv.live_lock = threading.Lock()
        self.host, self.port = self._srv.server_address
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    @property
    def url(self) -> str:
        return f"redis://{self.host}:{self.port}"

    def start(self) -> "MiniRedisServer":
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
        with self._srv.live_lock:
            conns = list(self._srv.live_connections)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
