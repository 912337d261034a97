"""The serving plane's transports in the port (`serving/broker.py`'s
`TCPBrokerServer` / `TCPBroker` / `RedisBroker`, `serving/redis_server.py`'s
`MiniRedisServer`, the client's reconnect and backoff) held to the cases
of the JAX package's own tests: tests/test_serving.py
(`TestBrokerContract`), tests/test_redis_broker.py (all three classes),
tests/test_serving_pipeline.py (`TestBatchedWriteback`),
tests/test_serving_fleet.py (`TestRedeliveryConformance`,
`TestClientReconnect`), tests/test_elastic_serving.py (`TestStreamDepth`)
and tests/test_serving_multidevice.py (`TestClientBackoff`). Every case runs
on both packages. Every server binds port 0 and stops in a `finally` or a
fixture teardown.
"""

import threading
import time

import numpy as np
import pytest

from tests.test_resp2_conformance import SpecClient
from torch_cluster_serving_impls import (  # noqa: F401 (fixtures)
    STREAM, m, no_stray_threads)


@pytest.fixture(scope="module")
def servers():
    """One TCP and one RESP2 server per package for the whole module
    (a server's stop waits out its serve loop's 0.5 s poll), emptied
    before each test that takes one."""
    made = {}
    yield made
    for srv in made.values():
        srv.stop()


def _server(m, servers, kind):
    key = (m.name, kind)
    if key not in servers:
        servers[key] = (m.broker.TCPBrokerServer() if kind == "tcp"
                        else m.redis_server.MiniRedisServer()).start()
    srv = servers[key]
    if kind == "tcp":
        b = srv.broker
        with b._lock:
            b._streams.clear()
            b._pending.clear()
            b._hashes.clear()
            b._seq = 0
    else:
        st = srv.store
        with st.lock:
            st.streams.clear()
            st.groups.clear()
            st.hashes.clear()
            st.seq = 0
    return srv


@pytest.fixture()
def redis_server(m, servers):
    return _server(m, servers, "redis")


@pytest.fixture(params=["memory", "tcp", "redis"])
def broker_pair(request, m, servers):
    """(broker_a, broker_b): two connections to one backing store."""
    kind = request.param
    if kind == "memory":
        br = m.broker.MemoryBroker()
        yield br, br
        return
    srv = _server(m, servers, kind)
    cls = m.broker.TCPBroker if kind == "tcp" else m.broker.RedisBroker
    a, b = (cls(srv.host, srv.port) for _ in range(2))
    yield a, b
    for br in (a, b):
        if hasattr(br, "close"):
            br.close()


def _xadd_n(broker, n, stream=STREAM):
    return [broker.xadd(stream, {"uri": f"u{i}", "data": {"v": i}})
            for i in range(n)]


# ---------------------------------------------------------------------------
# tests/test_serving.py TestBrokerContract
# ---------------------------------------------------------------------------
def test_memory_stream_group_ack(m):
    br = m.broker.MemoryBroker()
    r1 = br.xadd("s", {"v": 1})
    br.xadd("s", {"v": 2})
    got = br.read_group("s", "g", "c1", 10)
    assert [rec["v"] for _, rec in got] == [1, 2]
    assert br.read_group("s", "g", "c2", 10, block_ms=1) == []
    br.ack("s", "g", [r1])
    assert br.read_group("s", "g", "c3", 10, block_ms=1) == []


def test_memory_redelivery_after_timeout(m):
    br = m.broker.MemoryBroker(redeliver_after_s=0.05)
    br.xadd("s", {"v": 1})
    assert len(br.read_group("s", "g", "c1", 10)) == 1
    time.sleep(0.08)
    assert len(br.read_group("s", "g", "c2", 10)) == 1


def test_tcp_broker_roundtrip(m, servers):
    srv = _server(m, servers, "tcp")
    cli = m.broker.TCPBroker(srv.host, srv.port)
    cli.xadd("s", {"v": 42})
    got = cli.read_group("s", "g", "c", 5)
    assert got[0][1]["v"] == 42
    cli.ack("s", "g", [got[0][0]])
    cli.hset("k", "f", "x")
    assert cli.hget("k", "f") == "x"


def test_connect_broker_returns_working_transports(m, servers):
    """`connect_broker` of a tcp:// or redis:// url of a port-0 server is
    a working broker of its package."""
    tcp = _server(m, servers, "tcp")
    red = _server(m, servers, "redis")
    for url, cls in ((f"tcp://{tcp.host}:{tcp.port}", m.broker.TCPBroker),
                     (red.url, m.broker.RedisBroker)):
        br = m.broker.connect_broker(url)
        assert isinstance(br, cls)
        rid = br.xadd("s", {"uri": "a", "data": {"v": 1}})
        [(got, rec)] = br.read_group("s", "g", "c", 4, block_ms=10)
        assert got == rid and rec["uri"] == "a"
        assert br.writeback("h", {"a": "r"}, "s", "g", [rid]) == 1
        assert br.hget("h", "a") == "r"
        assert br.pending_count("s", "g") == 0
        if hasattr(br, "close"):
            br.close()


# ---------------------------------------------------------------------------
# tests/test_redis_broker.py TestRedisBrokerProtocol, TestBlockingRead,
# TestRESPTypes
# ---------------------------------------------------------------------------
def test_redis_stream_group_ack_cycle(m, redis_server):
    br = m.broker.RedisBroker("127.0.0.1", redis_server.port)
    rid = br.xadd("serving_stream", {"uri": "a", "data": {"v": 1}})
    assert rid == "1-0"
    got = br.read_group("serving_stream", "serving", "c1", count=8)
    assert got == [("1-0", {"uri": "a", "data": {"v": 1}})]
    assert br.read_group("serving_stream", "serving", "c1",
                         count=8, block_ms=1) == []
    br.ack("serving_stream", "serving", ["1-0"])
    assert redis_server.store.groups[("serving_stream", "serving")][
        "pel"] == {}
    assert redis_server.store.streams["serving_stream"] == []
    br.close()


def test_redis_group_create_idempotent(m, redis_server):
    br = m.broker.RedisBroker("127.0.0.1", redis_server.port)
    br.read_group("s", "g", "c", count=1, block_ms=1)
    br2 = m.broker.RedisBroker("127.0.0.1", redis_server.port)
    assert br2.read_group("s", "g", "c2", count=1, block_ms=1) == []
    br.close()
    br2.close()


def test_redis_hash_ops_and_payload(m, redis_server):
    br = m.broker.RedisBroker("127.0.0.1", redis_server.port)
    br.hset("result:serving_stream", "uri1", "[1.0, 2.0]")
    br.hset("result:serving_stream", "uri2", "NaN")
    assert br.hget("result:serving_stream", "uri1") == "[1.0, 2.0]"
    assert br.hgetall("result:serving_stream") == {
        "uri1": "[1.0, 2.0]", "uri2": "NaN"}
    br.hdel("result:serving_stream", "uri1")
    assert br.hget("result:serving_stream", "uri1") is None
    # the serving record shape (b64 ndarray) survives the wire, int64 too
    for arr in (np.arange(6, dtype=np.float32).reshape(2, 3),
                np.arange(5, dtype=np.int64) * (1 << 40)):
        br.xadd("serving_stream", {"uri": "u", "data": {
            "t": m.broker.encode_ndarray(arr)}})
        [(rid, rec)] = br.read_group("serving_stream", "serving", "c",
                                     count=1)
        out = m.broker.decode_ndarray(rec["data"]["t"])
        assert out.dtype == arr.dtype
        np.testing.assert_array_equal(out, arr)
    br.close()


def test_redis_long_block_survives_client_socket_timeout(m, redis_server):
    br = m.broker.RedisBroker("127.0.0.1", redis_server.port)
    br._r._timeout_s = 0.2
    br._r._sock.settimeout(0.2)
    t0 = time.time()
    got = br.read_group("s2", "g", "c", count=1, block_ms=500)
    assert got == [] and time.time() - t0 < 5
    br.hset("k", "f", "v")
    assert br.hget("k", "f") == "v"
    br.close()


def test_redis_reconnects_after_connection_loss(m, redis_server):
    br = m.broker.RedisBroker("127.0.0.1", redis_server.port)
    br.hset("k", "f", "1")
    br._r.close()
    assert br.hget("k", "f") == "1"
    br.close()


def test_redis_error_reply_raises(m, redis_server):
    br = m.broker.RedisBroker("127.0.0.1", redis_server.port)
    with pytest.raises(m.broker.RESPError):
        br._r.command("NOSUCHCOMMAND")
    br.close()


def test_block_parks_until_xadd(m, redis_server):
    br = m.broker.RedisBroker("127.0.0.1", redis_server.port)
    got = {}

    def reader():
        t0 = time.time()
        got["res"] = br.read_group("bs", "g", "c", count=1, block_ms=5000)
        got["dt"] = time.time() - t0

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.2)
    w = m.broker.RedisBroker("127.0.0.1", redis_server.port)
    w.xadd("bs", {"v": 1})
    t.join(timeout=10)
    assert got["res"] and got["res"][0][1] == {"v": 1}
    assert 0.1 < got["dt"] < 3.0
    br.close()
    w.close()


def test_block_times_out_empty(m, redis_server):
    br = m.broker.RedisBroker("127.0.0.1", redis_server.port)
    t0 = time.time()
    assert br.read_group("bs2", "g", "c", count=1, block_ms=200) == []
    assert 0.15 < time.time() - t0 < 2.0
    br.close()


def test_hash_value_literally_ok_is_bulk(m, redis_server):
    c = SpecClient(redis_server.host, redis_server.port)
    try:
        assert c.call("HSET", "h", "f", "OK") == ("int", 1)
        assert c.call("HGET", "h", "f") == ("bulk", "OK")
        kind, _ = c.call("XADD", "st", "*", "k", "v")
        assert kind == "bulk"
        assert c.call("XGROUP", "CREATE", "st", "g", "$") == \
            ("simple", "OK")
        assert c.call("PING") == ("simple", "PONG")
        assert c.call("PING", "hello") == ("bulk", "hello")
    finally:
        c.close()


# ---------------------------------------------------------------------------
# tests/test_serving_pipeline.py TestBatchedWriteback
# ---------------------------------------------------------------------------
def test_hset_many_and_hdel_many_on_every_transport(m, broker_pair):
    cli, _ = broker_pair
    cli.hset_many("k", {"a": "1", "b": "2", "c": "3"})
    assert cli.hgetall("k") == {"a": "1", "b": "2", "c": "3"}
    cli.hdel_many("k", ["a", "c"])
    assert cli.hgetall("k") == {"b": "2"}


def test_redis_broker_clone_is_independent_connection(m, redis_server):
    a = m.broker.RedisBroker(redis_server.host, redis_server.port)
    b = a.clone()
    assert b is not a and b._r is not a._r
    a.hset("k", "f", "v")
    assert b.hget("k", "f") == "v"
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# tests/test_serving_fleet.py TestRedeliveryConformance
# ---------------------------------------------------------------------------
def test_dead_consumer_records_claimable(m, broker_pair):
    a, b = broker_pair
    _xadd_n(a, 8)
    dead = a.read_group(STREAM, "g", "dead", 5, block_ms=50)
    assert len(dead) == 5
    assert a.pending_count(STREAM, "g") == 5
    claimed = b.claim_stale(STREAM, "g", "live", 0, 10)
    assert sorted(rid for rid, _ in claimed) == \
        sorted(rid for rid, _ in dead)
    assert {rec["uri"] for _, rec in claimed} == \
        {rec["uri"] for _, rec in dead}
    fresh = b.read_group(STREAM, "g", "live", 10, block_ms=50)
    assert len(fresh) == 3
    b.ack(STREAM, "g", [rid for rid, _ in claimed + fresh])
    assert b.pending_count(STREAM, "g") == 0
    uris = [rec["uri"] for _, rec in claimed + fresh]
    assert sorted(uris) == [f"u{i}" for i in range(8)]


def test_min_idle_window_respected(m, broker_pair):
    a, b = broker_pair
    _xadd_n(a, 3)
    a.read_group(STREAM, "g", "c1", 3, block_ms=50)
    assert b.claim_stale(STREAM, "g", "c2", 60_000, 10) == []
    assert a.pending_count(STREAM, "g") == 3


def test_claim_restarts_idle_clock(m, broker_pair):
    a, b = broker_pair
    _xadd_n(a, 2)
    a.read_group(STREAM, "g", "c1", 2, block_ms=50)
    assert len(b.claim_stale(STREAM, "g", "c2", 0, 10)) == 2
    assert b.claim_stale(STREAM, "g", "c3", 60_000, 10) == []


def test_acked_records_not_claimable(m, broker_pair):
    a, b = broker_pair
    _xadd_n(a, 4)
    got = a.read_group(STREAM, "g", "c1", 4, block_ms=50)
    a.ack(STREAM, "g", [rid for rid, _ in got])
    assert b.claim_stale(STREAM, "g", "c2", 0, 10) == []
    assert b.pending_count(STREAM, "g") == 0


def test_hset_many_reports_new_fields_only(m, broker_pair):
    a, b = broker_pair
    assert a.hset_many("h", {"u1": "r1", "u2": "r2"}) == 2
    assert b.hset_many("h", {"u2": "r2", "u3": "r3"}) == 1
    assert a.hset("h", "u1", "r1b") == 0
    assert a.hgetall("h") == {"u1": "r1b", "u2": "r2", "u3": "r3"}


def test_writeback_commits_results_and_acks_atomically(m, broker_pair):
    a, b = broker_pair
    _xadd_n(a, 4)
    got = a.read_group(STREAM, "g", "c1", 4, block_ms=50)
    assert a.writeback("h", {"u0": "r0", "u1": "r1"},
                       STREAM, "g", [rid for rid, _ in got[:2]]) == 2
    assert a.pending_count(STREAM, "g") == 2
    assert b.writeback("h", {"u1": "r1", "u2": "r2"},
                       STREAM, "g", [rid for rid, _ in got[2:]]) == 1
    assert b.pending_count(STREAM, "g") == 0
    assert b.hgetall("h") == {"u0": "r0", "u1": "r1", "u2": "r2"}
    assert b.claim_stale(STREAM, "g", "c2", 0, 10) == []


def test_hlen_counts_without_serializing(m, broker_pair):
    a, b = broker_pair
    assert a.hlen("h") == 0
    a.hset_many("h", {"u1": "r1", "u2": "r2"})
    a.hset("h", "u1", "r1b")
    assert b.hlen("h") == 2 == len(b.hgetall("h"))


def test_xadd_many_one_call_spans_partition_streams(m, broker_pair):
    a, b = broker_pair
    entries = [(f"{STREAM}.p{i % 2}", {"uri": f"u{i}", "data": {"v": i}})
               for i in range(6)]
    ids = a.xadd_many(entries)
    assert len(ids) == 6 and all(ids)
    assert b.stream_depth(f"{STREAM}.p0") == 3
    assert b.stream_depth(f"{STREAM}.p1") == 3
    got = b.read_group(f"{STREAM}.p0", "g", "c", 10, block_ms=50)
    assert [rec["uri"] for _, rec in got] == ["u0", "u2", "u4"]
    got = b.read_group(f"{STREAM}.p1", "g", "c", 10, block_ms=50)
    assert [rec["uri"] for _, rec in got] == ["u1", "u3", "u5"]


def test_hmget_matches_hget_and_hdel_many_deletes(m, broker_pair):
    a, b = broker_pair
    a.hset_many("h", {"u1": "r1", "u2": "r2"})
    assert b.hmget("h", ["u1", "missing", "u2"]) == ["r1", None, "r2"]
    assert b.hmget("h", []) == []
    a.hdel_many("h", ["u1", "u2", "missing"])
    assert b.hmget("h", ["u1", "u2"]) == [None, None]
    assert b.hlen("h") == 0


# ---------------------------------------------------------------------------
# tests/test_elastic_serving.py TestStreamDepth
# ---------------------------------------------------------------------------
def test_stream_depth_on_every_transport(m, broker_pair):
    broker, _ = broker_pair
    assert broker.stream_depth("d") == 0
    rids = [broker.xadd("d", {"uri": f"u{i}", "data": {}})
            for i in range(5)]
    assert broker.stream_depth("d") == 5
    got = broker.read_group("d", "g", "c", 3, block_ms=10)
    assert broker.stream_depth("d") == 5
    broker.writeback("result:d", {f"u{i}": "x" for i in range(3)},
                     "d", "g", [r for r, _ in got])
    assert broker.stream_depth("d") == 2
    assert rids


# ---------------------------------------------------------------------------
# tests/test_serving_fleet.py TestClientReconnect
# ---------------------------------------------------------------------------
def test_stop_severs_live_connections(m):
    srv = m.redis_server.MiniRedisServer().start()
    port, store = srv.port, srv.store
    raw = m.broker.RedisBroker(srv.host, port)
    raw.hset("h", "f", "v")
    srv.stop()
    srv2 = m.redis_server.MiniRedisServer(port=port, store=store).start()
    try:
        with pytest.raises((ConnectionError, OSError)):
            raw.hget("h", "f")
        assert raw.hget("h", "f") == "v"
    finally:
        raw.close()
        srv2.stop()


def test_input_queue_rides_out_a_broker_restart(m):
    srv = m.redis_server.MiniRedisServer().start()
    port, store = srv.port, srv.store
    inq = m.client.InputQueue(m.broker.RedisBroker(srv.host, port))
    assert inq.enqueue(uri="r0", t=np.ones(3, np.float32)) == "r0"
    srv.stop()
    landed = []
    t = threading.Thread(target=lambda: landed.append(
        inq.enqueue(uri="r1", t=np.ones(3, np.float32))))
    t.start()
    time.sleep(0.3)
    srv2 = m.redis_server.MiniRedisServer(port=port, store=store).start()
    try:
        t.join(timeout=15)
        assert landed == ["r1"], "enqueue did not survive restart"
        poll = m.broker.RedisBroker("127.0.0.1", port)
        assert poll.stream_depth(STREAM) == 2
        poll.close()
    finally:
        inq.broker.close()
        srv2.stop()


# ---------------------------------------------------------------------------
# tests/test_serving_multidevice.py TestClientBackoff
# ---------------------------------------------------------------------------
def test_deadline_is_monotonic_and_backoff_capped(m):
    q = m.client.InputQueue(m.broker.MemoryBroker())
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        q.predict_batch([np.ones((4,), np.float32)], timeout_s=0.4)
    elapsed = time.monotonic() - t0
    assert 0.3 < elapsed < 2.0, elapsed


def test_streaming_session_and_dequeue_round_trip(m):
    """`StreamingSession` ships its burst as one multi-XADD and drains in
    submission order; `dequeue` takes every completed result, leaving a
    still-decoding sequence's token rows in place."""
    br = m.broker.MemoryBroker()
    inq = m.client.InputQueue(br)
    sess = inq.stream_session(max_inflight=4)
    uris = [sess.submit(np.full(2, i, np.float32)) for i in range(6)]
    assert br.stream_depth(STREAM) == 4      # implicit flush at the cap
    sess.flush()
    recs = br.read_group(STREAM, "g", "c", 10, block_ms=10)
    assert [rec["uri"] for _, rec in recs] == uris
    br.hset_many(f"result:{STREAM}", {
        rec["uri"]: __import__("json").dumps(
            m.broker.encode_ndarray(m.broker.decode_ndarray(
                rec["data"]["t"]) * 2)) for _, rec in recs})
    got = sess.drain(timeout_s=5)
    assert list(got) == uris
    for i, u in enumerate(uris):
        np.testing.assert_array_equal(got[u], np.full(2, 2 * i))
    out = m.client.OutputQueue(br)
    br.hset(f"result:{STREAM}", "done", "NaN")
    br.hset(f"result:{STREAM}", "live#000000", "x")
    drained = out.dequeue()
    assert list(drained) == ["done"] and np.isnan(drained["done"])
    assert br.hgetall(f"result:{STREAM}") == {"live#000000": "x"}
