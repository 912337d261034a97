"""Several consumers of one stream, in the port: the engine's claim sweep,
idempotent writeback, partition leases (`serving/partitions.py`), the
gateway leader lease, a two-replica pool behind the engine with its
`ReplicaSupervisor` (`serving/supervisor.py`), and the sink's writeback
buffer through a broker outage. Held to the cases of the JAX package's
own tests: tests/test_serving_fleet.py (`TestEngineClaimSweep`,
`TestIdempotentWriteback`, `TestPartitionLeases`,
`TestGatewayLeaderLease`), tests/test_serving_multidevice.py
(`TestServingEngineMultiDevice`) and tests/test_fault_tolerance.py (the
engine's outage and quarantine cases). Every case runs on both packages.
Engines with an `engine_id` run with both fleet intervals at 0 (no
heartbeat, no registry blob), so that the broker holds only what each case
checks; `test_dead_peer_records_served_with_heartbeats_on` runs the claim
sweep with the fleet plane on, beside a gateway's `FleetTracker`.
"""

import json
import time

import numpy as np
import pytest

from torch_cluster_serving_impls import (  # noqa: F401 (fixtures)
    RESULT_KEY, STREAM, m, no_stray_threads, wait_for, wait_results)

NO_FLEET = dict(heartbeat_interval_s=0, fleet_metrics_interval_s=0)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    from analytics_zoo_tpu.common import faults as jf
    from analytics_zoo_tpu_torch.common import faults as tf
    yield
    jf.clear()
    tf.clear()


def _engine(m, broker, engine_id=None, registry=None, **kw):
    kw.setdefault("batch_size", 8)
    kw.setdefault("batch_timeout_ms", 2)
    if engine_id is not None:
        kw = dict(NO_FLEET, **kw)
    return m.server.ClusterServing(
        m.fn_model("double"), broker=broker, engine_id=engine_id,
        registry=registry or m.registry.MetricsRegistry(), **kw)


def _hash_at_least(broker, n, timeout_s=30.0):
    wait_for(lambda: broker.hlen(RESULT_KEY) >= n, timeout_s=timeout_s,
             interval=0.01, msg=f"{n} results")
    return broker.hgetall(RESULT_KEY)


# ---------------------------------------------------------------------------
# tests/test_serving_fleet.py TestEngineClaimSweep
# ---------------------------------------------------------------------------
def test_dead_peer_records_served_zero_loss(m):
    broker = m.broker.MemoryBroker(redeliver_after_s=60.0)
    inq = m.client.InputQueue(broker)
    for i in range(6):
        inq.enqueue(uri=f"k{i}", t=np.full(3, float(i), np.float32))
    dead = broker.read_group(STREAM, m.server.GROUP, "dead-engine", 6,
                             block_ms=50)
    assert len(dead) == 6
    s = _engine(m, broker, engine_id="e-live", claim_min_idle_s=0.05,
                claim_interval_s=0.05).start()
    try:
        res = _hash_at_least(broker, 6)
        assert sorted(res) == [f"k{i}" for i in range(6)]
        wait_for(lambda: s.records_served == 6, msg="served count")
        got = s.metrics()
        assert got["claimed_records"] == 6 and got["records_served"] == 6
    finally:
        s.stop()
    assert broker.pending_count(STREAM, m.server.GROUP) == 0


def test_dead_peer_records_served_with_heartbeats_on(m):
    """The claim sweep with the fleet plane on: the live engine beats
    into `engines:<stream>` and publishes its registry while it adopts a
    dead consumer's records, and a gateway's tracker sees it alive."""
    broker = m.broker.MemoryBroker(redeliver_after_s=60.0)
    inq = m.client.InputQueue(broker)
    for i in range(6):
        inq.enqueue(uri=f"h{i}", t=np.full(3, float(i), np.float32))
    assert len(broker.read_group(STREAM, m.server.GROUP, "dead-engine", 6,
                                 block_ms=50)) == 6
    tracker = m.fleet.FleetTracker(broker, STREAM, ttl_s=5.0,
                                   registry=m.registry.MetricsRegistry(),
                                   poll_min_interval_s=0.0)
    s = _engine(m, broker, engine_id="e-live", claim_min_idle_s=0.05,
                claim_interval_s=0.05, heartbeat_interval_s=0.05,
                fleet_metrics_interval_s=0.05).start()
    try:
        res = _hash_at_least(broker, 6)
        assert sorted(res) == [f"h{i}" for i in range(6)]
        wait_for(lambda: s.records_served == 6, msg="served count")
        assert s.metrics()["claimed_records"] == 6
        wait_for(lambda: tracker.alive_count() == 1, msg="alive by beat")
        wait_for(lambda: tracker.poll(force=True)["e-live"].get(
            "records_served") == 6, msg="served count in the beat")
        assert tracker.poll(force=True)["e-live"]["ready"]
        wait_for(lambda: broker.hget(f"metrics:{STREAM}", "e-live")
                 is not None, msg="registry blob")
    finally:
        s.stop()
        tracker.close()
    assert broker.pending_count(STREAM, m.server.GROUP) == 0
    assert tracker.poll(force=True) == {}


def test_sweep_never_reclaims_own_inflight(m):
    broker = m.broker.MemoryBroker(redeliver_after_s=60.0)
    inq = m.client.InputQueue(broker)
    for i in range(6):
        inq.enqueue(uri=f"s{i}", t=np.full(3, float(i), np.float32))
    assert len(broker.read_group(STREAM, m.server.GROUP, "dead", 6,
                                 block_ms=50)) == 6
    s = _engine(m, broker, engine_id="e1", claim_min_idle_s=0.02,
                claim_interval_s=0.02).start()
    try:
        _hash_at_least(broker, 6)
        time.sleep(0.3)
        got = s.metrics()
        assert got["claimed_records"] == 6, "own in-flight re-claimed"
        assert got["records_read"] == 6
    finally:
        s.stop()


def test_two_engines_drain_one_stream(m):
    srv = m.redis_server.MiniRedisServer().start()
    total, engines, conns = 48, [], []

    def conn():
        conns.append(m.broker.RedisBroker(srv.host, srv.port))
        return conns[-1]

    try:
        inq = m.client.InputQueue(conn())
        for i in range(total):
            inq.enqueue(uri=f"t{i}", t=np.full(3, float(i), np.float32))
        regs = [m.registry.MetricsRegistry() for _ in range(2)]
        for i in range(2):
            engines.append(_engine(m, conn(), engine_id=f"e{i}",
                                   registry=regs[i], batch_size=4).start())
        poll = conn()
        res = _hash_at_least(poll, total)
        assert sorted(res) == sorted(f"t{i}" for i in range(total))
        wait_for(lambda: sum(e.records_served for e in engines) >= total,
                 timeout_s=10, msg="served counters")
        assert sum(e.records_served for e in engines) == total
        for i, reg in enumerate(regs):
            series = reg.get("serving_records_total").snapshot()["series"]
            assert all(s["labels"].get("engine") == f"e{i}"
                       for s in series), series
    finally:
        for e in engines:
            e.stop()
        for c in conns:
            c.close()
        srv.stop()


# ---------------------------------------------------------------------------
# tests/test_serving_fleet.py TestIdempotentWriteback
# ---------------------------------------------------------------------------
def _entry():
    return ({"u1": "r1", "u2": "r2"}, ["1-1", "1-2"], time.perf_counter(),
            time.perf_counter(), False)


def test_redelivered_writeback_counts_duplicate_not_served(m):
    reg = m.registry.MetricsRegistry()
    broker = m.broker.MemoryBroker()
    s = _engine(m, broker, engine_id="e1", registry=reg)
    try:
        assert s._write_entry(_entry())
        assert s._write_entry(_entry())
        assert s.records_served == 2
        fam = reg.get("serving_records_total")
        assert fam.value(outcome="served", engine="e1") == 2
        assert fam.value(outcome="duplicate", engine="e1") == 2
        assert broker.hgetall(RESULT_KEY) == {"u1": "r1", "u2": "r2"}
    finally:
        s.stop()


def test_own_buffered_retry_counts_served_not_duplicate(m):
    reg = m.registry.MetricsRegistry()
    broker = m.broker.MemoryBroker()
    s = _engine(m, broker, engine_id="e1", registry=reg)
    try:
        broker.hset_many(RESULT_KEY, {"u1": "r1", "u2": "r2"})
        s._wb_buffer.append(_entry())
        s._flush_writebacks()
        assert not s._wb_buffer and s.records_served == 2
        fam = reg.get("serving_records_total")
        assert fam.value(outcome="served", engine="e1") == 2
        assert fam.value(outcome="duplicate", engine="e1") == 0
    finally:
        s.stop()


# ---------------------------------------------------------------------------
# tests/test_serving_fleet.py TestPartitionLeases, TestGatewayLeaderLease
# ---------------------------------------------------------------------------
def _table(m, broker, owner, partitions=2, ttl_s=5.0, registry=None):
    return m.partitions.PartitionLeaseTable(
        broker, STREAM, partitions, owner=owner, ttl_s=ttl_s,
        registry=registry or m.registry.MetricsRegistry())


def test_lone_engine_owns_every_partition(m):
    t = _table(m, m.broker.MemoryBroker(), "eA", partitions=4)
    assert t.poll(now=0.0) == [0, 1, 2, 3]
    assert t.owned_streams() == [f"{STREAM}.p{i}" for i in range(4)]
    assert t.poll(now=1.0) == [0, 1, 2, 3]


def test_member_join_rebalances_to_fair_share(m):
    broker = m.broker.MemoryBroker()
    a, b = _table(m, broker, "eA"), _table(m, broker, "eB")
    assert a.poll(now=0.0) == [0, 1]
    assert b.poll(now=0.0) == []
    assert a.poll(now=0.1) == [0]
    assert b.poll(now=0.2) == [1]
    assert a.poll(now=0.3) == [0]


def test_expiry_takeover_and_clean_release(m):
    broker = m.broker.MemoryBroker()
    reg_b = m.registry.MetricsRegistry()
    a = _table(m, broker, "eA")
    b = _table(m, broker, "eB", registry=reg_b)
    assert a.poll(now=0.0) == [0, 1]
    a.abandon()
    assert b.poll(now=0.0) == []
    assert b.poll(now=51.0) == [0, 1]
    fam = reg_b.get("serving_partition_lease_changes_total")
    assert fam.value(event="takeover", partition="0") == 1
    assert fam.value(event="takeover", partition="1") == 1
    b.release()
    assert _table(m, broker, "eC").poll(now=0.0) == [0, 1]


def test_reshard_gate_refuses_a_count_change(m):
    broker = m.broker.MemoryBroker()
    a = _table(m, broker, "eA", partitions=2)
    a.ensure_meta()
    a.poll(now=0.0)
    b = _table(m, broker, "eB", partitions=3)
    with pytest.raises(ValueError, match="reshard"):
        b.ensure_meta()
    assert b.ensure_meta(reshard=True) == 3
    key = m.partitions.partitions_key(STREAM)
    assert broker.hget(key, "p0") is None
    assert json.loads(broker.hget(key, "meta"))["partitions"] == 3


def _lease(m, broker, gid, ttl_s=1.0, registry=None):
    return m.partitions.GatewayLeaderLease(
        broker, STREAM, gid, ttl_s=ttl_s,
        registry=registry or m.registry.MetricsRegistry())


def test_gateway_single_election_and_takeover(m):
    broker = m.broker.MemoryBroker()
    reg2 = m.registry.MetricsRegistry()
    g1, g2 = _lease(m, broker, "gw1"), _lease(m, broker, "gw2",
                                              registry=reg2)
    assert g1.poll(now=0.0) and g1.is_leader()
    assert not g2.poll(now=0.0) and g2.leader() == "gw1"
    assert g1.poll(now=0.5) and not g2.poll(now=0.6)
    # gw1 goes silent: past the ttl on gw2's clock, gw2 elects itself
    assert g2.poll(now=2.0) and g2.leader() == "gw2"
    assert reg2.get("gateway_leader_changes_total").value(
        event="elected") == 1
    assert not g1.poll(now=2.5) and not g1.is_leader()
    g2.stop(release=True)
    assert _lease(m, broker, "gw3").poll(now=0.0)


def test_gateway_lease_validation(m):
    broker = m.broker.MemoryBroker()
    with pytest.raises(ValueError, match="gateway_id"):
        m.partitions.GatewayLeaderLease(
            broker, STREAM, "", registry=m.registry.MetricsRegistry())
    with pytest.raises(ValueError, match="ttl_s"):
        m.partitions.GatewayLeaderLease(
            broker, STREAM, "gw", ttl_s=0,
            registry=m.registry.MetricsRegistry())


def test_partitioned_engine_serves_every_partition(m):
    """An engine over a 3-way partitioned stream: the client routes by uri
    hash, the engine leases every partition and answers every record."""
    broker = m.broker.MemoryBroker()
    inq = m.client.InputQueue(broker, partitions=3)
    s = _engine(m, broker, engine_id="p0", partitions=3,
                partition_lease_ttl_s=1.0).start()
    try:
        xs = [np.full(2, i, np.float32) for i in range(12)]
        out = inq.predict_batch(xs, timeout_s=30)
        for i, y in enumerate(out):
            np.testing.assert_allclose(y, 2.0 * xs[i])
        assert sorted(s.metrics()["partitions"]["owned"]) == [0, 1, 2]
    finally:
        s.stop()
    assert broker.hget(m.partitions.partitions_key(STREAM), "p0") is None


# ---------------------------------------------------------------------------
# tests/test_serving_multidevice.py TestServingEngineMultiDevice, on a
# two-replica pool
# ---------------------------------------------------------------------------
def test_pipeline_routes_across_both_replicas(m):
    W, im = m.linear(replicas=2)
    br = m.broker.MemoryBroker()
    serving = m.server.ClusterServing(
        im, br, batch_size=1, batch_timeout_ms=0,
        registry=m.registry.MetricsRegistry()).start()
    try:
        q = m.client.InputQueue(br)
        uris = [q.enqueue(None, t=np.ones((4,), np.float32) * i)
                for i in range(16)]
        results = wait_results(m, br, uris)
        assert len(results) == 16
        for i, u in enumerate(uris):
            np.testing.assert_allclose(
                results[u], (np.ones(4, np.float32) * i) @ W, atol=1e-4)
        got = serving.metrics()
        assert got["placement"]["num_replicas"] == 2
        assert all(s["batches"] > 0 for s in got["replicas"])
        assert serving.supervisor is not None
    finally:
        serving.stop()
        im.close()


def test_per_replica_failure_isolation_and_drain(m):
    _, im = m.linear(replicas=2)
    br = m.broker.MemoryBroker()
    serving = m.server.ClusterServing(
        im, br, batch_size=4, failure_threshold=1000,
        registry=m.registry.MetricsRegistry()).start()
    q = m.client.InputQueue(br)
    good, bad = [], []
    for i in range(16):
        good.append(q.enqueue(None, t=np.ones((4,), np.float32) * i))
        if i % 4 == 0:
            bad.append(q.enqueue(None, t=np.ones((5,), np.float32)))
    try:
        results = wait_results(m, br, good + bad)
        assert serving.is_alive()
    finally:
        serving.stop()
        im.close()
    assert len(results) == len(good) + len(bad)
    for u in bad:
        assert isinstance(results[u], float) and np.isnan(results[u])
    for u in good:
        assert np.asarray(results[u]).shape == (3,)
    assert serving.records_served == len(good) + len(bad)
    assert not serving._threads


def test_replica_gauges_released_on_stop(m):
    reg = m.registry.MetricsRegistry()
    _, im = m.linear(replicas=2)
    serving = m.server.ClusterServing(im, m.broker.MemoryBroker(),
                                      registry=reg)
    try:
        live = {s["labels"]["replica"] for s in
                reg.snapshot()["serving_replica_inflight"]["series"]}
        assert live == {"0", "1"}
    finally:
        serving.stop()
        im.close()
    assert not reg.snapshot()["serving_replica_inflight"].get("series")


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py: quarantine round trip and a sink outage
# ---------------------------------------------------------------------------
def _counter(m, name, **labels):
    fam = m.registry.get_registry().get(name)
    return fam.value(**labels) if fam is not None else 0.0


def test_quarantine_revival_round_trip(m):
    W, im = m.linear(replicas=2)
    broker = m.broker.MemoryBroker()
    q_before = _counter(m, "serving_replica_quarantined_total",
                        replica="1", reason="failures")
    serving = m.server.ClusterServing(
        im, broker=broker, batch_size=1, batch_timeout_ms=2,
        failure_threshold=2, probe_interval_s=0.1,
        latency_floor_ms=2000.0).start()
    try:
        m.faults.inject("replica.dispatch",
                        m.faults.Fault(match=lambda c: c["replica"] == 1))
        inq = m.client.InputQueue(broker)
        deadline = time.monotonic() + 20
        while im.healthy_replicas() == 2 and time.monotonic() < deadline:
            inq.enqueue(t=np.ones((4,), np.float32))
            time.sleep(0.01)
        assert im.healthy_replicas() == 1
        wait_for(lambda: _counter(m, "serving_replica_quarantined_total",
                                  replica="1", reason="failures")
                 == q_before + 1, msg="quarantine counter")
        fresh = [inq.enqueue(t=np.full((4,), i, np.float32))
                 for i in range(6)]
        res = wait_results(m, broker, fresh)
        for i, u in enumerate(fresh):
            np.testing.assert_allclose(
                res[u], np.full((4,), i, np.float32) @ W, atol=1e-5)
        m.faults.clear("replica.dispatch")
        wait_for(lambda: im.healthy_replicas() == 2, msg="revival")
        assert serving.health()["ready"] is True
    finally:
        serving.stop()
        im.close()


def test_zero_record_loss_through_sink_outage(m):
    W, im = m.linear()
    broker = m.broker.MemoryBroker()
    serving = m.server.ClusterServing(
        im, broker=broker, batch_size=4, batch_timeout_ms=2,
        breaker_failure_threshold=2, breaker_reset_s=0.05).start()
    try:
        m.faults.inject("broker.writeback", m.faults.Fault(
            match=lambda c: c["role"] == "sink"))
        inq = m.client.InputQueue(broker)
        uris = [inq.enqueue(t=np.full((4,), i, np.float32))
                for i in range(12)]
        wait_for(lambda: len(serving._wb_buffer) > 0, msg="buffering")
        m.faults.clear("broker.writeback")
        res = wait_results(m, broker, uris)
        for i, u in enumerate(uris):
            np.testing.assert_allclose(
                res[u], np.full((4,), i, np.float32) @ W, atol=1e-5)
    finally:
        serving.stop()
