"""The serving-plane modules the decode slice copied into the port
(`observability/registry.py`, `common/faults.py`, `serving/broker.py`,
`serving/breaker.py`, `serving/paged_kv.py`, `serving/decode.py`'s
`DecodeScheduler` and `KVSlotPool`) held to the cases of the JAX
package's own tests of those classes (tests/test_observability.py,
tests/test_serving.py, tests/test_serving_fleet.py,
tests/test_fault_tolerance.py, tests/test_paged_decode.py). Every case runs
on both packages, so a copy that drifted from its source shows as a case
that passes on one and fails on the other.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.models.generative import TinyDecoder as JDecoder
from analytics_zoo_tpu.observability import registry as jregistry
from analytics_zoo_tpu.serving import breaker as jbreaker
from analytics_zoo_tpu.serving import broker as jbroker
from analytics_zoo_tpu.serving import decode as jdecode
from analytics_zoo_tpu.serving import elastic as jelastic
from analytics_zoo_tpu.serving import paged_kv as jpaged
from analytics_zoo_tpu.serving import partitions as jpartitions
from analytics_zoo_tpu_torch.common import faults as tfaults
from analytics_zoo_tpu_torch.models.generative import TinyDecoder
from analytics_zoo_tpu_torch.observability import registry as tregistry
from analytics_zoo_tpu_torch.serving import breaker as tbreaker
from analytics_zoo_tpu_torch.serving import broker as tbroker
from analytics_zoo_tpu_torch.serving import decode as tdecode
from analytics_zoo_tpu_torch.serving import elastic as telastic
from analytics_zoo_tpu_torch.serving import paged_kv as tpaged
from analytics_zoo_tpu_torch.serving import partitions as tpartitions

BL = 8
TINY = dict(vocab=32, n_layers=2, n_heads=2, head_dim=8, max_len=64)

IMPLS = {
    "jax": SimpleNamespace(
        registry=jregistry, faults=jfaults, broker=jbroker,
        breaker=jbreaker, paged=jpaged, decode=jdecode, elastic=jelastic,
        partitions=jpartitions, init_kv_blocks=JDecoder(**TINY)
        .init_kv_blocks, init_kv=JDecoder(**TINY).init_kv),
    "port": SimpleNamespace(
        registry=tregistry, faults=tfaults, broker=tbroker,
        breaker=tbreaker, paged=tpaged, decode=tdecode, elastic=telastic,
        partitions=tpartitions, init_kv_blocks=TinyDecoder(
            **TINY, device="cpu").init_kv_blocks,
        init_kv=TinyDecoder(**TINY, device="cpu").init_kv),
}


@pytest.fixture(params=sorted(IMPLS))
def m(request):
    return IMPLS[request.param]


# ---------------------------------------------------------------------------
# registry (tests/test_observability.py TestRegistry)
# ---------------------------------------------------------------------------
def test_counter_concurrent_writers_exact(m):
    c = m.registry.MetricsRegistry().counter("work_items_total")

    def worker():
        for _ in range(1000):
            c.inc()
            c.inc(2, kind="batch")

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert c.value() == 8000 and c.value(kind="batch") == 16000


def test_counter_monotonic(m):
    with pytest.raises(ValueError):
        m.registry.MetricsRegistry().counter("x_total").inc(-1)


def test_gauge_set_inc_function_and_failure(m):
    reg = m.registry.MetricsRegistry()
    g = reg.gauge("depth")
    g.set(5, q="a")
    g.inc(2, q="a")
    g.set_function(lambda: 42, q="live")
    snap = reg.snapshot()["depth"]["series"]
    assert {s["labels"]["q"]: s["value"] for s in snap} == \
        {"a": 7.0, "live": 42.0}

    def boom():
        raise RuntimeError("provider gone")
    h = reg.gauge("other")
    h.set_function(boom)
    (s,) = reg.snapshot()["other"]["series"]
    assert s["value"] != s["value"]      # NaN, not a crash


def test_histogram_percentiles_and_counts(m):
    reg = m.registry.MetricsRegistry()
    h = reg.histogram("latency_ms")
    for v in range(1, 1001):
        h.observe(float(v), shard=str(v % 2))
    snap = reg.snapshot()["latency_ms"]["series"]
    assert sum(s["count"] for s in snap) == 1000
    lh = m.registry.LogHistogram()
    for v in range(1, 1001):
        lh.observe(float(v))
    assert lh.percentile(0.5) == pytest.approx(500, rel=0.1)
    assert lh.percentile(0.99) == pytest.approx(990, rel=0.1)
    assert lh.vmin == 1.0 and lh.vmax == 1000.0


def test_get_or_create_and_naming_rules(m):
    reg = m.registry.MetricsRegistry()
    assert reg.counter("records_total", "a") is reg.counter("records_total")
    for bad in (lambda: reg.gauge("records_total"),
                lambda: reg.counter("records"),
                lambda: reg.histogram("latency"),
                lambda: reg.gauge("depth_total"),
                lambda: reg.counter("CamelCase_total"),
                lambda: reg.gauge("bad__name")):
        with pytest.raises(ValueError):
            bad()


def test_delta_view_and_global_registry(m):
    reg = m.registry.MetricsRegistry()
    c, h = reg.counter("reqs_total"), reg.histogram("lat_ms")
    c.inc(10)
    h.observe(5.0)
    prev = reg.snapshot()
    c.inc(7)
    h.observe(5.0)
    h.observe(5.0)
    d = reg.delta(prev)
    assert d["reqs_total"]["series"][0]["value"] == 7
    assert d["lat_ms"]["series"][0]["count"] == 2
    assert m.registry.get_registry() is m.registry.get_registry()


# ---------------------------------------------------------------------------
# MemoryBroker (tests/test_serving.py, tests/test_serving_fleet.py)
# ---------------------------------------------------------------------------
def test_ndarray_codec_roundtrip(m):
    a = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    np.testing.assert_array_equal(
        m.broker.decode_ndarray(m.broker.encode_ndarray(a)), a)


def test_stream_group_ack_and_redelivery(m):
    br = m.broker.MemoryBroker(redeliver_after_s=0.05)
    r1 = br.xadd("s", {"v": 1})
    br.xadd("s", {"v": 2})
    got = br.read_group("s", "g", "c1", 10)
    assert [rec["v"] for _, rec in got] == [1, 2]
    assert br.read_group("s", "g", "c2", 10, block_ms=1) == []
    br.ack("s", "g", [r1])
    time.sleep(0.08)
    # the unacked record redelivers to a peer (at-least-once)
    assert [rec["v"] for _, rec in
            br.read_group("s", "g", "c3", 10, block_ms=1)] == [2]


def test_hash_ops(m):
    br = m.broker.MemoryBroker()
    assert br.hset_many("h", {"u1": "r1", "u2": "r2"}) == 2
    assert br.hset_many("h", {"u2": "r2", "u3": "r3"}) == 1
    assert br.hset("h", "u1", "r1b") == 0
    assert br.hgetall("h") == {"u1": "r1b", "u2": "r2", "u3": "r3"}
    assert br.hmget("h", ["u3", "nope"]) == ["r3", None]
    assert br.hlen("h") == 3
    br.hdel_many("h", ["u1", "u2"])
    br.hdel("h", "u3")
    assert br.hget("h", "u3") is None and br.hlen("h") == 0


def test_claim_stale_and_writeback(m):
    br = m.broker.MemoryBroker()
    for i in range(6):
        br.xadd("s", {"uri": f"u{i}"})
    dead = br.read_group("s", "g", "dead", 4, block_ms=1)
    assert br.pending_count("s", "g") == 4
    assert br.claim_stale("s", "g", "c2", 60_000, 10) == []
    claimed = br.claim_stale("s", "g", "live", 0, 10)
    assert sorted(r for r, _ in claimed) == sorted(r for r, _ in dead)
    assert br.claim_stale("s", "g", "c3", 60_000, 10) == []
    fresh = br.read_group("s", "g", "live", 10, block_ms=1)
    assert len(fresh) == 2
    assert br.writeback("h", {"u0": "r0"}, "s", "g",
                        [r for r, _ in claimed + fresh]) == 1
    assert br.pending_count("s", "g") == 0
    assert br.claim_stale("s", "g", "c4", 0, 10) == []


def test_connect_memory_and_consumer_names(m):
    assert isinstance(m.broker.connect_broker(None), m.broker.MemoryBroker)
    assert isinstance(m.broker.connect_broker("memory"),
                      m.broker.MemoryBroker)
    a, b = m.broker.new_consumer_name(), m.broker.new_consumer_name()
    assert a != b and a.startswith("consumer-")
    with pytest.raises(ValueError):
        m.broker.connect_broker("ftp://x")


def test_partition_routing(m):
    p = m.partitions
    assert p.stream_for("s", "any-uri", 1) == "s"
    assert p.stream_for("s", "u7", 4) == f"s.p{p.partition_of('u7', 4)}"
    assert p.partition_streams("s", 3) == ["s.p0", "s.p1", "s.p2"]
    with pytest.raises(ValueError):
        p.validate_partitions(0)


def test_partition_map_is_the_same_in_both_packages():
    uris = [f"uri-{i}" for i in range(200)]
    assert [jpartitions.partition_of(u, 7) for u in uris] == \
        [tpartitions.partition_of(u, 7) for u in uris]


# ---------------------------------------------------------------------------
# breaker and faults (tests/test_fault_tolerance.py)
# ---------------------------------------------------------------------------
def test_breaker_opens_and_recovers(m):
    b = m.breaker
    rb = b.ResilientBroker(
        m.broker.MemoryBroker(), role=f"t-rec-{id(m)}",
        breaker=b.CircuitBreaker(f"t-rec-{id(m)}", failure_threshold=1,
                                 reset_timeout_s=0.05))
    m.faults.inject("broker.xadd", m.faults.Fault(
        times=1, match=lambda c: c["role"] == rb.role))
    try:
        with pytest.raises(m.faults.FaultError):
            rb.xadd("s", {"uri": "a", "data": {}})
        with pytest.raises(b.CircuitOpenError):
            rb.xadd("s", {"uri": "b", "data": {}})
        time.sleep(0.06)
        rb.xadd("s", {"uri": "c", "data": {}})
        assert rb.breaker.state == b.CLOSED
        assert rb.read_group("s", "g", "c", 10, block_ms=10)
    finally:
        m.faults.clear("broker.xadd")


def test_resp_error_does_not_open_the_circuit(m):
    b = m.breaker

    class Angry(m.broker.MemoryBroker):
        def xadd(self, stream, record):
            raise m.broker.RESPError("ERR wrong arity")

    rb = b.ResilientBroker(Angry(), role="t-resp",
                           breaker=b.CircuitBreaker("t-resp",
                                                    failure_threshold=1))
    with pytest.raises(m.broker.RESPError):
        rb.xadd("s", {})
    assert rb.breaker.state == b.CLOSED


def test_backoff_policy(m):
    p = m.breaker.BackoffPolicy(initial_s=0.1, max_s=1.0, factor=2.0,
                                jitter=0.25)
    for attempt, base in ((1, 0.1), (2, 0.2), (3, 0.4), (10, 1.0)):
        for _ in range(10):
            assert base * 0.75 <= p.delay(attempt) <= base * 1.25
    with pytest.raises(ValueError):
        m.breaker.BackoffPolicy(initial_s=0)


def test_fault_modes_after_times_and_context(m):
    f = m.faults
    with f.injected("x.point", mode="raise", after=1, times=1) as fault:
        f.fire("x.point", a=1)                  # skipped by `after`
        with pytest.raises(f.FaultError):
            f.fire("x.point", a=2)
        f.fire("x.point", a=3)                  # spent by `times`
    assert fault.trips == 1
    assert f.active("x.point") is None
    with pytest.raises(ValueError):
        f.Fault(mode="explode")


# ---------------------------------------------------------------------------
# paged KV (tests/test_paged_decode.py TestKVBlockPool, TestPrefixCache)
# ---------------------------------------------------------------------------
def test_block_pool_alloc_release_refcount_and_gauge(m):
    reg = m.registry.MetricsRegistry()
    pool = m.paged.KVBlockPool(m.init_kv_blocks, num_blocks=5,
                               block_len=BL, registry=reg,
                               labels={"engine": "e1"})

    def gauge():
        (s,) = reg.snapshot()["serving_kv_blocks_in_use"]["series"]
        return s["value"]

    assert pool.capacity == 4 and pool.free_count == 4
    a, b = pool.alloc(), pool.alloc()
    assert 0 not in (a, b) and gauge() == 2 and pool.in_use == 2
    pool.retain(a)
    pool.release(a)
    assert pool.refcount(a) == 1 and gauge() == 2
    pool.release(a)
    assert pool.refcount(a) == 0 and gauge() == 1
    assert [pool.alloc() for _ in range(3)].count(None) == 0
    assert pool.alloc() is None
    pool.release(b)
    with pytest.raises(ValueError):
        pool.release(b)
    assert tuple(pool.kv[0]["k"].shape) == (5, 2, BL, 8)


def test_prefix_cache_adopts_caps_and_evicts(m):
    reg = m.registry.MetricsRegistry()
    pool = m.paged.KVBlockPool(m.init_kv_blocks, num_blocks=10,
                               block_len=BL, registry=reg)
    cache = m.paged.PrefixCache(pool, registry=reg)
    prompt = list(range(20))
    assert cache.match(prompt) == []                 # a miss
    blocks = [pool.alloc(), pool.alloc(), pool.alloc()]
    cache.insert(prompt, blocks[:2])
    free = pool.free_count
    assert cache.match(prompt) == blocks[:2]         # copy-free
    assert pool.free_count == free and pool.refcount(blocks[0]) == 3
    assert len(cache.match(list(range(16)))) == 1    # (16 - 1) // 8
    snap = reg.snapshot()
    (h,) = snap["serving_prefix_cache_hits_total"]["series"]
    (mi,) = snap["serving_prefix_cache_misses_total"]["series"]
    assert h["value"] == 2 and mi["value"] == 1


def test_prefix_cache_evicts_only_sole_owner_leaves(m):
    reg = m.registry.MetricsRegistry()
    pool = m.paged.KVBlockPool(m.init_kv_blocks, num_blocks=4,
                               block_len=BL, registry=reg)
    cache = m.paged.PrefixCache(pool, registry=reg)
    p1, p2 = list(range(9)), list(range(100, 109))
    b1, b2 = pool.alloc(), pool.alloc()
    cache.insert(p1, [b1])
    cache.insert(p2, [b2])
    pool.release(b1)
    pool.release(b2)
    assert cache.match(p1) == [b1]
    assert pool.free_count == 1
    cache.evict_for(2)
    assert pool.free_count == 2 and pool.refcount(b1) == 2


def test_slot_pool_leases_in_order_and_rejects_double_release(m):
    reg = m.registry.MetricsRegistry()
    pool = m.decode.KVSlotPool(m.init_kv, 3, 16, registry=reg)
    assert [pool.lease() for _ in range(3)] == [0, 1, 2]
    assert pool.lease() is None and pool.in_use == 3
    pool.release(1)
    assert pool.free_count == 1
    with pytest.raises(ValueError):
        pool.release(1)
    assert tuple(pool.kv[0]["k"].shape) == (3, 2, 16, 8)


# ---------------------------------------------------------------------------
# DecodeScheduler (tests/test_paged_decode.py TestPagedScheduler)
# ---------------------------------------------------------------------------
def test_paged_plan_budgets_prefilling_before_admissions(m):
    sch = m.decode.DecodeScheduler([16, 64], [8, 16],
                                   registry=m.registry.MetricsRegistry(),
                                   deadline_ms=10.0, chunk_buckets=[8])
    sch.step_cost.observe(16, 2.0)
    sch.prefill_cost.observe(8, 6.0)
    plan = sch.plan_paged_step([8, 8], free_lanes=4,
                               prefilling_remaining=[24],
                               active_lengths=[5], chunk_cap=8)
    assert (plan.chunks, plan.admit, plan.reason) == (1, 0, "deadline")


def test_paged_plan_never_starves_a_chunk(m):
    sch = m.decode.DecodeScheduler([16], [8],
                                   registry=m.registry.MetricsRegistry(),
                                   deadline_ms=1.0, chunk_buckets=[8])
    sch.step_cost.observe(16, 5.0)
    sch.prefill_cost.observe(8, 5.0)
    plan = sch.plan_paged_step([], free_lanes=4,
                               prefilling_remaining=[40, 40],
                               active_lengths=[9], chunk_cap=8)
    assert plan.chunks == 1


def test_plans_without_a_deadline_admit_all(m):
    sch = m.decode.DecodeScheduler([16, 32], [8, 16],
                                   registry=m.registry.MetricsRegistry())
    plan = sch.plan_paged_step([8, 8, 8], free_lanes=2,
                               prefilling_remaining=[], active_lengths=[],
                               chunk_cap=16)
    assert (plan.admit, plan.chunks, plan.reason) == (2, 0, "free-lanes")
    plan = sch.plan_step([3, 20], free_slots=4, active_lengths=[9])
    assert plan.admit == 2 and plan.kv_bucket == 32
    assert sch.prompt_bucket(9) == 16 and sch.kv_bucket_for(100) == 32


def test_contiguous_plan_respects_the_deadline(m):
    sch = m.decode.DecodeScheduler([16], [8, 16],
                                   registry=m.registry.MetricsRegistry(),
                                   deadline_ms=10.0)
    sch.observe_step(16, 3.0)
    sch.observe_prefill(8, 4.0)
    plan = sch.plan_step([5, 5, 5], free_slots=4, active_lengths=[4])
    # budget 10 - 2 - 3 = 5 ms: the first prefill (4 ms) fits, not two
    assert plan.admit == 1 and plan.reason == "deadline"


def test_bucket_cost_model_ewma_and_floor(m):
    cm = m.elastic.BucketCostModel([1, 4, 16],
                                   m.registry.MetricsRegistry(), alpha=0.5)
    assert cm.cost_ms(4) is None
    cm.observe(4, 10.0)
    cm.observe(4, 20.0)
    assert cm.cost_ms(4) == 15.0
    assert cm.cost_ms(16) == 15.0           # nearest smaller known bucket
    cm.seed(1, 8.0)                         # 1/8 below 4/15 records/ms
    assert cm.throughput_optimal(16) == 4
    assert cm.snapshot() == {4: 15.0, 1: 8.0}


def test_pow2_ladder_and_token_rows(m):
    assert m.decode._pow2_ladder(8, 64) == [8, 16, 32, 64]
    assert m.decode._pow2_ladder(3, 100) == [4, 8, 16, 32, 64, 100]
    assert m.decode.token_row_field("u1", 7) == "u1#000007"
