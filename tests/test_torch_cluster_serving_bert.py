"""The Cluster Serving slice as a whole, JAX engine against the port's: a
tiny BERT classifier (2 blocks, hidden 64, 2 heads, seq 16, vocab 100)
whose weights cross JAX → port through `convert.params_from_jax`, served
from a queue by each package's `ClusterServing` over its own
`MiniRedisServer`; the same 24 seeded id records plus one poison record go
through both, pipelined and with ``pipelined=False``. Then the wire both
ways (each package's clients against the other's servers and engine), and
a port engine killed mid-stream whose pending records a second engine
claims. Logits agree per uri within 1e-4 (f32 through two encoder
blocks); the poison uri reads "NaN" in both.
"""

import json
import time

import jax
import numpy as np
import pytest
from torch import nn

from analytics_zoo_tpu.models.bert import BERTClassifier as JClassifier
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from torch_cluster_serving_impls import (  # noqa: F401 (fixtures)
    IMPLS, RESULT_KEY, STREAM, no_stray_threads, wait_for, wait_results)

CFG = dict(vocab=100, hidden_size=64, n_block=2, n_head=2, seq_len=16,
           intermediate_size=128)
NUM_CLASSES = 5
N_RECORDS = 24
TOL = dict(rtol=1e-4, atol=1e-4)
J, T = IMPLS["jax"], IMPLS["port"]


@pytest.fixture(scope="module")
def models():
    """(JAX InferenceModel, port InferenceModel on the CPU), same weights;
    both run the flash-attention path (the port's plain version on the
    CPU, the JAX kernel as its own CPU tests run it)."""
    jm = JClassifier(NUM_CLASSES, use_flash=True, **CFG)
    params = jax.device_get(jm.build(jax.random.PRNGKey(7)))
    tm = BERTClassifier(NUM_CLASSES, use_flash=True, device="cpu", **CFG)
    tm.load_state_dict(convert.params_from_jax(params))
    jim = J.inference_model.InferenceModel(max_batch=8).load_keras(
        jm, params=params)
    tim = T.inference_model.InferenceModel(max_batch=8, device="cpu")
    tim.load_keras(tm)
    sample = np.zeros(CFG["seq_len"], np.int64)
    jim.warmup(sample)
    tim.warmup(sample)
    return jim, tim


def _records(seed=11):
    rs = np.random.RandomState(seed)
    return {f"r{i:02d}": rs.randint(0, CFG["vocab"], CFG["seq_len"]
                                    ).astype(np.int64)
            for i in range(N_RECORDS)}


POISON = {"uri": "poison", "data": {"t": {
    "b64": "%%%not-base64", "dtype": "int64", "shape": [CFG["seq_len"]]}}}


def _serve(pkg, im, records, **kw):
    """Enqueue `records` plus the poison record into a fresh MiniRedis of
    `pkg`, serve them with `pkg`'s engine, return {uri: raw result}."""
    srv = pkg.redis_server.MiniRedisServer().start()
    client = pkg.broker.RedisBroker(srv.host, srv.port)
    engine = pkg.server.ClusterServing(
        im, broker=srv.url, batch_size=8, batch_timeout_ms=5,
        registry=pkg.registry.MetricsRegistry(), **kw)
    try:
        inq = pkg.client.InputQueue(client)
        half = list(records)[:N_RECORDS // 2]
        for uri in half:
            inq.enqueue(uri=uri, t=records[uri])
        client.xadd(STREAM, POISON)
        inq.enqueue_batch([records[u] for u in records if u not in half],
                          uris=[u for u in records if u not in half])
        engine.start()
        want = len(records) + 1
        wait_for(lambda: client.hlen(RESULT_KEY) >= want, timeout_s=60,
                 interval=0.02, msg="every result")
        return client.hgetall(RESULT_KEY), engine
    finally:
        engine.stop()
        client.close()
        srv.stop()


def _decode(raw):
    return T.broker.decode_ndarray(json.loads(raw))


@pytest.mark.parametrize("pipelined", [True, False])
def test_slice_matches_the_jax_engine_per_uri(models, pipelined):
    jim, tim = models
    records = _records()
    jres, _ = _serve(J, jim, records, pipelined=pipelined)
    tres, engine = _serve(T, tim, records, pipelined=pipelined)
    assert set(jres) == set(tres) == set(records) | {"poison"}
    assert jres["poison"] == tres["poison"] == "NaN"
    for uri, ids in records.items():
        got = _decode(tres[uri])
        assert got.shape == (NUM_CLASSES,) and got.dtype == np.float32
        np.testing.assert_allclose(got, _decode(jres[uri]), **TOL)
    # and against the port's own direct forward of the same rows
    direct = tim.predict(np.stack(list(records.values())))
    for i, uri in enumerate(records):
        np.testing.assert_allclose(_decode(tres[uri]), direct[i], **TOL)
    assert engine.records_read == N_RECORDS + 1


def test_top_n_filter_strings(models):
    """topN(2) through both engines: the class indices agree exactly and
    the scores to the logits' tolerance; the port's strings are
    byte-identical to the JAX package's `apply_filter` of the port's own
    logits (same filter, same formatting)."""
    jim, tim = models
    records = _records(seed=12)
    jtop, _ = _serve(J, jim, records, output_filter="topN(2)")
    ttop, _ = _serve(T, tim, records, output_filter="topN(2)")
    traw, _ = _serve(T, tim, records)
    assert jtop["poison"] == ttop["poison"] == "NaN"

    def parse(s):
        rows = [r.split(":") for r in s.strip("[]").split(",")]
        return [int(i) for i, _ in rows], [float(p) for _, p in rows]

    for uri in records:
        ji, jp = parse(jtop[uri])
        ti, tp = parse(ttop[uri])
        assert ti == ji
        np.testing.assert_allclose(tp, jp, **TOL)
        assert ttop[uri] == J.pre_post.apply_filter(_decode(traw[uri]),
                                                    "topN(2)")


@pytest.mark.parametrize("transport", ["redis", "tcp"])
@pytest.mark.parametrize("clients,servers", [(J, T), (T, J)],
                         ids=["jax-clients", "port-clients"])
def test_the_wire_interoperates_both_ways(models, transport, clients,
                                          servers):
    """`clients`' brokers and `InputQueue` / `OutputQueue` against
    `servers`' broker server and engine."""
    jim, tim = models
    im = tim if servers is T else jim
    if transport == "redis":
        srv = servers.redis_server.MiniRedisServer().start()
        conn = clients.broker.RedisBroker(srv.host, srv.port)
        engine_broker = servers.broker.RedisBroker(srv.host, srv.port)
    else:
        srv = servers.broker.TCPBrokerServer().start()
        conn = clients.broker.TCPBroker(srv.host, srv.port)
        engine_broker = servers.broker.TCPBroker(srv.host, srv.port)
    engine = servers.server.ClusterServing(
        im, broker=engine_broker, batch_size=8,
        registry=servers.registry.MetricsRegistry()).start()
    records = _records(seed=13)
    try:
        inq = clients.client.InputQueue(conn)
        uris = list(records)[:6]
        out = inq.predict_batch([records[u] for u in uris], uris=uris,
                                timeout_s=60)
        sess = inq.stream_session()
        more = [sess.submit(records[u], uri=u) for u in list(records)[6:10]]
        streamed = sess.drain(timeout_s=60)
    finally:
        engine.stop()
        for br in (conn, engine_broker):
            if hasattr(br, "close"):
                br.close()
        srv.stop()
    direct = im.predict(np.stack([records[u] for u in uris + more]))
    for i, y in enumerate(list(out) + [streamed[u] for u in more]):
        assert y.dtype == np.float32
        np.testing.assert_allclose(y, direct[i], **TOL)


def test_killed_engine_records_are_claimed_and_answered_once():
    """A port engine is killed with records in its pending list; a second
    port engine claims them after `claim_min_idle_s` and every uri is
    answered exactly once."""
    def slow_double(p, x):
        time.sleep(0.05)
        return x * 2.0

    srv = T.redis_server.MiniRedisServer().start()
    conns = [T.broker.RedisBroker(srv.host, srv.port) for _ in range(3)]
    regs = [T.registry.MetricsRegistry() for _ in range(2)]
    ims = [T.inference_model.InferenceModel(device="cpu").load_fn(
        slow_double, nn.Module()) for _ in range(2)]
    kw = dict(batch_size=4, batch_timeout_ms=2, claim_min_idle_s=0.2,
              claim_interval_s=0.1, heartbeat_interval_s=0,
              fleet_metrics_interval_s=0)
    a = T.server.ClusterServing(ims[0], conns[0], engine_id="a",
                                registry=regs[0], **kw)
    b = T.server.ClusterServing(ims[1], conns[1], engine_id="b",
                                registry=regs[1], **kw)
    n = 40
    try:
        inq = T.client.InputQueue(conns[2])
        xs = {f"k{i:02d}": np.full(3, float(i), np.float32)
              for i in range(n)}
        inq.enqueue_batch(list(xs.values()), uris=list(xs))
        a.start()
        wait_for(lambda: a.records_served >= 4 and a.records_read
                 > a.records_served, timeout_s=30, interval=0.01,
                 msg="engine a mid-stream")
        a.kill()
        assert not a.is_alive()
        pending = conns[2].pending_count(STREAM, T.server.GROUP)
        assert pending > 0, "the kill left nothing in flight"
        b.start()
        res = wait_results(T, conns[2], list(xs), timeout_s=60)
        wait_for(lambda: a.records_served + b.records_served >= n,
                 timeout_s=10, msg="served counters")
    finally:
        b.stop()
        for c in conns:
            c.close()
        srv.stop()
    assert len(res) == n
    for uri, x in xs.items():
        np.testing.assert_allclose(res[uri], 2.0 * x)
    assert a.records_served + b.records_served == n
    assert b.metrics()["claimed_records"] >= pending
    dup = regs[1].get("serving_records_total").value(outcome="duplicate",
                                                     engine="b")
    assert dup == 0
