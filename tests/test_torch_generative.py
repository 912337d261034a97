"""The port's generative decode slice held against the JAX package on the
CPU: `models/generative.TinyDecoder`'s four programs, greedy decoding, and
the `DecodeServing` engine (contiguous and paged) over a `MemoryBroker`,
at the sizes of tests/test_paged_decode.py (vocab 32, 2 layers, 2 heads,
head dim 8, max_len 64, block_len 8).

Tolerances: logits and KV pools at 1e-5 absolute against the JAX programs
(the same f32 operations summed by another library, on logits of
magnitude ~5); token streams exactly equal. Within the port the paged
engine's streams equal the contiguous engine's, and a crash-resumed decode
equals an uninterrupted one, token for token, as the JAX package pins
within itself (tests/test_paged_decode.py, tests/test_decode_recovery.py).
The CUDA kernels have no CPU mode: here the decode steps take their plain
versions (the wrappers route CPU tensors there).
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.generative import TinyDecoder as JDecoder
from analytics_zoo_tpu.observability.registry import \
    MetricsRegistry as JRegistry
from analytics_zoo_tpu.serving.broker import MemoryBroker as JBroker
from analytics_zoo_tpu.serving.client import InputQueue as JInputQueue
from analytics_zoo_tpu.serving.client import OutputQueue as JOutputQueue
from analytics_zoo_tpu.serving.decode import DecodeServing as JServing
from analytics_zoo_tpu.serving.inference_model import \
    InferenceModel as JModel
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build
from analytics_zoo_tpu_torch.models.generative import TinyDecoder
from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry
from analytics_zoo_tpu_torch.serving.broker import (MemoryBroker,
                                                    encode_ndarray)
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.decode import (GROUP, STREAM,
                                                    DecodeServing,
                                                    token_row_field)
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel

TINY = dict(vocab=32, n_layers=2, n_heads=2, head_dim=8, max_len=64)
BL = 8
MAX_KV = 64
KV_BUCKETS = [16, 32, 64]
PROMPT_BUCKETS = [8, 16]
LANES = 3
KV_BLOCKS = 13    # 12 usable + scratch (tests/test_decode_recovery.py)
RESULT_KEY = f"result:{STREAM}"
TOL = 1e-5
# the prompts of tests/test_paged_decode.py:252-253
PROMPTS = [[3, 5, 7], [2, 4, 6, 8, 10, 12],
           [1, 9, 11, 13, 3, 2, 7, 8, 9, 4], [21] * 14]


def tdec(**kw):
    return TinyDecoder(**dict(TINY, device="cpu"), **kw)


def jdec(**kw):
    return JDecoder(**TINY, **kw)


@pytest.fixture(scope="module")
def params():
    tree = jdec().init_params(0)
    return tree, convert.generative_params_from_jax(tree, "cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _kv_np(kv):
    return convert.kv_to_jax(kv)


def _assert_kv_close(port_kv, jax_kv):
    for p, j in zip(_kv_np(port_kv), jax_kv):
        for name in ("k", "v"):
            np.testing.assert_allclose(p[name], np.asarray(j[name]),
                                       rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# the model programs
# ---------------------------------------------------------------------------
def test_init_params_draws_the_jax_packages_weights():
    a, b = jdec().init_params(3), tdec().init_params(3)
    flat_a = convert.generative_params_from_jax(a, "cpu")
    flat_b = convert.generative_params_from_jax(b, "cpu")
    assert set(flat_a) == set(flat_b)
    for key in ("embed", "pos", "head", "lnf_g"):
        assert torch.equal(flat_a[key], flat_b[key])
    for la, lb in zip(flat_a["layers"], flat_b["layers"]):
        assert all(torch.equal(la[k], lb[k]) for k in la)


def test_params_and_kv_convert_both_ways(params):
    tree, port = params
    back = convert.generative_params_to_jax(port)
    np.testing.assert_array_equal(back["layers"][1]["w2"],
                                  tree["layers"][1]["w2"])
    kv = [{"k": np.full((2, 2, 4, 8), i, np.float32),
           "v": np.full((2, 2, 4, 8), -i, np.float32)} for i in range(2)]
    round_trip = convert.kv_to_jax(convert.kv_from_jax(kv, "cpu"))
    for a, b in zip(kv, round_trip):
        np.testing.assert_array_equal(a["k"], b["k"])
        np.testing.assert_array_equal(a["v"], b["v"])


@pytest.mark.parametrize("P, length, slot", [(8, 3, 1), (16, 16, 0),
                                             (8, 1, 3), (16, 9, 9)])
def test_prefill_matches_jax(params, P, length, slot):
    """Logits at the last real position and the pool rows it writes; a
    slot past the pool clamps as dynamic_update_slice does."""
    tree, port = params
    tokens = (np.arange(P, dtype=np.int32) * 5 + 3) % 32
    j, t = jdec(), tdec()
    jkv, jl = j.prefill_fn(tree, j.init_kv(4, MAX_KV), jnp.asarray(tokens),
                           jnp.int32(length), jnp.int32(slot))
    tkv, tl = t.prefill_fn(port, t.init_kv(4, MAX_KV), tokens, length, slot)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=TOL)
    _assert_kv_close(tkv, jkv)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("kv_bucket", [16, 32, 64])
def test_step_matches_jax(params, use_pallas, kv_bucket):
    tree, port = params
    j, t = jdec(use_pallas=use_pallas), tdec(use_pallas=use_pallas)
    rs = np.random.RandomState(kv_bucket)
    kv0 = [{"k": rs.standard_normal((4, 2, MAX_KV, 8)).astype(np.float32),
            "v": rs.standard_normal((4, 2, MAX_KV, 8)).astype(np.float32)}
           for _ in range(2)]
    tokens = np.asarray([5, 0, 31, 7], np.int32)
    positions = np.asarray([kv_bucket - 1, 0, kv_bucket // 2, 3], np.int32)
    jkv, jl = j.step_fn(tree, [{k: jnp.asarray(v) for k, v in d.items()}
                               for d in kv0],
                        jnp.asarray(tokens), jnp.asarray(positions),
                        kv_bucket)
    tkv, tl = t.step_fn(port, convert.kv_from_jax(kv0, "cpu"), tokens,
                        positions, kv_bucket)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=TOL)
    _assert_kv_close(tkv, jkv)


def _block_pool(rs, num_blocks=12):
    return [{"k": rs.standard_normal((num_blocks, 2, BL, 8))
             .astype(np.float32),
             "v": rs.standard_normal((num_blocks, 2, BL, 8))
             .astype(np.float32)} for _ in range(2)]


@pytest.mark.parametrize("Cb, pre_len, chunk_len, kv_bucket", [
    (16, 0, 11, 0),       # fresh first chunk, padded
    (8, 0, 8, 0),         # fresh, full
    (8, 16, 5, 16),       # a chunk after a 16-token context, padded
    (16, 24, 16, 32),     # a full chunk after a 24-token context
    (16, 40, 3, 64)])     # a padded chunk near the pool's end
def test_paged_prefill_matches_jax(params, Cb, pre_len, chunk_len,
                                   kv_bucket):
    """Logits and the whole block pool: a padded chunk writes exactly the
    real rows (JAX drops the pad rows' out-of-bounds scatter), so every
    other block keeps its bytes."""
    tree, port = params
    rs = np.random.RandomState(Cb + pre_len)
    kv0 = _block_pool(rs)
    table = np.asarray([3, 7, 1, 9, 4, 11, 2, 5], np.int32)
    tokens = rs.randint(0, 32, Cb).astype(np.int32)
    j, t = jdec(), tdec()
    jkv, jl = j.paged_prefill_fn(
        tree, [{k: jnp.asarray(v) for k, v in d.items()} for d in kv0],
        jnp.asarray(tokens), jnp.asarray(table), pre_len, chunk_len,
        kv_bucket)
    tkv, tl = t.paged_prefill_fn(port, convert.kv_from_jax(kv0, "cpu"),
                                 tokens, table, pre_len, chunk_len,
                                 kv_bucket)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=TOL)
    _assert_kv_close(tkv, jkv)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("kv_bucket", [16, 64])
def test_paged_step_matches_jax(params, use_pallas, kv_bucket):
    tree, port = params
    rs = np.random.RandomState(kv_bucket + 1)
    kv0 = _block_pool(rs)
    tables = np.asarray([[3, 7, 1, 9, 4, 11, 2, 5],
                         [0] * 8,                      # a dead lane
                         [6, 8, 10, 0, 0, 0, 0, 0]], np.int32)
    tokens = np.asarray([4, 0, 19], np.int32)
    positions = np.asarray([kv_bucket - 1, 0, 20], np.int32)
    j, t = jdec(use_pallas=use_pallas), tdec(use_pallas=use_pallas)
    jkv, jl = j.paged_step_fn(
        tree, [{k: jnp.asarray(v) for k, v in d.items()} for d in kv0],
        jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(tables),
        kv_bucket)
    tkv, tl = t.paged_step_fn(port, convert.kv_from_jax(kv0, "cpu"),
                              tokens, positions, tables, kv_bucket)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=TOL)
    _assert_kv_close(tkv, jkv)


def test_fresh_paged_prefill_is_bitwise_the_contiguous_prefill(params):
    """The kv_bucket == 0 branch is op for op `prefill_fn`: the same
    first-token logits, bit for bit (the paged-parity anchor)."""
    _, port = params
    t = tdec()
    tokens = np.asarray([3, 5, 7, 9, 11, 0, 0, 0], np.int32)
    _, a = t.prefill_fn(port, t.init_kv(2, MAX_KV), tokens, 5, 0)
    table = np.asarray([1, 2, 3, 4, 5, 6, 7, 8], np.int32)
    _, b = t.paged_prefill_fn(port, t.init_kv_blocks(9, BL), tokens, table,
                              0, 5, 0)
    assert torch.equal(a, b)


def test_greedy_tokens_over_16_steps_match_jax(params):
    tree, port = params
    prompt = np.asarray([4, 9, 2, 7, 1], np.int32)
    padded = np.zeros(8, np.int32)
    padded[:5] = prompt
    j, t = jdec(), tdec()
    jkv = j.init_kv(2, MAX_KV)
    tkv = t.init_kv(2, MAX_KV)
    jkv, jl = j.prefill_fn(tree, jkv, jnp.asarray(padded), jnp.int32(5),
                           jnp.int32(1))
    tkv, tl = t.prefill_fn(port, tkv, padded, 5, 1)
    jt, tt = [int(np.argmax(np.asarray(jl)))], [int(torch.argmax(tl))]
    for i in range(16):
        pos = 5 + i
        bucket = next(b for b in KV_BUCKETS if b >= pos + 1)
        jkv, jl = j.step_fn(tree, jkv, jnp.asarray([0, jt[-1]], jnp.int32),
                            jnp.asarray([0, pos], jnp.int32), bucket)
        tkv, tl = t.step_fn(port, tkv, np.asarray([0, tt[-1]], np.int32),
                            np.asarray([0, pos], np.int32), bucket)
        jt.append(int(np.argmax(np.asarray(jl)[1])))
        tt.append(int(torch.argmax(tl[1])))
    assert tt == jt and len(tt) == 17


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: cuda is the default here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TinyDecoder(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceModel()


def test_decode_engine_heartbeat_row():
    """`heartbeat_interval_s` starts the fleet's heartbeat publisher on the
    decode engine (once refused by the port): a row with the JAX engine's
    fields in `engines:<stream>`, deregistered by a clean stop."""
    rows = {}
    for name, (engine_cls, broker, dec, registry, im) in {
            "jax": (JServing, JBroker(), jdec(), JRegistry(),
                    JModel()),
            "port": (DecodeServing, MemoryBroker(), tdec(),
                     MetricsRegistry(),
                     InferenceModel(device="cpu"))}.items():
        eng = engine_cls(im, dec.init_kv, broker=broker, registry=registry,
                         engine_id=f"dec-{name}", heartbeat_interval_s=0.05)
        eng.start()
        key = f"engines:{STREAM}"
        try:
            deadline = time.monotonic() + 20
            while broker.hget(key, f"dec-{name}") is None and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            rows[name] = json.loads(broker.hget(key, f"dec-{name}"))
        finally:
            eng.stop(drain=False)
        assert broker.hget(key, f"dec-{name}") is None
    assert rows["port"]["role"] == "decode" and rows["port"]["ready"]
    assert sorted(rows["port"]) == sorted(rows["jax"])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def load_port(dec, paged=True):
    im = InferenceModel(device="cpu")
    return im.load_generative(
        dec.prefill_fn, dec.step_fn, dec.init_params(0),
        paged_prefill_fn=dec.paged_prefill_fn if paged else None,
        paged_step_fn=dec.paged_step_fn if paged else None)


def load_jax(dec):
    im = JModel(placement="replicated", num_replicas=1)
    return im.load_generative(dec.prefill_fn, dec.step_fn,
                              dec.init_params(0),
                              paged_prefill_fn=dec.paged_prefill_fn,
                              paged_step_fn=dec.paged_step_fn)


def make_engine(dec, im, broker, paged, serving=DecodeServing,
                registry=MetricsRegistry, **kw):
    """One pre-warmed engine (tests/test_paged_decode.py `make_engine`):
    contiguous and paged engines share the bucket ladders."""
    kw.setdefault("slots", 4)
    kw.setdefault("max_kv_len", MAX_KV)
    kw.setdefault("kv_buckets", KV_BUCKETS)
    kw.setdefault("prompt_buckets", PROMPT_BUCKETS)
    kw.setdefault("max_new_default", 6)
    if paged:
        table_len = kw["max_kv_len"] // BL
        kv_blocks = kw.pop("kv_blocks", None) or \
            kw["slots"] * table_len + 1
        chunk = kw.get("prefill_chunk")
        chunk_buckets = [b for b in kw["prompt_buckets"]
                         if chunk is None or b <= chunk] \
            or [kw["prompt_buckets"][0]]
        im.warmup_generative_paged(
            dec.init_kv_blocks, num_blocks=kv_blocks, block_len=BL,
            lanes=kw["slots"], table_len=table_len,
            chunk_buckets=chunk_buckets, kv_buckets=kw["kv_buckets"])
        return serving(im, dec.init_kv, broker=broker, registry=registry(),
                       paged=True, init_kv_blocks=dec.init_kv_blocks,
                       block_len=BL, kv_blocks=kv_blocks, **kw)
    im.warmup_generative(dec.init_kv, slots=kw["slots"],
                         max_kv_len=kw["max_kv_len"],
                         prompt_buckets=kw["prompt_buckets"],
                         kv_buckets=kw["kv_buckets"])
    return serving(im, dec.init_kv, broker=broker, registry=registry(), **kw)


def collect(outq, uris, timeout_s=20.0):
    out, deadline = {}, time.monotonic() + timeout_s
    while len(out) < len(uris):
        assert time.monotonic() < deadline, \
            f"missing {set(uris) - set(out)}"
        out.update(outq.query_many([u for u in uris if u not in out]))
        time.sleep(0.002)
    return {u: [int(x) for x in np.asarray(v).reshape(-1)]
            for u, v in out.items()}


def run_inline(srv, inq, outq, prompts, max_new=8):
    """Enqueue every prompt, then step the engine in this thread until it
    drains; the streams in prompt order."""
    uris = [inq.enqueue(t=np.asarray(p, np.int32), max_new=max_new)
            for p in prompts]
    srv._intake()
    step = srv._run_paged_step if srv.paged else srv._run_step
    while srv._active or srv._waiting or srv._prefilling:
        step()
    got = collect(outq, uris, timeout_s=5.0)
    return [got[u] for u in uris]


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX engines' streams for PROMPTS, contiguous and paged."""
    out = {}
    for paged in (False, True):
        dec = jdec()
        broker = JBroker()
        srv = make_engine(dec, load_jax(dec), broker, paged,
                          serving=JServing, registry=JRegistry,
                          max_new_default=8)
        out[paged] = run_inline(srv, JInputQueue(broker),
                                JOutputQueue(broker), PROMPTS)
    assert out[False] == out[True]      # the JAX package's own parity
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_engine_streams_match_the_jax_engine(jax_streams, paged):
    dec = tdec()
    broker = MemoryBroker()
    srv = make_engine(dec, load_port(dec), broker, paged, max_new_default=8)
    got = run_inline(srv, InputQueue(broker), OutputQueue(broker), PROMPTS)
    assert got == jax_streams[paged]
    assert all(len(s) == 8 for s in got)


def test_threaded_engines_paged_equals_contiguous():
    """The live engines (their own threads) over the same prompts with a
    mid-flight join (tests/test_paged_decode.py:246)."""
    dec = tdec()
    streams = {}
    for paged in (False, True):
        broker = MemoryBroker()
        srv = make_engine(dec, load_port(dec), broker, paged,
                          max_new_default=8)
        inq, outq = InputQueue(broker), OutputQueue(broker)
        srv.start()
        try:
            uris = [inq.enqueue(t=np.asarray(p, np.int32), max_new=8)
                    for p in PROMPTS[:2]]
            deadline = time.monotonic() + 10
            while srv.stats["prefills"] < 2:
                assert time.monotonic() < deadline
                time.sleep(0.002)
            uris += [inq.enqueue(t=np.asarray(p, np.int32), max_new=8)
                     for p in PROMPTS[2:]]
            got = collect(outq, uris)
            streams[paged] = [got[u] for u in uris]
        finally:
            srv.stop()
        assert not srv.is_alive()
    assert streams[False] == streams[True]


def test_prefix_cache_hit_mid_flight_keeps_parity():
    """A prompt that adopts cached prefix blocks while another sequence
    decodes emits the contiguous engine's tokens (test_paged_decode.py
    `test_prefix_cache_hit_mid_flight_keeps_parity`)."""
    dec = tdec()
    shared = [5, 3, 8, 2, 9, 1, 4, 7]
    tail_a, tail_b = shared + [11, 12], shared + [13, 14, 15, 16]
    broker = MemoryBroker()
    srv = make_engine(dec, load_port(dec, paged=False), broker, False,
                      max_new_default=8)
    cold = run_inline(srv, InputQueue(broker), OutputQueue(broker),
                      [tail_a, tail_b])
    broker = MemoryBroker()
    srv = make_engine(dec, load_port(dec), broker, True, max_new_default=8)
    inq, outq = InputQueue(broker), OutputQueue(broker)
    filler = inq.enqueue(t=np.asarray([17] * 12, np.int32), max_new=16)
    ua = inq.enqueue(t=np.asarray(tail_a, np.int32), max_new=8)
    srv._intake()
    while srv.stats["finished"] < 1 or srv._waiting:
        srv._run_paged_step()
    got_a = collect(outq, [ua])[ua]
    ub = inq.enqueue(t=np.asarray(tail_b, np.int32), max_new=8)
    srv._intake()
    while srv._active or srv._waiting or srv._prefilling:
        srv._run_paged_step()
    got_b = collect(outq, [ub])[ub]
    collect(outq, [filler])
    assert srv.stats["prefix_hit_tokens"] >= len(shared)
    assert [got_a, got_b] == cold


def _drive_chunked(prefill_chunk):
    """tests/test_paged_decode.py `TestChunkedPrefill._drive`: a short
    sequence decodes while a 48-token prompt joins."""
    dec = tdec()
    broker = MemoryBroker()
    srv = make_engine(dec, load_port(dec), broker, True,
                      prompt_buckets=[8, 16, 64],
                      prefill_chunk=prefill_chunk, max_new_default=24)
    inq, outq = InputQueue(broker), OutputQueue(broker)
    u_short = inq.enqueue(t=np.asarray([4, 2, 6], np.int32), max_new=24)
    srv._intake()
    srv._run_paged_step()
    assert len(srv._active) == 1
    u_long = inq.enqueue(t=np.asarray(np.arange(48) % 30 + 1, np.int32),
                         max_new=4)
    srv._intake()
    iters, short_tokens = 0, 0
    chunks0 = srv.stats["prefill_chunks"]
    while srv.stats["prefills"] < 2:
        before = sum(len(s.gen) for s in srv._active.values()
                     if s.uri == u_short)
        srv._run_paged_step()
        after = sum(len(s.gen) for s in srv._active.values()
                    if s.uri == u_short)
        short_tokens += max(0, after - before)
        iters += 1
        assert iters < 50
    chunks = srv.stats["prefill_chunks"] - chunks0
    while srv._active or srv._waiting or srv._prefilling:
        srv._run_paged_step()
    out = collect(outq, [u_short, u_long], timeout_s=5.0)
    return iters, short_tokens, chunks, out


def test_chunked_prefill_interleaves_decode_and_keeps_tokens():
    iters_on, short_on, chunks_on, out_on = _drive_chunked(16)
    assert chunks_on == 3 and iters_on >= 3 and short_on >= 2
    iters_off, _, chunks_off, out_off = _drive_chunked(None)
    assert chunks_off == 1 and iters_off == 1
    assert sorted(map(tuple, out_on.values())) == \
        sorted(map(tuple, out_off.values()))


def test_warmup_runs_every_program_and_reports_it():
    dec = tdec()
    im = load_port(dec)
    im.warmup_generative(dec.init_kv, slots=2, max_kv_len=MAX_KV,
                         prompt_buckets=PROMPT_BUCKETS,
                         kv_buckets=KV_BUCKETS)
    im.warmup_generative_paged(dec.init_kv_blocks, num_blocks=9,
                               block_len=BL, lanes=2, table_len=8,
                               chunk_buckets=[8], kv_buckets=[16, 64])
    assert set(im.warmup_report) == {
        "gen-prefill:p8", "gen-prefill:p16", "gen-step:kv16",
        "gen-step:kv32", "gen-step:kv64", "gen-paged-prefill:c8:kv0",
        "gen-paged-prefill:c8:kv16", "gen-paged-prefill:c8:kv64",
        "gen-paged-step:kv16", "gen-paged-step:kv64"}
    with pytest.raises(ValueError):
        im.warmup_generative(dec.init_kv, 2, MAX_KV, [8], [128])
    with pytest.raises(RuntimeError):
        InferenceModel(device="cpu").warmup_generative(
            dec.init_kv, 2, MAX_KV, [8], [16])


def test_cpu_engine_launches_no_kernel_and_builds_nothing():
    dec = tdec()
    broker = MemoryBroker()
    srv = make_engine(dec, load_port(dec), broker, True)
    before, builds = LAUNCHES.snapshot(), _build.build_events()
    run_inline(srv, InputQueue(broker), OutputQueue(broker), PROMPTS[:2])
    assert LAUNCHES.snapshot() == before
    assert _build.build_events() == builds


# ---------------------------------------------------------------------------
# crash safety (tests/test_decode_recovery.py on a MemoryBroker)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def paged_env():
    dec = tdec()
    im = load_port(dec)
    im.warmup_generative_paged(
        dec.init_kv_blocks, num_blocks=KV_BLOCKS, block_len=BL,
        lanes=LANES, table_len=MAX_KV // BL,
        chunk_buckets=PROMPT_BUCKETS, kv_buckets=KV_BUCKETS)
    return dec, im


@pytest.fixture(scope="module")
def contig_env():
    dec = tdec()
    im = load_port(dec, paged=False)
    im.warmup_generative(dec.init_kv, slots=2, max_kv_len=MAX_KV,
                         prompt_buckets=PROMPT_BUCKETS,
                         kv_buckets=KV_BUCKETS)
    return dec, im


def paged_engine(dec, im, broker, **kw):
    kw.setdefault("slots", LANES)
    kw.setdefault("max_kv_len", MAX_KV)
    kw.setdefault("kv_buckets", KV_BUCKETS)
    kw.setdefault("prompt_buckets", PROMPT_BUCKETS)
    kw.setdefault("max_new_default", 6)
    kw.setdefault("idle_block_ms", 1)
    return DecodeServing(im, dec.init_kv, broker=broker,
                         registry=MetricsRegistry(), paged=True,
                         init_kv_blocks=dec.init_kv_blocks, block_len=BL,
                         kv_blocks=KV_BLOCKS, **kw)


def contig_engine(dec, im, broker, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_kv_len", MAX_KV)
    kw.setdefault("kv_buckets", KV_BUCKETS)
    kw.setdefault("prompt_buckets", PROMPT_BUCKETS)
    kw.setdefault("max_new_default", 6)
    kw.setdefault("idle_block_ms", 1)
    return DecodeServing(im, dec.init_kv, broker=broker,
                         registry=MetricsRegistry(), **kw)


def drive(srv, until, max_iters=400):
    """The engine loop inline: watchdog -> intake -> step, as `run()`."""
    step = srv._run_paged_step if srv.paged else srv._run_step
    for _ in range(max_iters):
        srv._watchdog()
        srv._intake()
        step()
        if srv._pending:
            srv._flush_pending()
        if until():
            return
    raise AssertionError(f"engine did not converge: {srv.stats}")


def reference_run(make, dec, im, jobs):
    """Each job decoded alone on a fresh engine: the uninterrupted run."""
    out = []
    for prompt, max_new in jobs:
        broker = MemoryBroker()
        srv = make(dec, im, broker)
        uri = InputQueue(broker).enqueue(t=prompt, max_new=max_new,
                                         stream=1)
        drive(srv, until=lambda: srv.stats["finished"] >= 1)
        out.append(collect(OutputQueue(broker), [uri])[uri])
    return out


def counter_value(reg, name, **labels):
    for s in reg.snapshot().get(name, {}).get("series", []):
        if all(s.get("labels", {}).get(k) == v for k, v in labels.items()):
            return s["value"]
    return 0.0


def test_paged_resume_is_bitwise_and_reemits_nothing(paged_env):
    dec, im = paged_env
    prompt = (np.arange(8, dtype=np.int32) % 29) + 1
    (expected,) = reference_run(paged_engine, dec, im, [(prompt, 10)])
    broker = MemoryBroker()
    e1 = paged_engine(dec, im, broker, engine_id="e1")
    uri = InputQueue(broker).enqueue(t=prompt, max_new=10, stream=1)
    e1._intake()
    for _ in range(4):
        e1._run_paged_step()
    k = e1.stats["tokens"]
    assert 0 < k < 10
    rows_before = broker.hmget(RESULT_KEY, [token_row_field(uri, i)
                                            for i in range(k)])
    assert all(r is not None for r in rows_before)
    assert broker.hmget(RESULT_KEY, [uri]) == [None]
    time.sleep(0.08)
    e2 = paged_engine(dec, im, broker, engine_id="e2",
                      claim_min_idle_s=0.05, claim_interval_s=0.0)
    drive(e2, until=lambda: e2.stats["finished"] >= 1)
    assert e2.stats["resumed"] == 1 and e2.stats["recovered_tokens"] == k
    assert e2.stats["tokens"] == 10 - k
    assert counter_value(e2.registry, "serving_decode_resumes_total",
                         engine="e2") == 1
    assert collect(OutputQueue(broker), [uri])[uri] == expected
    rows_after = broker.hmget(RESULT_KEY, [token_row_field(uri, i)
                                           for i in range(10)])
    assert rows_after[:k] == rows_before
    assert all(r is not None for r in rows_after)
    gen = json.loads(broker.hmget(RESULT_KEY, [uri])[0])["gen"]
    assert gen["n"] == 10 and gen["rows"] == 10 and gen["finish"] == "length"
    assert broker.pending_count(STREAM, GROUP) == 0


def test_contiguous_resume_replays_from_scratch(contig_env):
    dec, im = contig_env
    prompt = (np.arange(8, dtype=np.int32) % 23) + 2
    (expected,) = reference_run(contig_engine, dec, im, [(prompt, 12)])
    broker = MemoryBroker()
    e1 = contig_engine(dec, im, broker, engine_id="c1")
    uri = InputQueue(broker).enqueue(t=prompt, max_new=12, stream=1)
    e1._intake()
    for _ in range(9):
        e1._run_step()
    k = e1.stats["tokens"]
    assert k == 10                     # ctx 8 + 10 = 18 > ladder 16
    rows_before = broker.hmget(RESULT_KEY, [token_row_field(uri, i)
                                            for i in range(k)])
    time.sleep(0.08)
    e2 = contig_engine(dec, im, broker, engine_id="c2",
                       claim_min_idle_s=0.05, claim_interval_s=0.0)
    drive(e2, until=lambda: e2.stats["finished"] >= 1)
    assert e2.stats["resumed"] == 1 and e2.stats["replayed_tokens"] == k
    assert e2.stats["tokens"] == 12 - k
    assert collect(OutputQueue(broker), [uri])[uri] == expected
    rows_after = broker.hmget(RESULT_KEY, [token_row_field(uri, i)
                                           for i in range(12)])
    assert rows_after[:k] == rows_before
    assert all(r is not None for r in rows_after)


def test_final_present_counts_a_duplicate(paged_env):
    dec, im = paged_env
    broker = MemoryBroker()
    uri = InputQueue(broker).enqueue(t=np.asarray([4, 5, 6], np.int32),
                                     max_new=3, stream=1)
    assert len(broker.read_group(STREAM, GROUP, "dead-peer", 10,
                                 block_ms=0)) == 1
    blob = encode_ndarray(np.asarray([7, 8, 9], np.int32))
    blob["gen"] = {"n": 3, "rows": 3, "finish": "length", "ttft_ms": 1.0}
    broker.hset_many(RESULT_KEY, {uri: json.dumps(blob)})
    before = dict(broker.hgetall(RESULT_KEY))
    srv = paged_engine(dec, im, broker, claim_min_idle_s=0.0,
                       claim_interval_s=0.0)
    time.sleep(0.005)
    srv._claim_sweep()
    srv._flush_pending()
    assert srv.stats["duplicates"] == 1 and srv.stats["finished"] == 0
    assert broker.hgetall(RESULT_KEY) == before
    assert broker.pending_count(STREAM, GROUP) == 0


def test_preemption_completes_every_sequence_bitwise(paged_env):
    """Three 36-token contexts need 15 blocks against 12 usable
    (test_decode_recovery.py:345)."""
    dec, im = paged_env
    jobs = [((np.arange(8, dtype=np.int32) % 13) + 1 + 2 * j, 28)
            for j in range(3)]
    expected = reference_run(paged_engine, dec, im, jobs)
    broker = MemoryBroker()
    srv = paged_engine(dec, im, broker, engine_id="pp")
    inq = InputQueue(broker)
    uris = [inq.enqueue(t=p, max_new=n, stream=1) for p, n in jobs]
    drive(srv, until=lambda: srv.stats["finished"] >= 3)
    got = collect(OutputQueue(broker), uris)
    assert [got[u] for u in uris] == expected
    assert srv.stats["aborted"] == 0 and srv.stats["preempted"] >= 1
    assert srv.stats["preempted"] <= 3 * srv.preempt_max
    assert srv.stats["prefix_hit_tokens"] > 0


def test_blocks_full_abort_answers_a_correct_prefix(paged_env):
    dec, im = paged_env
    prompt = np.asarray([5, 3, 5, 3, 5, 3, 5, 3], np.int32)
    (expected,) = reference_run(paged_engine, dec, im, [(prompt, 20)])
    broker = MemoryBroker()
    srv = paged_engine(dec, im, broker)
    held = []
    while srv.block_pool.free_count > 2:
        held.append(srv.block_pool.alloc())
    uri = InputQueue(broker).enqueue(t=prompt, max_new=20, stream=1)
    drive(srv, until=lambda: srv.stats["finished"] >= 1
          or srv.stats["aborted"] >= 1, max_iters=100)
    assert srv.stats["aborted"] == 1
    final = json.loads(broker.hmget(RESULT_KEY, [uri])[0])
    assert final["gen"]["finish"] == "blocks-full"
    n = final["gen"]["n"]
    assert 0 < n < 20
    got = [int(x) for x in np.asarray(OutputQueue(broker).query(uri))]
    assert got == expected[:n]
    for b in held:
        srv.block_pool.release(b)


def test_watchdog_aborts_with_nan_and_releases_the_lane(paged_env):
    dec, im = paged_env
    broker = MemoryBroker()
    srv = paged_engine(dec, im, broker, max_seq_wall_s=0.05)
    uri = InputQueue(broker).enqueue(t=np.asarray([9, 8, 7], np.int32),
                                     max_new=40, stream=1)
    srv._intake()
    srv._run_paged_step()
    assert srv._active
    time.sleep(0.06)
    srv._watchdog()
    assert srv.stats["aborted"] == 1 and not srv._active
    assert len(srv._free_lanes) == LANES
    assert broker.hmget(RESULT_KEY, [uri]) == ["NaN"]
    r = OutputQueue(broker).query(uri)
    assert isinstance(r, float) and np.isnan(r)


def test_writeback_outage_buffers_rows_and_drains(paged_env):
    dec, im = paged_env
    prompt = np.asarray([7, 7, 2, 2], np.int32)
    (expected,) = reference_run(paged_engine, dec, im, [(prompt, 10)])
    broker = MemoryBroker()
    srv = paged_engine(dec, im, broker)
    uri = InputQueue(broker).enqueue(t=prompt, max_new=10, stream=1)
    srv._intake()
    with faults.injected("decode.writeback", mode="raise") as fault:
        for _ in range(4):
            srv._run_paged_step()
        assert fault.trips == 4
        assert srv.stats["tokens"] >= 5 and srv._pending
        assert broker.hmget(RESULT_KEY,
                            [token_row_field(uri, 0)]) == [None]
    drive(srv, until=lambda: srv.stats["finished"] >= 1)
    assert srv.stats["rows_shed"] == 0
    assert collect(OutputQueue(broker), [uri])[uri] == expected
    assert broker.pending_count(STREAM, GROUP) == 0


def test_step_fault_point_fires(paged_env):
    dec, im = paged_env
    broker = MemoryBroker()
    srv = paged_engine(dec, im, broker)
    InputQueue(broker).enqueue(t=np.asarray([1, 2, 3], np.int32),
                               max_new=4)
    srv._intake()
    with faults.injected("decode.prefill", mode="stall",
                         delay_s=0.0) as pre, \
            faults.injected("decode.step", mode="stall",
                            delay_s=0.0) as step:
        srv._run_paged_step()
    assert pre.trips == 1 and step.trips == 1


def test_stream_tokens_yields_every_row_then_done(paged_env):
    dec, im = paged_env
    broker = MemoryBroker()
    srv = paged_engine(dec, im, broker, max_new_default=10)
    uri = InputQueue(broker).enqueue(t=np.asarray([3, 5, 7], np.int32),
                                     max_new=10, stream=1)
    srv._intake()
    while srv._active or srv._waiting or srv._prefilling:
        srv._run_paged_step()
    events = list(OutputQueue(broker).stream_tokens(uri, timeout_s=5.0))
    assert [e["i"] for e in events[:-1]] == list(range(10))
    assert events[-1]["done"] and len(events[-1]["tokens"]) == 10
    assert broker.hgetall(RESULT_KEY) == {}
