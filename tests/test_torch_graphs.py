"""The port's captured programs (`compile_cache/graphs.py`) on their plain
path — the static-buffer protocol a CPU tensor takes (copy in, call, copy
out) — held against the JAX package's plain engines: `InferenceModel` with
a `compile_cache` serving `load_fn(x * p)` and a tiny BERT classifier
(2 blocks, hidden 64, seq 16) across buckets, two replicas, a `"same"` and
a `"restructured"` swap and a warm restart that reports "cached"; the tiny
`TinyDecoder` through the generative programs, equal to its eager path bit
for bit, paged equal to contiguous, and its greedy tokens equal to the JAX
model's.

The JAX side runs its plain jit engine, never its cached executables (the
CPU builds of this repository refuse its AOT path). Tolerances: `x * 2` is
exact; BERT logits agree within 1e-4 (f32 through two encoder blocks, as
`test_torch_cluster_serving_bert.py`); a program and the eager forward it
replaces run the same operations on the same values and agree bit for
bit. The CUDA graphs themselves run only on the card (`chip_smoke.py`'s
graph phase).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.models.bert import BERTClassifier as JClassifier
from analytics_zoo_tpu.models.generative import TinyDecoder as JDecoder
from analytics_zoo_tpu.serving.inference_model import \
    InferenceModel as JModel
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.compile_cache import (CompileCache,
                                                   GraphProgram,
                                                   capture_program,
                                                   make_key)
from analytics_zoo_tpu_torch.kernels import (KERNEL_SYMBOLS, LAUNCHES,
                                             _build, kernel_counts)
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from analytics_zoo_tpu_torch.models.generative import TinyDecoder
from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry
from analytics_zoo_tpu_torch.serving.broker import MemoryBroker
from analytics_zoo_tpu_torch.serving.decode import DecodeServing
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel
from analytics_zoo_tpu_torch.serving.quantization import \
    quantize_model_params
from analytics_zoo_tpu_torch.serving.server import ClusterServing

BERT_CFG = dict(vocab=100, hidden_size=64, n_block=2, n_head=2, seq_len=16,
                intermediate_size=128)
NUM_CLASSES = 5
TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(vocab=32, n_layers=2, n_heads=2, head_dim=8, max_len=64)
MAX_KV, BL = 64, 8
KV_BUCKETS, PROMPT_BUCKETS = [16, 32, 64], [8, 16]


class Scale(nn.Module):
    def __init__(self, s=2.0):
        super().__init__()
        self.register_buffer("s", torch.tensor(s))


def mul(p, x):
    return x * p.s


def cache(tmp_path, name="cc"):
    return CompileCache(str(tmp_path / name), registry=MetricsRegistry())


# ---------------------------------------------------------------------------
# the static-buffer protocol
# ---------------------------------------------------------------------------
def test_program_pads_rows_into_its_buffer_and_clones_out():
    def fn(x):
        return x * 2 + x.sum(0)          # the padded rows take part

    sample = torch.zeros(4, 3)
    prog = GraphProgram("p", fn, [sample], torch.device("cpu"))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    padded = torch.cat([x, x[-1:].expand(2, 3)])
    out = prog(x)
    np.testing.assert_array_equal(out.numpy(), fn(padded).numpy())
    out += 100                           # the caller owns its copy
    np.testing.assert_array_equal(prog(x).numpy(), fn(padded).numpy())
    np.testing.assert_array_equal(prog(x.numpy()).numpy(),
                                  fn(padded).numpy())
    assert prog.replays == 3 and prog.graph is None
    assert prog.launches == {}


@pytest.mark.parametrize("bad", [torch.zeros(5, 3), torch.zeros(2, 4),
                                 torch.zeros(0, 3), torch.zeros(3)])
def test_program_refuses_an_input_that_does_not_fit(bad):
    prog = GraphProgram("p", lambda x: x, [torch.zeros(4, 3)],
                        torch.device("cpu"))
    with pytest.raises(ValueError, match="static buffer"):
        prog(bad)


def test_capture_program_records_and_reports_its_source(tmp_path):
    cc = cache(tmp_path)
    key = make_key("serving", "m", ("t", ()), device="cpu")
    args = ("p", lambda x: x + 1, [torch.zeros(2)], torch.device("cpu"))
    assert capture_program(*args)[1] == "uncached"
    _, src = capture_program(*args, cache=cc, key=key)
    assert src == "compiled"
    prog, src = capture_program(*args, cache=cc, key=key)
    assert src == "cached" and cc.stats()["entries"] == 1
    assert cc.load(key) == b"p"          # a marker: the graph is not kept
    np.testing.assert_array_equal(prog(torch.ones(2)).numpy(), [2.0, 2.0])
    # a program that ran nvcc since its warmup began is "compiled", even
    # with its record found
    since = _build.build_events()["compiles"] - 1
    assert capture_program(*args, cache=cc, key=key,
                           compiles_since=since)[1] == "compiled"


def test_launch_recording_sees_only_its_own_thread():
    go, done = threading.Event(), threading.Event()

    def other():
        go.wait(5)
        LAUNCHES.add("test_other_thread")
        done.set()

    before = LAUNCHES.snapshot()
    t = threading.Thread(target=other)
    t.start()
    with LAUNCHES.capturing() as rec:
        LAUNCHES.add("test_mine")
        LAUNCHES.add("test_mine")
        go.set()
        assert done.wait(5)
    t.join(5)
    assert not t.is_alive()
    assert rec == {"test_mine": 2}
    after = LAUNCHES.snapshot()
    # a capture launches nothing: its calls stay out of the counts, the
    # other thread's launch is counted
    assert after.get("test_mine", 0) == before.get("test_mine", 0)
    assert after.get("test_other_thread", 0) == \
        before.get("test_other_thread", 0) + 1


# the kernel nodes of a captured graph as libcuda names them on an H100
# (`cuFuncGetName`), beside PyTorch's and cuBLAS's
GRAPH_SYMBOLS = [
    "_ZN50_GLOBAL__N__51afe6cc_17_flash_attn_fwd_cu_f4a4319b16flash_fwd_"
    "kernelIfLi1ELb0EEEvPKT_S3_S3_PKfPS1_PfiiifN3azt11AttnDropoutE",
    "_ZN52_GLOBAL__N__6fee2f53_19_decode_attention_cu_e72c1c9c23decode_"
    "attention_kernelIfLb0EEEvPKT_S3_S3_PKiS5_PS1_iiiiiifb",
    "_ZN52_GLOBAL__N__6fee2f53_19_decode_attention_cu_e72c1c9c23decode_"
    "attention_kernelIfLb1EEEvPKT_S3_S3_PKiS5_PS1_iiiiiifb",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3_warpsize"
    "1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
    "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_15CUDAFunctor_"
    "addIfEESt5arrayIPcLm3EEEEviT0_T1_",
]


@pytest.mark.parametrize("symbols, want", [
    (GRAPH_SYMBOLS, {"flash_attention_fwd": 1, "decode_attention": 1,
                     "paged_decode_attention": 1}),
    (GRAPH_SYMBOLS[:1] * 12 + GRAPH_SYMBOLS[3:],
     {"flash_attention_fwd": 12}),
    (["void (anonymous namespace)::decode_attention_kernel<__nv_bfloat16, "
      "true>(__nv_bfloat16 const*)",
      "void (anonymous namespace)::flash_fwd_mma_kernel<64, false>(...)"],
     {"paged_decode_attention": 1, "flash_attention_fwd": 1}),
    (GRAPH_SYMBOLS[3:], {}),
])
def test_kernel_nodes_count_as_their_kernels(symbols, want):
    assert kernel_counts(symbols) == want


def test_every_launch_count_names_its_kernel_symbol():
    from analytics_zoo_tpu_torch.kernels import (decode_attention,
                                                 dropout, flash_attention,
                                                 fused_adam, segment_update)
    names = {getattr(m, a) for m in (decode_attention, dropout,
                                     flash_attention, fused_adam,
                                     segment_update)
             for a in dir(m) if a.endswith("_NAME")}
    assert names == set(KERNEL_SYMBOLS)


# ---------------------------------------------------------------------------
# InferenceModel: load_fn(x * p) against the JAX engine
# ---------------------------------------------------------------------------
def test_scale_model_matches_jax_across_buckets(tmp_path):
    jim = JModel().load_fn(lambda p, x: x * p, np.float32(2.0))
    tim = InferenceModel(device="cpu", compile_cache=cache(tmp_path))
    tim.load_fn(mul, Scale())
    buckets = [1, 2, 4, 8]
    sample = np.zeros((3,), np.float32)
    jim.warmup(sample, buckets=buckets)
    tim.warmup(sample, buckets=buckets)
    assert set(tim.warmup_report) == set(jim.warmup_report)
    assert set(tim.warmup_source) == set(jim.warmup_source)
    assert set(tim.warmup_source.values()) == {"compiled"}
    assert tim.compile_cache_size() == len(buckets)
    rs = np.random.RandomState(0)
    for n in (1, 3, 5, 8, 11):           # 11: bucket 16, unwarmed: eager
        x = rs.randn(n, 3).astype(np.float32)
        np.testing.assert_array_equal(tim.predict(x), jim.predict(x))


def test_warm_restart_reports_cached_and_answers_the_same(tmp_path):
    x = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    outs, sources = [], []
    for _ in range(2):
        im = InferenceModel(device="cpu", compile_cache=cache(tmp_path))
        im.load_fn(mul, Scale()).warmup(np.zeros((3,), np.float32),
                                        buckets=[1, 2, 4, 8])
        sources.append(set(im.warmup_source.values()))
        outs.append(im.predict(x))
    assert sources == [{"compiled"}, {"cached"}]
    np.testing.assert_array_equal(outs[0], outs[1])
    im.warmup(np.zeros((3,), np.float32), buckets=[4])
    assert im.warmup_source["3:b4"] == "warm"


# ---------------------------------------------------------------------------
# InferenceModel: a tiny BERT against the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bert():
    jm = JClassifier(NUM_CLASSES, use_flash=True, **BERT_CFG)
    params = jax.device_get(jm.build(jax.random.PRNGKey(7)))
    jim = JModel(max_batch=4).load_keras(jm, params=params)
    jim.warmup(np.zeros(BERT_CFG["seq_len"], np.int64), buckets=[1, 4])
    return jm, params, jim


def _port_bert(params):
    tm = BERTClassifier(NUM_CLASSES, use_flash=True, device="cpu",
                        **BERT_CFG)
    tm.load_state_dict(convert.params_from_jax(params))
    return tm


def _ids(n, seed):
    return np.random.RandomState(seed).randint(
        0, BERT_CFG["vocab"], (n, BERT_CFG["seq_len"])).astype(np.int64)


def test_bert_programs_match_jax_and_restart_cached(bert, tmp_path):
    _, params, jim = bert
    sample = np.zeros(BERT_CFG["seq_len"], np.int64)
    outs = []
    for expect in ("compiled", "cached"):
        tim = InferenceModel(max_batch=4, device="cpu",
                             compile_cache=cache(tmp_path))
        tim.load_keras(_port_bert(params)).warmup(sample, buckets=[1, 4])
        assert set(tim.warmup_source.values()) == {expect}
        assert set(tim.warmup_report) == set(jim.warmup_report)
        got = [tim.predict(_ids(n, n)) for n in (1, 3, 4, 2)]
        for n, g in zip((1, 3, 4, 2), got):    # 2: unwarmed, eager
            np.testing.assert_allclose(g, jim.predict(_ids(n, n)), **TOL)
        outs.append(got)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_bert_two_replicas_persist_once_and_agree(bert, tmp_path):
    _, params, jim = bert
    sample = np.zeros(BERT_CFG["seq_len"], np.int64)
    one = InferenceModel(max_batch=4, device="cpu").load_keras(
        _port_bert(params))
    pool = InferenceModel(max_batch=4, num_replicas=2,
                          devices=["cpu", "cpu"],
                          compile_cache=cache(tmp_path))
    try:
        pool.load_keras(_port_bert(params)).warmup(sample, buckets=[1, 4])
        tag = str(BERT_CFG["seq_len"])
        assert pool.warmup_source == {
            f"r0:{tag}:b4": "compiled", f"r1:{tag}:b4": "cached",
            f"r0:{tag}:b1": "compiled", f"r1:{tag}:b1": "cached"}
        assert pool.compile_cache_size() == 4
        assert pool.compile_cache.stats()["entries"] == 2
        for seed in range(4):            # the router alternates replicas
            x = _ids(3, seed)
            got = pool.predict(x)
            np.testing.assert_array_equal(got, one.predict(x))
            np.testing.assert_allclose(got, jim.predict(x), **TOL)
    finally:
        pool.close()


def _shifted(params, delta):
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + delta).astype(np.asarray(a).dtype)
        if np.issubdtype(np.asarray(a).dtype, np.floating)
        else np.asarray(a), params)


@pytest.mark.parametrize("n", [1, 2])
def test_bert_swaps_answer_as_eager_with_the_new_weights(bert, tmp_path,
                                                         n):
    jm, params, _ = bert
    sample = np.zeros(BERT_CFG["seq_len"], np.int64)
    kw = dict(num_replicas=2, devices=["cpu", "cpu"]) if n > 1 else {}
    im = InferenceModel(max_batch=4, device="cpu",
                        compile_cache=cache(tmp_path), **kw)
    try:
        im.load_keras(_port_bert(params)).warmup(sample, buckets=[1, 4])
        size, builds = im.compile_cache_size(), _build.build_events()
        x = _ids(4, 5)
        new = _shifted(params, 1e-3)
        new_model = _port_bert(new)
        assert im.swap_params(new_model.state_dict()) == "same"
        assert im.compile_cache_size() == size
        assert _build.build_events() == builds
        eager = InferenceModel(max_batch=4, device="cpu").load_keras(
            _port_bert(new))
        np.testing.assert_array_equal(im.predict(x), eager.predict(x))
        jnew = JModel(max_batch=4).load_keras(jm, params=new)
        np.testing.assert_allclose(im.predict(x), jnew.predict(x), **TOL)

        q = quantize_model_params(new_model)
        assert im.swap_params(q.state_dict()) == "restructured"
        assert im.serving_dtype == "int8"
        assert im.compile_cache_size() == size      # recaptured
        assert set(im.warmup_source.values()) == {"compiled", "cached"} \
            or set(im.warmup_source.values()) == {"compiled"}
        q_eager = InferenceModel(max_batch=4, device="cpu").load_keras(
            _port_bert(new), quantize="int8")
        np.testing.assert_array_equal(im.predict(x), q_eager.predict(x))
        assert im.swap_params(new_model.state_dict()) == "restructured"
        np.testing.assert_array_equal(im.predict(x), eager.predict(x))
    finally:
        im.close()


def test_engine_metrics_carry_the_program_table(tmp_path):
    im = InferenceModel(device="cpu", compile_cache=cache(tmp_path))
    im.load_fn(mul, Scale()).warmup(np.zeros((4,), np.float32),
                                    buckets=[1, 2, 4])
    serving = ClusterServing(im, broker=MemoryBroker(),
                             registry=MetricsRegistry())
    m = serving.metrics()["compile_cache"]
    assert m["executables"] == 3
    assert m["entries"] == 3 and m["misses"] == 3
    assert m["warmup_source"]["4:b1"] == "compiled"
    assert "graph_pool_bytes" not in m          # no pools on the CPU


# ---------------------------------------------------------------------------
# the decode programs
# ---------------------------------------------------------------------------
def tdec():
    return TinyDecoder(**TINY, device="cpu")


def load(dec, cc=None):
    return InferenceModel(device="cpu", compile_cache=cc).load_generative(
        dec.prefill_fn, dec.step_fn, dec.init_params(0),
        paged_prefill_fn=dec.paged_prefill_fn,
        paged_step_fn=dec.paged_step_fn)


def greedy(im, kv, prompts, steps):
    """Prefill each prompt into its slot, then `steps` decode steps for
    all slots: every logits row, and the tokens."""
    logits, tokens, pos = [], [], []
    for slot, p in enumerate(prompts):
        padded = np.zeros(8, np.int32)
        padded[:len(p)] = p
        kv, lg = im.generative_prefill(kv, padded, len(p), slot)
        logits.append(lg.numpy().copy())
        tokens.append([int(torch.argmax(lg))])
        pos.append(len(p))
    for _ in range(steps):
        bucket = next(b for b in KV_BUCKETS if b >= max(pos) + 1)
        kv, lg = im.generative_step(
            kv, np.asarray([t[-1] for t in tokens], np.int32),
            np.asarray(pos, np.int32), bucket)
        logits.append(lg.numpy().copy())
        for s, row in enumerate(lg.argmax(-1).tolist()):
            tokens[s].append(int(row))
            pos[s] += 1
    return logits, tokens


def paged_greedy(im, kv, prompts, steps):
    """The same through the paged programs: one block table per lane,
    blocks 1.. handed out in order (block 0 is the scratch block)."""
    nxt = iter(range(1, 100))
    tables = np.zeros((len(prompts), MAX_KV // BL), np.int32)
    for s in range(len(prompts)):
        tables[s] = [next(nxt) for _ in range(MAX_KV // BL)]
    logits, tokens, pos = [], [], []
    for s, p in enumerate(prompts):
        padded = np.zeros(8, np.int32)
        padded[:len(p)] = p
        kv, lg = im.generative_prefill_paged(kv, padded, tables[s], 0,
                                             len(p), 0)
        logits.append(lg.numpy().copy())
        tokens.append([int(torch.argmax(lg))])
        pos.append(len(p))
    for _ in range(steps):
        bucket = next(b for b in KV_BUCKETS if b >= max(pos) + 1)
        kv, lg = im.generative_step_paged(
            kv, np.asarray([t[-1] for t in tokens], np.int32),
            np.asarray(pos, np.int32), tables, bucket)
        logits.append(lg.numpy().copy())
        for s, row in enumerate(lg.argmax(-1).tolist()):
            tokens[s].append(int(row))
            pos[s] += 1
    return logits, tokens


PROMPTS = [[3, 5, 7], [2, 4, 6, 8, 10, 12]]


def _warm(im, dec, slots=2):
    im.warmup_generative(dec.init_kv, slots=slots, max_kv_len=MAX_KV,
                         prompt_buckets=PROMPT_BUCKETS,
                         kv_buckets=KV_BUCKETS)
    im.warmup_generative_paged(
        dec.init_kv_blocks, num_blocks=slots * MAX_KV // BL + 1,
        block_len=BL, lanes=slots, table_len=MAX_KV // BL,
        chunk_buckets=[8], kv_buckets=KV_BUCKETS)
    return im


class Owner:
    """What holds a warmed KV pool in these tests (an engine, in
    serving)."""


def test_decode_programs_equal_eager_paged_equal_contiguous_and_jax():
    dec = tdec()
    im = _warm(load(dec), dec)
    owner = Owner()
    kv = im.serving_kv(dec.init_kv, owner)(2, MAX_KV)
    blocks = im.serving_kv(dec.init_kv_blocks, owner, paged=True)(
        2 * MAX_KV // BL + 1, BL)
    got = greedy(im, kv, PROMPTS, 10)
    paged = paged_greedy(im, blocks, PROMPTS, 10)
    replays = im.program_replays()
    assert replays["prefill 8"] == 2 and replays["paged_prefill (8, 0)"] == 2
    assert sum(n for name, n in replays.items()
               if name.startswith("step")) == 10
    eager = load(dec)                    # not warmed: no program
    want = greedy(eager, dec.init_kv(2, MAX_KV), PROMPTS, 10)
    want_paged = paged_greedy(eager, dec.init_kv_blocks(
        2 * MAX_KV // BL + 1, BL), PROMPTS, 10)
    for a, b, c, d in zip(got[0], want[0], paged[0], want_paged[0]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)
        np.testing.assert_array_equal(a, c)
    assert got[1] == want[1] == paged[1]
    # the JAX model's greedy tokens, from its own functions
    j = JDecoder(**TINY)
    tree = j.init_params(0)
    jkv = j.init_kv(2, MAX_KV)
    jt, jpos = [], []
    for slot, p in enumerate(PROMPTS):
        padded = np.zeros(8, np.int32)
        padded[:len(p)] = p
        jkv, jl = j.prefill_fn(tree, jkv, jnp.asarray(padded),
                               jnp.int32(len(p)), jnp.int32(slot))
        jt.append([int(np.argmax(np.asarray(jl)))])
        jpos.append(len(p))
    for _ in range(10):
        bucket = next(b for b in KV_BUCKETS if b >= max(jpos) + 1)
        jkv, jl = j.step_fn(tree, jkv,
                            jnp.asarray([t[-1] for t in jt], jnp.int32),
                            jnp.asarray(jpos, jnp.int32), bucket)
        for s, row in enumerate(np.asarray(jl).argmax(-1).tolist()):
            jt[s].append(int(row))
            jpos[s] += 1
    assert got[1] == jt


def test_a_foreign_pool_runs_eagerly_and_the_engine_adopts_the_warmed():
    dec = tdec()
    im = _warm(load(dec), dec, slots=2)
    replays = im.program_replays()
    got = greedy(im, dec.init_kv(2, MAX_KV), PROMPTS, 3)
    assert im.program_replays() == replays      # no program ran
    assert im.gen_eager_calls == {"prefill": 2, "step": 3}
    want = greedy(load(dec), dec.init_kv(2, MAX_KV), PROMPTS, 3)
    assert got[1] == want[1]
    engine = DecodeServing(im, dec.init_kv, broker=MemoryBroker(),
                           registry=MetricsRegistry(), slots=2,
                           max_kv_len=MAX_KV, kv_buckets=KV_BUCKETS,
                           prompt_buckets=PROMPT_BUCKETS)
    assert engine.pool.kv is im._gen_kv[1]
    paged = DecodeServing(im, dec.init_kv, broker=MemoryBroker(),
                          registry=MetricsRegistry(), slots=2,
                          max_kv_len=MAX_KV, kv_buckets=KV_BUCKETS,
                          prompt_buckets=PROMPT_BUCKETS, paged=True,
                          init_kv_blocks=dec.init_kv_blocks, block_len=BL,
                          chunk_buckets=[8])
    assert paged.block_pool.kv is im._gen_kv_blocks[1]
    # an engine of another shape gets a pool of its own
    other = DecodeServing(im, dec.init_kv, broker=MemoryBroker(),
                          registry=MetricsRegistry(), slots=3,
                          max_kv_len=MAX_KV, kv_buckets=KV_BUCKETS,
                          prompt_buckets=PROMPT_BUCKETS)
    assert other.pool.kv is not im._gen_kv[1]


def test_decode_warm_restart_reports_cached(tmp_path):
    dec = tdec()
    first = _warm(load(dec, cache(tmp_path)), dec)
    assert set(first.warmup_source) == set(first.warmup_report)
    assert set(first.warmup_source.values()) == {"compiled"}
    n = first.compile_cache_size()
    assert n == len(PROMPT_BUCKETS) + len(KV_BUCKETS) \
        + (1 + len(KV_BUCKETS)) + len(KV_BUCKETS)
    second = _warm(load(dec, cache(tmp_path)), dec)
    assert set(second.warmup_source.values()) == {"cached"}
    assert _warm(second, dec).warmup_source["gen-step:kv16"] == "warm"
    assert second.compile_cache.stats()["entries"] == n


def _engine(im, dec, **kw):
    return DecodeServing(im, dec.init_kv, broker=MemoryBroker(),
                         registry=MetricsRegistry(), slots=2,
                         max_kv_len=MAX_KV, kv_buckets=KV_BUCKETS,
                         prompt_buckets=PROMPT_BUCKETS, **kw)


def test_two_engines_on_one_model_never_share_the_warmed_pool():
    import gc
    dec = tdec()
    im = _warm(load(dec), dec, slots=2)
    first = _engine(im, dec, engine_id="first")
    second = _engine(im, dec, engine_id="second")
    assert first.pool.kv is im._gen_kv[1]
    assert second.pool.kv is not im._gen_kv[1]  # a pool of its own
    second.start()                               # serves, eagerly
    second.stop(drain=False)
    # each engine's calls: the first replays, the second runs eagerly
    replays = im.program_replays()
    got = greedy(im, second.pool.kv, PROMPTS, 2)
    assert im.program_replays() == replays
    assert im.gen_eager_calls == {"prefill": 2, "step": 2}
    want = greedy(im, first.pool.kv, PROMPTS, 2)
    assert im.program_replays() != replays
    assert got[1] == want[1]
    # a stopped engine gives the pool back; started again while another
    # holds it, it refuses
    first.stop(drain=False)
    third = _engine(im, dec, engine_id="third")
    assert third.pool.kv is im._gen_kv[1]
    with pytest.raises(RuntimeError, match="warmed KV pool"):
        first.start()
    # an engine that is gone (its process died) holds nothing
    del third
    gc.collect()
    assert _engine(im, dec).pool.kv is im._gen_kv[1]
