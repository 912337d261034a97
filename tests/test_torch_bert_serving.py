"""The port's BERT serving slice held against the JAX package on the CPU:
LayerNorm and gelu, `MultiHeadSelfAttention`, `TransformerEncoderBlock`,
`BERT` (stacked and unstacked trees), `BERTClassifier` logits with and
without `use_flash`, `InferenceModel.predict` (bucket padding and the
split above `max_batch`), the copied predict `Timer`, and `convert.py`
both ways.

Weights come from the JAX package's own `build` and cross through
`convert.params_from_jax`; inputs are made with numpy from a seed and fed
to both packages. Tolerances in f32: 1e-5 for single layers, 1e-4 for
logits through a whole encoder (float rounding accumulating over blocks).
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras.layers import LayerNormalization as JLN
from analytics_zoo_tpu.keras.transformer import BERT as JBERT
from analytics_zoo_tpu.keras.transformer import \
    MultiHeadSelfAttention as JMHSA
from analytics_zoo_tpu.keras.transformer import \
    TransformerEncoderBlock as JBlock
from analytics_zoo_tpu.models.bert import BERTClassifier as JClassifier
from analytics_zoo_tpu.observability.registry import \
    LogHistogram as JLogHistogram
from analytics_zoo_tpu.serving.inference_model import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu.serving.timer import Timer as JTimer
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common import device as device_mod
from analytics_zoo_tpu_torch.keras.layers import LayerNormalization, \
    get_activation
from analytics_zoo_tpu_torch.keras.transformer import (
    BERT, MultiHeadSelfAttention, TransformerEncoderBlock)
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from analytics_zoo_tpu_torch.observability.registry import LogHistogram
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel
from analytics_zoo_tpu_torch.serving.timer import Timer

CFG = dict(vocab=128, hidden_size=64, n_block=2, n_head=4, seq_len=64,
           intermediate_size=128)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _state(tree):
    """A JAX layer tree → the port module's state dict (same key paths)."""
    return convert.params_from_jax(jax.device_get(tree))


def _tokens(B=3, T=64, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, CFG["vocab"], size=(B, T)).astype(np.int32)
    lens = np.array([T, 40, 7, 33, 1, 64, 12][:B])
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.int32)
    types = (np.arange(T)[None, :] >= lens[:, None] // 2).astype(np.int32)
    return ids, types, mask


def _additive(mask):
    return ((1.0 - mask) * -10000.0).astype(np.float32)[:, None, None, :]


def test_layer_norm_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 64).astype(np.float32) * 3 + 1
    jl = JLN(name="ln")
    p = {"gamma": rs.randn(64).astype(np.float32),
         "beta": rs.randn(64).astype(np.float32)}
    ref = np.asarray(jl.call(p, jnp.asarray(x)))
    tl = LayerNormalization(64, device="cpu")
    tl.load_state_dict(_state(p))
    np.testing.assert_allclose(tl.call(torch.from_numpy(x)).detach().numpy(),
                               ref, **LAYER_TOL)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    out = get_activation("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax.nn.gelu(x)), **LAYER_TOL)
    erf_form = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(out - erf_form).max() > 1e-4


@pytest.mark.parametrize("use_flash", [False, True])
def test_multi_head_self_attention_matches_jax(use_flash):
    ids, _, mask = _tokens()
    x = np.random.RandomState(1).randn(3, 64, 64).astype(np.float32)
    m = _additive(mask)
    jl = JMHSA(64, 4, use_flash=use_flash, name="mhsa")
    p = jl.build(jax.random.PRNGKey(0), (None, 64, 64))
    p = dict(p, qkv_bias=jnp.linspace(-1, 1, 192),
             out_bias=jnp.linspace(1, -1, 64))
    ref = np.asarray(jl.call(p, jnp.asarray(x), mask=jnp.asarray(m)))
    tl = MultiHeadSelfAttention(64, 4, use_flash=use_flash, device="cpu")
    tl.load_state_dict(_state(p))
    out = tl.call([torch.from_numpy(x), torch.from_numpy(m)])
    np.testing.assert_allclose(out.detach().numpy(), ref, **LAYER_TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_encoder_block_matches_jax(use_flash):
    _, _, mask = _tokens()
    x = np.random.RandomState(2).randn(3, 64, 64).astype(np.float32)
    m = _additive(mask)
    jl = JBlock(64, 4, 128, use_flash=use_flash, name="blk")
    p = jl.build(jax.random.PRNGKey(1), (None, 64, 64))
    ref = np.asarray(jl.call(p, [jnp.asarray(x), jnp.asarray(m)]))
    tl = TransformerEncoderBlock(64, 4, 128, use_flash=use_flash,
                                 device="cpu")
    tl.load_state_dict(_state(p))
    out = tl.call([torch.from_numpy(x), torch.from_numpy(m)])
    np.testing.assert_allclose(out.detach().numpy(), ref, **LAYER_TOL)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("n_inputs", [1, 2, 3])
def test_bert_matches_jax(stacked, n_inputs):
    ids, types, mask = _tokens()
    jl = JBERT(stacked=stacked, name="bert", **CFG)
    p = jl.build(jax.random.PRNGKey(2), None)
    inputs = {1: ids, 2: [ids, mask], 3: [ids, types, mask]}[n_inputs]
    seq_ref, pooled_ref = jl.call(p, inputs)
    tl = BERT(name="bert", device="cpu", **CFG)
    tl.load_state_dict({k[len("bert."):]: v
                        for k, v in _state({"bert": p}).items()})
    with torch.inference_mode():
        seq, pooled = tl.call(inputs if n_inputs == 1 else list(inputs))
    np.testing.assert_allclose(seq.numpy(), np.asarray(seq_ref), **LOGIT_TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_ref),
                               **LOGIT_TOL)


def _classifier_pair(use_flash, stacked=False, seed=3):
    jm = JClassifier(2, use_flash=use_flash, stacked=stacked, **CFG)
    params = jax.device_get(jm.build(jax.random.PRNGKey(seed)))
    tm = BERTClassifier(2, use_flash=use_flash, device="cpu", **CFG)
    tm.load_state_dict(convert.params_from_jax(params))
    return jm, params, tm


@pytest.mark.parametrize("use_flash", [False, True])
def test_classifier_logits_match_jax(use_flash):
    jm, params, tm = _classifier_pair(use_flash)
    ids, types, mask = _tokens(B=5)
    ref = np.asarray(jm.apply(params, [ids, types, mask]))
    with torch.inference_mode():
        out = tm.apply([ids, types, mask]).numpy()
    assert out.shape == (5, 2)
    np.testing.assert_allclose(out, ref, **LOGIT_TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_inference_model_predict_matches_jax(use_flash):
    """Batches of 1, 3 and 5 rows, and 11 rows above max_batch 4 (split
    into 4 + 4 + 3, the last chunk padded to its bucket)."""
    jm, params, tm = _classifier_pair(use_flash, seed=4)
    jim = JInferenceModel(max_batch=4).load_keras(jm, params=params)
    tim = InferenceModel(max_batch=4, device="cpu").load_keras(tm)
    ids, types, mask = _tokens(B=7, seed=5)
    tim.warmup([ids[0], mask[0]])
    assert tim.warmed_buckets == {1, 2, 4}
    assert set(tim.warmup_report) == {"64:b1", "64:b2", "64:b4"}
    assert tim.timer.count == 0          # warmup bypasses the timer
    for n in (1, 3, 5, 11):
        x = [np.resize(ids, (n, 64)), np.resize(mask, (n, 64))]
        out = tim.predict(x)
        assert out.shape == (n, 2) and out.dtype == np.float32
        np.testing.assert_allclose(out, np.asarray(jim.predict(x)),
                                   **LOGIT_TOL)
    assert tim.timer.count == 1 + 1 + 2 + 3
    pending = tim.predict_async([ids[:3], mask[:3]])
    assert pending.done()
    np.testing.assert_array_equal(pending.result(), pending.result())


def test_requests_and_masks_reach_the_kernel_contiguous():
    """The kernel takes only contiguous inputs: a broadcast warmup batch
    (numpy would copy it in Fortran order) and a transposed mask must
    still arrive C-contiguous."""
    from analytics_zoo_tpu_torch.serving.inference_model import \
        _as_host_tensor
    batch = np.broadcast_to(np.ones(16, np.int64)[None], (4, 16))
    assert _as_host_tensor(batch).is_contiguous()
    mask = torch.ones(16, 4, dtype=torch.int64).t()
    additive = BERT.make_mask(mask)
    assert additive.shape == (4, 1, 1, 16) and additive.is_contiguous()


def test_concurrent_predicts_match_sequential_ones():
    """More client threads than permits and cores: every answer equals
    the sequential one and the Timer records every predict."""
    _, _, tm = _classifier_pair(True, seed=14)
    tim = InferenceModel(concurrent_num=2, max_batch=4,
                         device="cpu").load_keras(tm)
    ids, _, mask = _tokens(B=7, seed=15)
    batches = [[ids[:n], mask[:n]] for n in (1, 2, 3, 5, 7)]
    want = [tim.predict(x) for x in batches]
    tim.timer.reset()
    got = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(
            target=lambda i=i: got.__setitem__(
                i, tim.predict(batches[i % len(batches)])))
            for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 12
    for i, out in got.items():
        np.testing.assert_allclose(out, want[i % len(batches)], rtol=1e-6,
                                   atol=1e-6)
    # 5 and 7 rows split into two max_batch chunks, each timed: 4 extra
    assert tim.timer.count == 12 + 4


def test_inference_model_serves_bf16_weights():
    _, _, tm = _classifier_pair(False, seed=6)
    ids, _, mask = _tokens(B=3, seed=7)
    with torch.inference_mode():
        ref = tm.apply([ids, mask]).numpy()
    tim = InferenceModel(max_batch=4, device="cpu").load_keras(
        tm.to(torch.bfloat16))
    assert tim.serving_dtype == "bfloat16"
    out = tim.predict([ids, mask])
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=0.1)


def test_timer_and_histogram_copies_match_the_reference():
    """The copied `Timer` and `LogHistogram` give the reference's numbers
    on the same samples, within the histogram's bounded error of the
    exact percentiles."""
    samples = np.random.RandomState(16).lognormal(-6.0, 1.0, 5000)
    jt, tt = JTimer("predict"), Timer("predict")
    jh, th = JLogHistogram(), LogHistogram()
    for s in samples:
        for obj in (jt, tt):
            obj.record(float(s))
        for obj in (jh, th):
            obj.observe(float(s) * 1e3)
    snap = tt.snapshot()
    assert snap == jt.snapshot() and snap["count"] == len(samples)
    for q in (0.5, 0.95, 0.99):
        exact = float(np.percentile(samples, 100 * q)) * 1e3
        assert th.percentile(q) == jh.percentile(q)
        assert abs(th.percentile(q) - exact) / exact < 0.25
        assert abs(snap[f"p{round(100 * q)}_ms"] - exact) / exact < 0.25
    single = Timer("one")
    single.record(0.010)
    assert single.snapshot()["p50_ms"] == single.snapshot()["p99_ms"] == 10.0


def test_timer_reset_races_record_safely():
    """A reset racing `record` from another thread never leaves a torn
    snapshot (every record is 1 ms, so a torn one shows another mean)."""
    t = Timer("x")
    lock = t._lock
    stop = threading.Event()
    torn = []

    def recorder():
        while not stop.is_set():
            t.record(0.001)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    rt = threading.Thread(target=recorder)
    rt.start()
    try:
        for _ in range(200):
            t.reset()
            s = t.snapshot()
            if s["count"] and s["avg_ms"] != pytest.approx(1.0):
                torn.append(s)
    finally:
        stop.set()
        rt.join(timeout=60)
        sys.setswitchinterval(old)
    assert not rt.is_alive()
    assert torn == [] and t._lock is lock


@pytest.mark.parametrize("stacked", [False, True])
def test_convert_round_trips(stacked):
    jm = JClassifier(2, stacked=stacked, **CFG)
    tree = jax.device_get(jm.build(jax.random.PRNGKey(8)))
    sd = convert.params_from_jax(tree)
    tm = BERTClassifier(2, device="cpu", **CFG)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    # JAX tree → state dict → JAX tree
    back = convert.params_to_jax(sd, stacked=stacked)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # state dict → JAX tree → state dict
    again = convert.params_from_jax(convert.params_to_jax(tm.state_dict(),
                                                          stacked=stacked))
    assert set(again) == set(sd)
    for key, value in tm.state_dict().items():
        torch.testing.assert_close(again[key], value, rtol=0, atol=0)


def test_convert_keeps_qkv_column_order():
    jm = JClassifier(2, **CFG)
    tree = jax.device_get(jm.build(jax.random.PRNGKey(9)))
    sd = convert.params_from_jax(tree)
    np.testing.assert_array_equal(
        sd["bert.blocks.1.attn.qkv_kernel"].numpy(),
        tree["bert"]["bert_block1"]["attn"]["qkv_kernel"])


def test_int8_trees_are_not_ported():
    """int8 trees are ported now (`tests/test_torch_quantization.py`):
    their leaves cross `convert` as they are, and `quantize="int8"`
    serves the int8 twin, leaving the f32 model as it is."""
    tree = {"cls_kernel_q": np.zeros((4, 2), np.int8)}
    sd = convert.params_from_jax(tree)
    assert sd["cls_kernel_q"].dtype == torch.int8
    _, _, tm = _classifier_pair(False, seed=10)
    im = InferenceModel(device="cpu").load_keras(tm, quantize="int8")
    assert im.serving_dtype == "int8"
    assert all(t.dtype == torch.float32 for t in tm.state_dict().values())


def test_training_dropout_is_not_ported():
    """Training dropout is ported now: as in the JAX package, training
    without a seed (the JAX `rng`) drops nothing, and a seed drops the
    same elements every time."""
    _, _, tm = _classifier_pair(False, seed=11)
    ids, _, mask = _tokens()
    with torch.no_grad():
        eval_out = tm.apply([ids, mask])
        torch.testing.assert_close(tm.apply([ids, mask], training=True),
                                   eval_out, rtol=0, atol=0)
        dropped = tm.apply([ids, mask], training=True, seed=5)
        torch.testing.assert_close(
            tm.apply([ids, mask], training=True, seed=5), dropped,
            rtol=0, atol=0)
    assert (dropped - eval_out).abs().max() > 1e-4


def test_unbuilt_model_is_refused():
    tm = BERTClassifier(2, device="cpu", **CFG)
    assert not tm.built
    with pytest.raises(ValueError, match="no parameters"):
        InferenceModel(device="cpu").load_keras(tm)
    assert set(tm.ensure_built()) == set(tm.state_dict()) and tm.built
    ids, _, mask = _tokens()
    out = InferenceModel(device="cpu").load_keras(tm).predict([ids, mask])
    assert out.shape == (3, 2) and np.isfinite(out).all()


@pytest.mark.parametrize("make", [
    lambda: InferenceModel(),
    lambda: InferenceModel(device="cuda"),
    lambda: BERTClassifier(2, **CFG),
])
def test_cuda_without_a_gpu_raises(monkeypatch, make):
    """Entry points default to the card and refuse to run on the CPU
    unless asked."""
    monkeypatch.setattr(device_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


@pytest.mark.gpu
def test_classifier_on_gpu_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, cpu_model = _classifier_pair(True, seed=12)
    ids, types, mask = _tokens(B=5, seed=13)
    cpu = InferenceModel(device="cpu").load_keras(cpu_model).predict(
        [ids, types, mask])
    _, _, gpu_model = _classifier_pair(True, seed=12)
    gpu = InferenceModel(max_batch=8).load_keras(gpu_model).predict(
        [ids, types, mask])
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4, atol=1e-4)
