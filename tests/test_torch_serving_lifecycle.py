"""The rest of the port's `InferenceModel` on the CPU, mirroring the JAX
package's `tests/test_serving_multidevice.py:47-228, :355, :386-405`: a
replica pool (`devices=["cpu", "cpu", ...]`, one worker thread each) with
its least-outstanding-work router, in-flight bound, dispatch failures
through the `replica.dispatch` fault point, quarantine, probes and
revival; `replica_stats`, `weight_bytes` and `placement_info`; hot swap
(`"same"` and `"restructured"`); the serving roofline and
`account_generative`; and `load_torch`. (`load_checkpoint` is held
against the JAX package's in `tests/test_torch_quantization.py`.)

Replicated outputs are held bitwise to a single replica's, and to the
JAX package's `InferenceModel` at 1e-5 (f32).
"""

import copy
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.serving.inference_model import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Sequential
from analytics_zoo_tpu_torch.kernels import _build
from analytics_zoo_tpu_torch.observability.registry import get_registry
from analytics_zoo_tpu_torch.observability.roofline import get_accountant
from analytics_zoo_tpu_torch.serving.inference_model import (
    InferenceModel, NoHealthyReplicaError)
from analytics_zoo_tpu_torch.serving.quantization import \
    quantize_model_params

F32_TOL = 1e-5


def make_model(seed=0):
    """`x @ W`, W [4, 3], as the JAX tests' `make_model`."""
    m = Sequential([L.Dense(3, use_bias=False, input_shape=(4,),
                            device="cpu")])
    m.ensure_built(seed=seed)
    return m


def kernel_of(m) -> np.ndarray:
    return next(iter(m.state_dict().values())).numpy()


def pool(n=2, **kw):
    return InferenceModel(num_replicas=n, devices=["cpu"] * n, **kw)


def batch(seed=0, n=3):
    return np.random.RandomState(seed).randn(n, 4).astype(np.float32)


@pytest.fixture
def closing():
    models = []
    yield models.append
    for im in models:
        im.close()


# ---------------------------------------------------------------------------
# the pool and its router
# ---------------------------------------------------------------------------
def test_single_replica_is_the_plain_path():
    m = make_model()
    im = InferenceModel(device="cpu").load_keras(m)
    assert im.num_replicas == 1 and im._replicas is None
    x = batch(1, 5)
    np.testing.assert_allclose(im.predict(x), x @ kernel_of(m), atol=F32_TOL)
    assert im.predict_async(x).replica == 0


@pytest.mark.parametrize("n", [2, 4])
def test_replicas_match_one_replica_and_jax(n, closing):
    m = make_model()
    one = InferenceModel(device="cpu").load_keras(copy.deepcopy(m))
    im = pool(n).load_keras(m)
    closing(im)
    jim = JInferenceModel().load_fn(lambda p, x: x @ p, kernel_of(m))
    for seed in range(2 * n):
        x = batch(seed)
        got = im.predict(x)
        np.testing.assert_array_equal(got, one.predict(x))
        np.testing.assert_allclose(got, np.asarray(jim.predict(x)),
                                   atol=F32_TOL)
    assert {s["batches"] > 0 for s in im.replica_stats()} == {True}


def test_auto_takes_every_device_with_its_own_weights(closing):
    im = InferenceModel(num_replicas="auto", devices=["cpu"] * 3)
    closing(im)
    im.load_keras(make_model())
    assert im.num_replicas == 3 and len(im._replicas) == 3
    ptrs = {next(iter(r.params.state_dict().values())).data_ptr()
            for r in im._replicas}
    assert len(ptrs) == 3
    assert im.current_params() is im._replicas[0].params


def test_routing_fairness_least_outstanding_work(closing):
    """8 dispatches with nothing materialized: exactly max_inflight (2) on
    each of 4 replicas, none piled onto replica 0."""
    im = pool(4).load_keras(make_model())
    closing(im)
    pends = [im.predict_async(batch()) for _ in range(8)]
    assert sorted(p.replica for p in pends) == sorted(list(range(4)) * 2)
    for p in pends:
        p.result()
    assert all(s["inflight"] == 0 for s in im.replica_stats())


def test_inflight_bound_blocks_then_times_out(closing):
    im = pool(2, max_inflight_per_replica=1).load_keras(make_model())
    closing(im)
    held = [im.predict_async(batch()) for _ in range(2)]
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        im._acquire_replica(timeout=0.2)
    assert time.monotonic() - t0 < 5
    for p in held:
        p.result()
    assert im.predict_async(batch()).result().shape == (3, 3)


def test_dispatch_failure_releases_permit(closing):
    """A batch that fails at dispatch re-raises from result(), reports to
    `_on_replica_event` and releases its replica permit."""
    im = pool(2, max_inflight_per_replica=1).load_keras(make_model())
    closing(im)
    events = []
    im._on_replica_event = lambda i, ok, s: events.append((i, ok))
    with faults.injected("replica.dispatch", faults.Fault(mode="raise")):
        for _ in range(4):                       # more than the permits
            with pytest.raises(faults.FaultError):
                im.predict_async(batch()).result()
    assert all(s["inflight"] == 0 for s in im.replica_stats())
    deadline = time.monotonic() + 10   # a worker reports after failing
    while len(events) < 4 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert sorted(events) == [(0, False)] * 2 + [(1, False)] * 2
    assert im.predict(batch()).shape == (3, 3)


def test_abandon_releases_permit_without_materializing(closing):
    im = pool(2, max_inflight_per_replica=1).load_keras(make_model())
    closing(im)
    for _ in range(4):
        im.predict_async(batch()).abandon()
    assert all(s["inflight"] == 0 for s in im.replica_stats())
    assert im.predict(batch()).shape == (3, 3)


def test_quarantine_moves_queued_jobs_with_their_permits(closing):
    """Replica 1 stalls on its first batch; its second, still queued,
    moves to replica 0 when replica 1 is quarantined."""
    m = make_model()
    im = pool(2).load_keras(m)
    closing(im)
    xs = [batch(s) for s in range(4)]
    with faults.injected("replica.dispatch", faults.Fault(
            mode="stall", delay_s=1.0, times=1,
            match=lambda c: c["replica"] == 1)) as stall:
        pends = [im.predict_async(x) for x in xs[:2]]
        deadline = time.monotonic() + 10
        while not stall.trips and time.monotonic() < deadline:
            time.sleep(0.001)                    # replica 1 is stalled now
        pends += [im.predict_async(x) for x in xs[2:]]
        assert [p.replica for p in pends] == [0, 1, 0, 1]
        assert im.quarantine_replica(1)
        assert not im.quarantine_replica(1)          # idempotent
        assert [p.replica for p in pends] == [0, 1, 0, 0]
        for p, x in zip(pends, xs):
            np.testing.assert_allclose(p.result(), x @ kernel_of(m),
                                       atol=F32_TOL)
    assert im.quarantined_replicas() == [1] and im.healthy_replicas() == 1
    assert [s["inflight"] for s in im.replica_stats()] == [0, 0]
    after = [im.predict_async(batch()) for _ in range(2)]
    assert [p.replica for p in after] == [0, 0]
    for p in after:
        p.result()


def test_all_quarantined_fails_fast_then_probe_and_revive(closing):
    im = pool(2).load_keras(make_model())
    closing(im)
    assert im.probe_replica(0) is False             # nothing to probe with
    im.predict(batch())
    for i in (0, 1):
        im.quarantine_replica(i)
    t0 = time.monotonic()
    with pytest.raises(NoHealthyReplicaError):
        im.predict_async(batch())
    assert time.monotonic() - t0 < 1.0
    with faults.injected("replica.dispatch", faults.Fault(
            mode="raise", match=lambda c: c["replica"] == 1)):
        assert im.probe_replica(1) is False         # still sick
    assert im.probe_replica(1) is True              # a canary passes
    assert im.revive_replica(1) and not im.revive_replica(1)
    assert im.healthy_replicas() == 1
    assert im.predict_async(batch()).replica == 1
    assert im.replica_inflight(1) == 1


def test_stats_weight_bytes_and_placement(closing):
    single = InferenceModel(device="cpu")
    assert single.weight_bytes() == 0
    single.load_keras(make_model())
    assert single.replica_stats() == [{"replica": 0, "device": "cpu",
                                       "batches": None, "inflight": 0}]
    im = pool(2).load_keras(make_model())
    closing(im)
    im.predict(batch())
    stats = im.replica_stats()
    assert [s["replica"] for s in stats] == [0, 1]
    assert sum(s["batches"] for s in stats) == 1
    assert im.weight_bytes() == 4 * 3 * 4 == single.weight_bytes()
    assert im.placement_info() == {"placement": "replicated",
                                   "num_replicas": 2, "n_devices": 2,
                                   "serving_dtype": "float32"}
    q = quantize_model_params(make_model())
    im = pool(1).load_keras(q)
    closing(im)
    assert im.weight_bytes() == 4 * 3 + 3 * 4
    im.predict(batch())                  # pads the [4, 3] kernel to [8, 8]
    assert im.weight_bytes() == 4 * 3 + 3 * 4 + 8 * 8


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(num_replicas=3, devices=["cpu", "cpu"]), ValueError, "exceeds"),
    (dict(num_replicas=-3, devices=["cpu"]), ValueError, "must be >= 1"),
    (dict(placement="mirrored", device="cpu"), ValueError, "mirrored"),
    (dict(placement="sharded", device="cpu"), NotImplementedError,
     "item 7"),
])
def test_constructor_validation(kwargs, error, match):
    with pytest.raises(error, match=match):
        InferenceModel(**kwargs)


def test_warmup_fans_out_across_replicas(closing):
    im = pool(3).load_keras(make_model())
    closing(im)
    im.warmup(np.zeros((4,), np.float32), buckets=[1, 4])
    assert im.warmed_buckets == {1, 4}
    assert set(im.warmup_report) == {f"r{i}:4:b{b}" for i in range(3)
                                     for b in (1, 4)}


def test_close_retires_the_pool():
    im = pool(2).load_keras(make_model())
    threads = [r.thread for r in im._replicas]
    im.close()
    assert all(not t.is_alive() for t in threads)
    with pytest.raises(RuntimeError, match="No model loaded"):
        im.predict(batch())
    im.close()                                      # safe to repeat


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------
def _new_weights(m, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g)
            for k, v in m.state_dict().items()}


@pytest.mark.parametrize("n", [1, 2])
def test_swap_same_structure(n, closing):
    m = make_model()
    im = (pool(n) if n > 1 else InferenceModel(device="cpu")).load_keras(m)
    closing(im)
    im.warmup(np.zeros((4,), np.float32), buckets=[4])
    report = dict(im.warmup_report)
    builds = _build.build_events()
    x = batch(5)
    old = im.predict(x)
    pending = im.predict_async(x)
    if n > 1:                     # on its replica's worker, dispatched
        assert pending._event.wait(10)
    live = im.current_params()
    new = _new_weights(m, 7)
    assert im.swap_params(new) == "same"
    np.testing.assert_array_equal(pending.result(), old)
    fresh = copy.deepcopy(m)
    fresh.load_state_dict(new)
    want = InferenceModel(device="cpu").load_keras(fresh).predict(x)
    np.testing.assert_array_equal(im.predict(x), want)
    # the new values land in the live module's own tensors, the storage a
    # captured graph reads
    assert im.current_params() is live
    for k, v in live.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), new[k].numpy())
    assert im.warmup_report == report and _build.build_events() == builds
    # float64 host weights land as the live float32 structure
    assert im.swap_params({k: v.double().numpy() for k, v in new.items()}
                          ) == "same"
    np.testing.assert_array_equal(im.predict(x), want)


@pytest.mark.parametrize("n", [1, 2])
def test_swap_leaves_the_loaded_module_unchanged(n, closing):
    # the model serves its own copy: a "same" swap, which writes into the
    # served tensors, never reaches the module the caller loaded
    m = make_model()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    im = (pool(n) if n > 1 else InferenceModel(device="cpu")).load_keras(m)
    closing(im)
    im.warmup(np.zeros((4,), np.float32), buckets=[4])
    assert im.current_params() is not m
    assert im.swap_params(_new_weights(m, 3)) == "same"
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("n", [1, 2])
def test_swap_restructured_to_int8_rewarms(n, closing):
    m = make_model()
    im = (pool(n) if n > 1 else InferenceModel(device="cpu")).load_keras(m)
    closing(im)
    im.warmup(np.zeros((4,), np.float32), buckets=[1, 4])
    q = quantize_model_params(m)
    assert im.swap_params(q.state_dict()) == "restructured"
    assert im.serving_dtype == "int8"
    assert im.warmed_buckets == {1, 4}
    assert len(im.warmup_report) == 2 * n
    x = batch(6)
    want = InferenceModel(device="cpu").load_keras(
        m, quantize="int8").predict(x)
    np.testing.assert_array_equal(im.predict(x), want)
    # and back to f32
    assert im.swap_params(m.state_dict()) == "restructured"
    assert im.serving_dtype == "float32"
    np.testing.assert_allclose(im.predict(x), x @ kernel_of(m), atol=F32_TOL)


def test_swap_before_load_raises():
    with pytest.raises(RuntimeError, match="load"):
        InferenceModel(device="cpu").swap_params({})


def test_replicated_int8_matches_one_replica(closing):
    q = quantize_model_params(make_model())
    im = pool(2).load_keras(q)
    closing(im)
    one = InferenceModel(device="cpu").load_keras(copy.deepcopy(q))
    for seed in range(4):
        np.testing.assert_array_equal(im.predict(batch(seed)),
                                      one.predict(batch(seed)))


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2])
def test_serving_roofline_after_warmup_and_predict(n, closing):
    im = (pool(n) if n > 1 else InferenceModel(device="cpu")).load_keras(
        make_model())
    closing(im)
    acct = get_accountant()
    im.predict(batch())
    assert acct.snapshot("serving")["flops"] == 0.0   # unwarmed: no charge
    im.warmup(np.zeros((4,), np.float32), buckets=[4])
    cost = im._exec_cost[im._cost_key([torch.zeros(4, 4)])]
    assert cost.flops == 2 * 4 * 4 * 3
    for _ in range(3):
        im.predict(batch())                         # bucket 4
    snap = acct.snapshot("serving")
    assert snap["flops"] == 3 * cost.flops and snap["seconds"] > 0
    reg = get_registry()
    assert reg.get("roofline_mfu").value(kind="serving") > 0
    assert reg.get("roofline_hbm_utilization").value(kind="serving") > 0


def test_account_generative_charges_the_counted_program():
    def prefill(p, kv, tokens, length, slot):
        h = p["emb"][torch.as_tensor(tokens).long()] @ p["w"]
        return kv, h[int(length) - 1]

    def step(p, kv, tokens, positions, kv_bucket):
        h = p["emb"][torch.as_tensor(tokens).long()] @ p["w"]
        return kv, h[:, :kv_bucket]

    params = {"emb": np.ones((10, 6), np.float32),
              "w": np.ones((6, 16), np.float32)}
    im = InferenceModel(device="cpu").load_generative(prefill, step, params)
    im.warmup_generative(lambda slots, n: [], slots=2, max_kv_len=8,
                         prompt_buckets=[4], kv_buckets=[8])
    assert set(im.warmup_report) == {"gen-prefill:p4", "gen-step:kv8"}
    acct = get_accountant()
    im.account_generative("step", 8, 0.5)
    im.account_generative("step", 4, 0.5)           # not warmed: nothing
    im.account_generative("decode", 8, 0.5)         # unknown: nothing
    snap = acct.snapshot("serving")
    assert snap["flops"] == 2 * 2 * 6 * 16 and snap["seconds"] == 0.5
    im.account_generative("prefill", 4, 0.25)
    assert acct.snapshot("serving")["flops"] == 2 * 2 * 6 * 16 \
        + 2 * 4 * 6 * 16


# ---------------------------------------------------------------------------
# load_torch
# ---------------------------------------------------------------------------
class _TwoInputs(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Linear(4, 3)
        self.b = nn.Linear(2, 3)

    def forward(self, x, y):
        return self.a(x) + self.b(y)


def test_load_torch_serves_the_module_as_is(closing):
    torch.manual_seed(0)
    mod = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 3))
    x = batch(2, 4)                                 # a whole bucket
    with torch.no_grad():
        want = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        InferenceModel(device="cpu").load_torch(mod).predict(x), want)
    two = pool(2).load_torch(mod)
    closing(two)
    np.testing.assert_array_equal(two.predict(x), want)
    m2 = _TwoInputs()
    y = np.ones((4, 2), np.float32)
    with torch.no_grad():
        want2 = m2(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(
        InferenceModel(device="cpu").load_torch(m2).predict([x, y]), want2)


def test_concurrent_dispatch_through_the_pool(closing):
    """Eight threads dispatching and materializing through a pool of two
    with one permit each: every result right, every permit back."""
    m = make_model()
    im = pool(2, max_inflight_per_replica=1,
              concurrent_num=8).load_keras(m)
    closing(im)
    errors = []

    def worker(seed):
        try:
            for k in range(5):
                x = batch(seed * 10 + k)
                np.testing.assert_allclose(im.predict(x), x @ kernel_of(m),
                                           atol=F32_TOL)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    assert [s["inflight"] for s in im.replica_stats()] == [0, 0]
    assert sum(s["batches"] for s in im.replica_stats()) == 40
