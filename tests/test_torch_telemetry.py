"""The port's training telemetry on the CPU, held against the JAX package
where the JAX package has the same piece: `masked_crc32c`, TensorBoard
event files (written by either package, read by the other), the
Prometheus exposition and the metrics reporter (the JAX package's cases,
run on both packages' copies), `ProfileCapture` on `torch.profiler`
(mirroring JAX `test_profiling_slo.py::TestProfileCapture`), the
prefetch thread, and the trainer's gauges: `training_mfu`, the counted
roofline (`roofline_*{kind="train"}`) and the input-stall accounting.

Counting: FLOPs are `torch.utils.flop_counter`'s (matmul-shaped
operators) plus what each kernel region declares, so a Dense stack counts
exactly 6·B·in·out a layer (4·B·in·out for the first, whose input needs
no gradient) and a tiny BERT exactly its matmuls plus the declared costs
of its flash-attention, dropout and fused-Adam regions. Tiny models, inputs
from a seeded numpy generator.
"""

import logging
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.observability import prometheus as jprom
from analytics_zoo_tpu.observability import registry as jreg
from analytics_zoo_tpu.observability import reporter as jrep
from analytics_zoo_tpu.utils import crc as jcrc
from analytics_zoo_tpu.utils import tensorboard as jtb
from analytics_zoo_tpu_torch.keras import layers as KL
from analytics_zoo_tpu_torch.keras.engine import Sequential
from analytics_zoo_tpu_torch.kernels import dropout as dr
from analytics_zoo_tpu_torch.kernels import flash_attention as fa
from analytics_zoo_tpu_torch.kernels import fused_adam as fad
from analytics_zoo_tpu_torch.learn import trainer
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.models.bert import BERTSQuAD
from analytics_zoo_tpu_torch.observability import capture
from analytics_zoo_tpu_torch.observability import prometheus as tprom
from analytics_zoo_tpu_torch.observability import registry as treg
from analytics_zoo_tpu_torch.observability import reporter as trep
from analytics_zoo_tpu_torch.observability import roofline
from analytics_zoo_tpu_torch.ops import objectives, optimizers
from analytics_zoo_tpu_torch.utils import crc as tcrc
from analytics_zoo_tpu_torch.utils import roofline as peaks
from analytics_zoo_tpu_torch.utils import tensorboard as ttb

PACKAGES = {"jax": (jreg, jprom, jrep, "analytics_zoo_tpu.observability"),
            "torch": (treg, tprom, trep,
                      "analytics_zoo_tpu_torch.observability")}
TINY = dict(vocab=64, hidden_size=32, n_block=2, n_head=2, seq_len=16,
            intermediate_size=64)
H100 = peaks.PEAKS[0]


@pytest.fixture(autouse=True)
def clean_session_roofline():
    yield
    roofline._session["hbm_gbps"] = None
    roofline._session["tflops"] = None


# ---------------------------------------------------------------------------
# CRC, TensorBoard
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 9, 4096, 70_001])
def test_masked_crc32c_matches_jax(n):
    data = np.random.RandomState(n).randint(0, 256, n).astype(
        np.uint8).tobytes()
    assert tcrc.masked_crc32c(data) == jcrc.masked_crc32c(data)
    assert tcrc.crc32c(data) == jcrc.crc32c(data)


@pytest.mark.parametrize("writer_pkg", ["jax", "torch"])
def test_tensorboard_files_cross_read(tmp_path, writer_pkg):
    """Scalars written by one package read back by both, equal."""
    w_mod = jtb if writer_pkg == "jax" else ttb
    with w_mod.SummaryWriter(str(tmp_path)) as w:
        for step in range(3):
            w.scalar("Loss", 1.0 / (step + 1), step)
            w.scalar("val_accuracy", 0.25 * step, step)
    for r_mod in (jtb, ttb):
        got = r_mod.read_scalars(str(tmp_path))
        assert [s for s, _ in got["Loss"]] == [0, 1, 2]
        np.testing.assert_allclose([v for _, v in got["Loss"]],
                                   [1.0, 0.5, 1 / 3], rtol=1e-6)
        assert [v for _, v in got["val_accuracy"]] == [0.0, 0.25, 0.5]
    snap_reg = treg.MetricsRegistry()
    snap_reg.counter("steps_total").inc(4)
    snap_reg.histogram("step_ms").observe(3.0, phase="train")
    with ttb.SummaryWriter(str(tmp_path / "snap")) as w:
        ttb.write_metrics_snapshot(w, snap_reg.snapshot(), 7)
    got = jtb.read_scalars(str(tmp_path / "snap"))
    assert got["steps_total"] == [(7, 4.0)]
    assert got["step_ms/train/count"] == [(7, 1.0)]


def test_inference_summary_reads_back(tmp_path):
    s = ttb.InferenceSummary(str(tmp_path), app_name="bert")
    s.record(64, 2.0, p50_ms=3.0, p99_ms=9.0)
    s.close()
    got = jtb.read_scalars(str(tmp_path / "bert"))
    assert got["Throughput"] == [(1, 32.0)] and got["LatencyP99"] == [(1, 9.0)]


# ---------------------------------------------------------------------------
# Prometheus exposition and the reporter: the JAX package's cases, on both
# ---------------------------------------------------------------------------
def parse_prometheus(text: str):
    """Tiny 0.0.4 parser (as `tests/test_observability.py`'s): returns
    ({name: kind}, [(name, labels, value)])."""
    types, samples = {}, []
    line_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?\s+(\S+)$")
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        m = line_re.match(line)
        assert m, f"unparseable exposition line: {line!r}"
        labels = {}
        if m.group(3):
            for part in re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                   m.group(3)):
                labels[part[0]] = part[1]
        value = float("inf") if m.group(4) == "+Inf" else float(m.group(4))
        samples.append((m.group(1), labels, value))
    return types, samples


def _exposition_registry(reg_mod):
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("http_requests_total", "requests")
    c.inc(3, code="200")
    c.inc(1, code="500")
    reg.gauge("queue_depth", "live depth").set(4, queue="decode")
    h = reg.histogram("stage_ms", "stage time")
    for v in (0.5, 1.0, 2.0, 4.0, 150.0):
        h.observe(v, stage="decode")
    return reg


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_prometheus_round_trip(pkg):
    reg_mod, prom, _, _ = PACKAGES[pkg]
    text = prom.render_prometheus(_exposition_registry(reg_mod))
    assert text.endswith("\n")
    types, samples = parse_prometheus(text)
    assert types == {"http_requests_total": "counter",
                     "queue_depth": "gauge", "stage_ms": "histogram"}
    by = {}
    for name, labels, value in samples:
        by.setdefault(name, []).append((labels, value))
    assert ({"code": "200"}, 3.0) in by["http_requests_total"]
    assert ({"code": "500"}, 1.0) in by["http_requests_total"]
    assert by["queue_depth"] == [({"queue": "decode"}, 4.0)]
    buckets = by["stage_ms_bucket"]
    cum = [v for _, v in buckets]
    assert cum == sorted(cum)
    assert buckets[-1][0]["le"] == "+Inf" and buckets[-1][1] == 5
    les = [float(lb["le"]) for lb, _ in buckets[:-1]]
    assert les == sorted(les)
    assert by["stage_ms_count"] == [({"stage": "decode"}, 5.0)]
    assert by["stage_ms_sum"][0][1] == pytest.approx(157.5)


def test_prometheus_text_equals_jax():
    """The same observations render to the same text in both packages."""
    assert tprom.render_prometheus(_exposition_registry(treg)) == \
        jprom.render_prometheus(_exposition_registry(jreg))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_prometheus_label_escaping(pkg):
    reg_mod, prom, _, _ = PACKAGES[pkg]
    reg = reg_mod.MetricsRegistry()
    reg.counter("odd_total").inc(1, msg='say "hi"\nplease\\now')
    text = prom.render_prometheus(reg)
    assert r'\"hi\"' in text and r"\n" in text and r"\\" in text


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_reporter_digest_line(pkg):
    reg_mod, _, rep, _ = PACKAGES[pkg]
    reg = reg_mod.MetricsRegistry()
    reg.counter("reqs_total").inc(8)
    reg.gauge("depth").set(3)
    reg.histogram("lat_ms").observe(2.0)
    line = rep.digest(reg.snapshot())
    assert "reqs_total=8" in line and "depth=3" in line
    assert "lat_ms=n1" in line


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_reporter_logs_periodically_and_on_stop(pkg, caplog):
    reg_mod, _, rep, logger = PACKAGES[pkg]
    reg = reg_mod.MetricsRegistry()
    reg.counter("ticks_total").inc(5)
    with caplog.at_level("INFO", logger=logger):
        r = rep.MetricsReporter(registry=reg, interval_s=0.05).start()
        time.sleep(0.2)
        r.stop()
    lines = [r.message for r in caplog.records if "metrics:" in r.message]
    assert len(lines) >= 2 and any("ticks_total=5" in m for m in lines)


# ---------------------------------------------------------------------------
# ProfileCapture
# ---------------------------------------------------------------------------
def test_capture_produces_loadable_artifact(tmp_path):
    cap = capture.ProfileCapture(str(tmp_path), max_artifacts=4)
    art = cap.start(tag="unit")
    assert cap.active
    (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    manifest = cap.stop()
    assert not cap.active and manifest["dir"] == art
    assert manifest["files"] == [capture.TRACE_FILE]
    events = capture.load_trace_events(art)
    assert isinstance(events, list) and any(
        "mm" in str(e.get("name", "")) for e in events)


def test_capture_overlap_raises_and_lock_releases(tmp_path):
    cap = capture.ProfileCapture(str(tmp_path))
    cap.start()
    with pytest.raises(capture.CaptureActiveError):
        cap.start()
    cap.stop()
    cap.start()
    cap.stop()


def test_capture_single_flight_is_process_wide(tmp_path):
    a = capture.ProfileCapture(str(tmp_path / "a"))
    b = capture.ProfileCapture(str(tmp_path / "b"))
    a.start()
    try:
        with pytest.raises(capture.CaptureActiveError):
            b.start()
    finally:
        a.stop()


def test_capture_rotation_bounded(tmp_path):
    cap = capture.ProfileCapture(str(tmp_path), max_artifacts=2)
    for i in range(4):
        cap.start(tag=f"r{i}")
        cap.stop()
    arts = cap.artifacts()
    assert len(arts) == 2
    assert arts[-1].endswith("r3") and arts[0].endswith("r2")


def test_idle_capture_starts_nothing(tmp_path):
    threads_before = {t.name for t in threading.enumerate()}
    cap = capture.ProfileCapture(str(tmp_path))
    assert not cap.active
    assert {t.name for t in threading.enumerate()} == threads_before
    assert not os.path.exists(tmp_path / "x")


def test_stack_sampler_samples_matching_threads_and_rides_a_capture(
        tmp_path):
    """The copied `StackSampler` counts frames of the threads it is told
    to, and `capture(seconds)` runs one beside a profiler window."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(500))

    threads = [threading.Thread(target=spin, name=n, daemon=True)
               for n in ("serving-busy-loop", "unrelated-loop")]
    for t in threads:
        t.start()
    try:
        # prefixes of these threads only: other tests' serving threads
        # may still be alive in this process
        with capture.StackSampler(interval_s=0.002, thread_prefixes=(
                "serving-busy", "unrelated-nothing")) as sampler:
            time.sleep(0.2)
        report = sampler.report()
        manifest = capture.ProfileCapture(str(tmp_path)).capture(
            0.05, sample_threads=("serving-busy",), sample_interval_s=0.002)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
        assert not any(t.is_alive() for t in threads)
    assert set(report["threads"]) == {"serving-busy-loop"}
    assert report["threads"]["serving-busy-loop"]["samples"] > 5
    assert any("spin" in f["frame"] for f in
               report["threads"]["serving-busy-loop"]["top"])
    assert "serving-busy-loop" in manifest["host_stacks"]["threads"]
    assert capture.load_trace_events(manifest["dir"])


def _dense_fit(**fit_kw):
    torch.manual_seed(0)
    m = Sequential([KL.Dense(8, input_shape=(4,), device="cpu")])
    est = Estimator.from_keras(m, optimizer="sgd", loss="mse", device="cpu")
    rs = np.random.RandomState(0)
    x = rs.rand(64, 4).astype(np.float32)
    y = rs.rand(64, 8).astype(np.float32)
    return est.fit((x, y), epochs=1, batch_size=8, **fit_kw)


def test_fit_profile_steps_window(tmp_path):
    hist = _dense_fit(profile_steps=(2, 4), profile_dir=str(tmp_path))
    arts = hist["profile_artifacts"]
    assert len(arts) == 1 and os.path.isdir(arts[0])
    assert re.search(r"fit-it2$", arts[0])
    assert capture.load_trace_events(arts[0])


def test_fit_profile_steps_validation():
    with pytest.raises(ValueError, match="profile_steps"):
        _dense_fit(profile_steps=(4, 2))


def test_failed_capture_logs_and_the_fit_goes_on(tmp_path, caplog):
    """Another capture holds the profiler: the window's start fails, the
    fit logs it and finishes."""
    other = capture.ProfileCapture(str(tmp_path / "other"))
    other.start()
    try:
        with caplog.at_level("WARNING"):
            hist = _dense_fit(profile_steps=(1, 3),
                              profile_dir=str(tmp_path))
    finally:
        other.stop()
    assert len(hist["loss"]) == 1 and "profile_artifacts" not in hist
    assert any("profiler capture failed" in r.message
               for r in caplog.records)


# ---------------------------------------------------------------------------
# The prefetch thread
# ---------------------------------------------------------------------------
def test_prefetcher_keeps_order():
    p = trainer._Prefetcher(iter(range(20)), lambda i: 2 * i, depth=2)
    assert list(p) == [2 * i for i in range(20)]


def test_prefetcher_raises_the_workers_error_in_the_consumer():
    def source():
        yield 1
        yield 2
        raise OSError("disk gone")
    p = trainer._Prefetcher(source(), lambda i: i, depth=4)
    assert next(p) == 1 and next(p) == 2
    with pytest.raises(OSError, match="disk gone"):
        next(p)


def test_prefetcher_close_retires_the_worker():
    def endless():
        i = 0
        while True:
            yield i
            i += 1
    p = trainer._Prefetcher(endless(), lambda i: i, depth=2)
    assert next(p) == 0
    p.close()
    p._t.join(timeout=5)
    assert not p._t.is_alive()


def test_prefetcher_accounts_each_wait():
    waits = []

    def slow():
        for i in range(4):
            time.sleep(0.05)
            yield i
    p = trainer._Prefetcher(slow(), lambda i: i, depth=2,
                            on_wait=waits.append)
    assert list(p) == [0, 1, 2, 3]
    assert len(waits) == 5                      # four items and the end
    assert p.wait_s == pytest.approx(sum(waits))
    assert p.wait_s >= 0.1                      # the consumer outran it


def _squad(seed=3, **kw):
    m = BERTSQuAD(use_flash=True, device="cpu", **TINY, **kw)
    m.build(torch.Generator().manual_seed(seed))
    m._mark_built()
    return m


def _squad_data(n=8, seed=0):
    rs = np.random.RandomState(seed)
    T = TINY["seq_len"]
    mask = (np.arange(T)[None, :] < rs.randint(6, T + 1, n)[:, None])
    start = rs.randint(5, 10, n).astype(np.int32)
    return {"x": [rs.randint(0, TINY["vocab"], (n, T)).astype(np.int32),
                  np.zeros((n, T), np.int32), mask.astype(np.float32)],
            "y": [start, start + 2]}


def _squad_fit(model, data, **fit_kw):
    loss = objectives.get("sparse_categorical_crossentropy", from_logits=True)
    h = Estimator.from_keras(model, optimizer=optimizers.fused_adam(1e-3),
                             loss=[loss, loss], device="cpu").fit(
        data, epochs=2, batch_size=4, fused_optimizer=True, **fit_kw)
    return h["loss"], {k: v.detach().clone()
                       for k, v in model.state_dict().items()}


def _bitwise(a, b):
    (la, pa), (lb, pb) = a, b
    return la == lb and all(torch.equal(pa[k], pb[k]) for k in pa)


def test_fit_with_prefetch_equals_without():
    data = _squad_data()
    assert _bitwise(_squad_fit(_squad(), data, device_cache=False),
                    _squad_fit(_squad(), data, prefetch=False,
                               device_cache=False))


def test_batch_iter_factory_feeds_the_fit():
    """A factory yielding the in-memory batches in order gives the fit of
    the arrays themselves (shuffle off), through the prefetch thread."""
    data = _squad_data()
    loss = objectives.get("sparse_categorical_crossentropy", from_logits=True)

    def fit(**kw):
        model = _squad()
        model.compile(optimizers.fused_adam(1e-3), [loss, loss])
        h = trainer.fit_keras(model, batch_size=4, epochs=2,
                              fused_optimizer=True, **kw)
        return h["loss"], {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
    want = fit(x=data["x"], y=data["y"], shuffle=False)
    got = fit(x=None, batch_iter_factory=lambda epoch: trainer.iter_batches(
        data["x"], data["y"], 4), prefetch_depth=1)
    assert _bitwise(got, want)


# ---------------------------------------------------------------------------
# Gauges and the counted roofline
# ---------------------------------------------------------------------------
def test_peak_table_is_the_h100s_for_every_device():
    assert H100[1:] == (989e12, 67e12, 3.35e12, 1979e12)
    assert peaks.peak_flops("cpu") == 989e12
    assert peaks.peak_flops("cpu", torch.int8) == 1979e12
    assert peaks.peak_flops("NVIDIA H100 80GB HBM3", torch.float32) == 67e12
    assert peaks.peak_hbm("Some Other Card") == 3.35e12


def test_training_metrics_epoch_math():
    reg = treg.MetricsRegistry()
    tm = trainer._TrainingMetrics(registry=reg)
    step_ms = tm.epoch(steps=4, n_seen=32, dt=2.0, mean_loss=0.5,
                       flops_per_step=1e12, device="cpu")
    assert step_ms == 500.0
    assert reg.get("training_mfu").value() == 1e12 * 4 / 2.0 / 989e12
    assert reg.get("training_samples_per_sec").value() == 16.0
    assert reg.get("training_steps_total").value() == 4


def test_fit_publishes_training_metrics_and_mfu():
    """`training_mfu` is flops_per_step · steps / dt / peak, on the same
    dt as the throughput gauge: mfu = fps · steps · (samples/s) /
    (samples · peak)."""
    reg = treg.get_registry()
    prev = reg.snapshot()
    fps = 3e9
    _dense_fit(flops_per_step=fps, device_cache=False)
    d = reg.delta(prev)
    assert d["training_steps_total"]["series"][0]["value"] == 8
    assert d["training_samples_total"]["series"][0]["value"] == 64
    assert d["training_epochs_total"]["series"][0]["value"] == 1
    sps = reg.get("training_samples_per_sec").value()
    assert reg.get("training_mfu").value() == pytest.approx(
        fps * 8 * sps / (64 * 989e12), rel=1e-12)
    assert 0.0 <= reg.get("training_input_bound").value() <= 1.0
    types, _ = parse_prometheus(tprom.render_prometheus(reg))
    assert types["training_step_ms"] == "histogram"
    assert types["training_input_wait_ms"] == "histogram"


def test_accountant_math_and_session_roofline():
    reg = treg.MetricsRegistry()
    acct = roofline.RooflineAccountant(registry=reg)
    roofline.set_session_roofline(hbm_gbps=100.0, tflops=10.0, registry=reg)
    acct.account("train", flops=2e12, bytes_=20e9, seconds=2.0)
    assert reg.get("roofline_flops_total").value(kind="train") == 2e12
    assert reg.get("roofline_achieved_tflops").value(
        kind="train") == pytest.approx(1.0)
    assert reg.get("roofline_mfu").value(kind="train") == pytest.approx(0.1)
    assert reg.get("roofline_hbm_utilization").value(
        kind="train") == pytest.approx(0.1)
    acct.account("train", -1.0, 0.0, 0.0)            # never raises
    assert acct.snapshot("train")["seconds"] == 2.0


def test_dense_stack_counts_six_flops_a_parameter_a_row():
    """Per step: 6·B·in·out a layer, 4·B·in·out for the first (no input
    gradient); sgd's elementwise update and the loss count none."""
    torch.manual_seed(0)
    dims = [16, 32, 32, 8]
    model = Sequential([KL.Dense(dims[1], input_shape=(dims[0],),
                                 device="cpu")]
                       + [KL.Dense(o, device="cpu") for o in dims[2:]])
    rs = np.random.RandomState(0)
    x = rs.rand(64, dims[0]).astype(np.float32)
    y = rs.rand(64, dims[-1]).astype(np.float32)
    Estimator.from_keras(model, optimizer="sgd", loss="mse",
                         device="cpu").fit((x, y), epochs=1, batch_size=16)
    snap = roofline.get_accountant().snapshot("train")
    B = 16
    per_step = 4 * B * dims[0] * dims[1] + sum(
        6 * B * i * o for i, o in zip(dims[1:-1], dims[2:]))
    assert snap["flops"] == 4 * per_step
    assert snap["bytes"] > 4 * 4 * sum(i * o for i, o in zip(dims, dims[1:]))
    mfu = roofline.get_accountant().snapshot("train")["mfu"]
    assert mfu == snap["flops"] / snap["seconds"] / 989e12


def test_tiny_bert_counts_its_matmuls_plus_the_declared_kernel_costs():
    """A SQuAD step: the dense matmuls (6 FLOPs a weight a token, the
    pooler forward only: its output feeds no loss), plus the kernel
    regions' declared costs — flash forward 2 products and backward 3 + 4
    a block (JAX `_attn_cost`), 3 FLOPs an element for each dropout pass
    (the embedding's and two a block, forward and backward), 12 an element
    for the fused-Adam sweep."""
    model = _squad()
    data = _squad_data(n=4)
    loss = objectives.get("sparse_categorical_crossentropy", from_logits=True)
    Estimator.from_keras(model, optimizer=optimizers.fused_adam(1e-3),
                         loss=[loss, loss], device="cpu").fit(
        data, epochs=1, batch_size=4, fused_optimizer=True)
    B, T, D, F = 4, TINY["seq_len"], TINY["hidden_size"], \
        TINY["intermediate_size"]
    L, H = TINY["n_block"], TINY["n_head"]
    N = B * T
    matmuls = 6 * N * L * (3 * D * D + D * D + 2 * D * F) \
        + 2 * B * D * D + 6 * N * D * 2
    attn = L * (2 + 3 + 4) * 2 * B * H * T * T * (D // H)
    drop = 2 * (1 + 2 * L) * 3 * N * D
    adam = 12 * sum(p.numel() for p in model.parameters())
    snap = roofline.get_accountant().snapshot("train")
    assert snap["flops"] == matmuls + attn + drop + adam
    memo = [c for k, c in model._roofline_cost_memo[(False, False, True)]
            .items() if k != trainer._StepCostTracker.HARVEST_KEY]
    assert len(memo) == 1
    assert memo[0].kernel_flops == attn + drop + adam


def test_kernel_region_counts_the_declared_cost_not_the_plain_ops():
    """On the CPU the plain version runs inside the region: the meter
    adds the declared cost and skips the plain version's operators, so a
    flash call counts what the kernel declares on the card."""
    q = torch.randn(2, 2, 16, 8, requires_grad=True)
    k, v = torch.randn(2, 2, 16, 8), torch.randn(2, 2, 16, 8)

    def step():
        o = fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=5)
        return torch.autograd.grad(o.sum(), q)
    _, cost = roofline.count_cost(step)
    f_fwd, b_fwd = fa._fwd_cost(q)
    f_bwd, b_bwd = fa._bwd_cost(q)
    assert cost.kernel_flops == cost.flops == f_fwd + f_bwd
    assert cost.kernel_bytes == b_fwd + b_bwd
    x = torch.randn(64, 8)
    c = roofline.cost_of(dr.dropout_apply, x, 0.5, 3)
    assert (c.flops, c.bytes) == dr.dropout_cost(x)
    ps = [torch.zeros(3, 5), torch.zeros(7, dtype=torch.bfloat16)]
    c = roofline.cost_of(fad._sweep, ps, [torch.zeros(p.shape) for p in ps],
                         [torch.zeros(p.shape) for p in ps],
                         [torch.ones(p.shape) for p in ps], (1e-3, 1e-8, 0.0),
                         0.9, 0.999)
    assert c.flops == 12 * 22
    assert c.bytes == 15 * (4 + 8 + 16) + 7 * (4 + 4 + 16)


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_harvest_leaves_the_fit_bitwise_unchanged(monkeypatch,
                                                  mixed_precision):
    """The counted first step computes what an uncounted one computes:
    a fit with the harvest and one with it disabled agree bit for bit
    (dropout on)."""
    data = _squad_data()
    with_harvest = _squad_fit(_squad(), data,
                              mixed_precision=mixed_precision)
    monkeypatch.setattr(trainer._StepCostTracker, "step_fn",
                        lambda self, one_step, batch: one_step)
    without = _squad_fit(_squad(), data, mixed_precision=mixed_precision)
    assert _bitwise(with_harvest, without)


def test_harvest_runs_once_per_signature_and_model():
    model = _squad()
    data = _squad_data()
    _squad_fit(model, data)
    memo = model._roofline_cost_memo[(False, False, True)]
    assert len(memo[trainer._StepCostTracker.HARVEST_KEY]) == 1
    _squad_fit(model, data)                         # warm: counts nothing
    assert len(memo[trainer._StepCostTracker.HARVEST_KEY]) == 1
    assert roofline.get_accountant().snapshot("train")["flops"] > 0
    loss = objectives.get("sparse_categorical_crossentropy", from_logits=True)
    model.compile("adam", [loss, loss])             # a recompile forgets
    assert not hasattr(model, "_roofline_cost_memo")


def test_set_tensorboard_and_reporter_mirror_the_fit(tmp_path, caplog):
    """`set_tensorboard` (on the model and through ZooModel) writes the
    epoch scalars the JAX package writes, under `<dir>/<app>/train`;
    `metrics_report_s` logs digests and mirrors them there too."""
    torch.manual_seed(0)
    m = Sequential([KL.Dense(8, input_shape=(4,), device="cpu")])
    m.set_tensorboard(str(tmp_path), "app")
    m.compile("sgd", "mse")
    rs = np.random.RandomState(0)
    x = rs.rand(32, 4).astype(np.float32)
    y = rs.rand(32, 8).astype(np.float32)
    with caplog.at_level(logging.INFO,
                         logger="analytics_zoo_tpu_torch.observability"):
        m.fit(x, y, batch_size=8, nb_epoch=2, validation_data=(x, y),
              metrics_report_s=60.0)
    got = jtb.read_scalars(str(tmp_path / "app" / "train"))
    assert [s for s, _ in got["Loss"]] == [4, 8]
    assert {"Throughput", "StepTime_ms", "val_loss",
            "training_steps_total"} <= set(got)
    assert any("metrics:" in r.message for r in caplog.records)


@pytest.mark.gpu
def test_pinned_prefetch_equals_pageable_on_gpu():
    """On the card the prefetcher uploads through pinned staging buffers
    on a side stream; the losses and parameters are bitwise those of the
    in-loop pageable upload."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    data = _squad_data(n=16)
    runs = []
    for prefetch in (True, False):
        m = BERTSQuAD(use_flash=True, **TINY)
        m.build(torch.Generator().manual_seed(3))
        m._mark_built()
        loss = objectives.get("sparse_categorical_crossentropy",
                              from_logits=True)
        h = Estimator.from_keras(m, optimizer=optimizers.fused_adam(1e-3),
                                 loss=[loss, loss]).fit(
            data, epochs=2, batch_size=4, fused_optimizer=True,
            mixed_precision=True, prefetch=prefetch, device_cache=False)
        runs.append((h["loss"], {k: v.detach().cpu().clone()
                                 for k, v in m.state_dict().items()}))
    assert _bitwise(*runs)
