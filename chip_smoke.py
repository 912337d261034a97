#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`analytics_zoo_tpu_torch`) on one NVIDIA
GPU: build its kernels, hold each against its plain PyTorch version, serve
a full-width BERT-base classifier through the port's `InferenceModel`, and
print what it measured.

    python3 chip_smoke.py [--seed N]

Run it from the repository root on a host with an H100 (sm_90a) and the
CUDA toolkit. Phases, in order; any failure exits non-zero:

1. device and build: the card's name and power limit (nvidia-smi), the
   build of every kernel from `analytics_zoo_tpu_torch/csrc/`;
2. kernels against their plain versions on the card, one JSON line per
   case, with the error, its tolerance and the times of the kernel, the
   plain version and the PyTorch library call of the same function;
3. serving: BERT-base (vocab 30522, hidden 768, 12 blocks, 12 heads,
   intermediate 3072, seq 512, 2 classes, `use_flash=True`) with random
   weights from the seed, warmed over buckets 1-32, answering requests of
   batch 1, 3, 8 and 32 in f32 and bf16; launches counted; a profiled
   window of batch-32 predicts (device time by kernel, idle share); logits
   checked against the same weights served by the port on the CPU;
4. a `kernels` line listing every kernel of the port;
5. the last line, `{"ok": true, "device": {...}}`.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from analytics_zoo_tpu_torch import convert  # noqa: E402
from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build  # noqa: E402
from analytics_zoo_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from analytics_zoo_tpu_torch.models.bert import BERTClassifier  # noqa: E402
from analytics_zoo_tpu_torch.serving.inference_model import \
    InferenceModel  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense): the least time the
# card could take is max(FLOP / peak of the dtype, bytes / memory rate). An
# f32 check runs without TF32, so its peak is the CUDA cores' f32 rate.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
MEM_BYTES_PER_S = 3.35e12

KERNELS = [{
    "name": fa.KERNEL_NAME,
    "route": "cuda",
    "source": "analytics_zoo_tpu_torch/csrc/" + fa.SOURCE,
    "replaces": "analytics_zoo_tpu/pallas/flash_attention.py:217",
}]

# Phase 2 cases: the slice's shape (BERT-base at seq 512, batch 8) and the
# smallest and largest buckets phase 3 serves, a ragged T, the widest head
# the kernel takes, and a head dim that is not a multiple of 4 (read
# element by element).
ATTN_SHAPES = [(8, 12, 512, 64), (1, 12, 512, 64), (32, 12, 512, 64),
               (2, 12, 200, 64), (2, 4, 256, 128), (2, 3, 45, 30)]
MAIN_SHAPE = ATTN_SHAPES[0]
# Kernel vs plain version, max abs error. f32: both sum in f32, in another
# order (the kernel scales then adds the mask and divides by l at the end;
# the plain version divides by √D first) — rounding only. bf16: the plain
# version rounds q·kᵀ and the softmax weights to bf16 before the PV
# product, where the kernel keeps both in f32, and O is stored in bf16
# (2^-9 relative). lse is f32 from the same products in both.
ATTN_TOL = {torch.float32: {"o": 2e-5, "lse": 1e-4},
            torch.bfloat16: {"o": 3e-2, "lse": 1e-4}}

BERT_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                 seq_len=512, intermediate_size=3072)
NUM_CLASSES = 2
REQUEST_BATCHES = (1, 3, 8, 32)
REQUESTS_PER_BATCH = 50
# Logits of the card against the port's CPU run of the same weights. f32:
# the CPU tests hold a 2-block width-64 toy to 1e-4 against JAX; 12 blocks
# at width 768 sum longer, in cuBLAS's order instead of the CPU's — 5e-4.
# bf16 against the f32 card result: every weight and activation rounds to
# 8 bits of mantissa through 12 blocks — 5e-2 on logits of scale ~0.3.
LOGIT_TOL = {"float32": 5e-4, "bfloat16": 5e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device ms per call over `reps` calls, by CUDA events, after
    three warm calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(shape, dtype):
    """(ms, "bytes" | "operations"): the least time for one forward. FLOP:
    QKᵀ and PV, 2·T²·D each per head, every key scored (the kernel skips
    none, masked or not). Bytes: q, k, v read and O written once in the
    dtype, the f32 mask read and the f32 lse written once."""
    B, H, T, D = shape
    item = torch.finfo(dtype).bits // 8
    flops = 4.0 * B * H * T * T * D
    nbytes = 4.0 * B * H * T * D * item + B * T * 4 + B * H * T * 4
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def padding_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    keep = torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]
    return ((~keep).float() * -10000.0)[:, None, None, :].contiguous()


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def phase_device_and_build():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's smoke run needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    per_source = _build.build([fa.SOURCE])
    ptxas = [line.strip() for line in _build.build_log(fa.SOURCE).splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "ptxas": ptxas,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": card})
    return card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def phase_kernels(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    failed = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for shape in ATTN_SHAPES:
        B, H, T, D = shape
        for masked in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn(shape, device="cuda", generator=gen)
                           .to(dtype) for _ in range(3))
                mask = None
                if masked:
                    lengths = torch.randint(1, T + 1, (B,), device="cuda",
                                            generator=gen)
                    mask = padding_mask(lengths, T)
                before = LAUNCHES.get(fa.KERNEL_NAME)
                out, lse = fa.flash_attention_fwd(q, k, v, mask)
                torch.cuda.synchronize()
                ref = fa._reference_attention(q, k, v, mask)
                ref_lse = fa._reference_lse(q, k, mask)
                err_o = (out.float() - ref.float()).abs().max().item()
                err_lse = (lse - ref_lse).abs().max().item()
                tol = ATTN_TOL[dtype]
                ok = (err_o <= tol["o"] and err_lse <= tol["lse"]
                      and bool(torch.isfinite(out).all()))
                reps = 20 if T >= 512 else 50
                kernel_ms = time_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, mask), reps)
                plain_ms = time_ms(lambda: fa._reference_attention(
                    q, k, v, mask), reps)
                lib_mask = None if mask is None else mask.to(dtype)
                library_ms = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, attn_mask=lib_mask), reps)
                bound_ms, bound_by = attention_bound(shape, dtype)
                row = {"phase": "kernel", "kernel": fa.KERNEL_NAME,
                       "shape": list(shape), "dtype": str(dtype)[6:],
                       "masked": masked, "max_abs_err_o": err_o,
                       "max_abs_err_lse": err_lse, "tol_o": tol["o"],
                       "tol_lse": tol["lse"], "ok": ok,
                       "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by,
                       "launches": LAUNCHES.get(fa.KERNEL_NAME) - before,
                       "card": card}
                emit(row)
                results[(shape, masked, dtype)] = row
                if not ok:
                    failed.append(row)
    if failed:
        raise SystemExit(f"chip_smoke: {len(failed)} kernel case(s) outside "
                         "tolerance")
    return results


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------
def random_classifier_tree(cfg, num_classes: int, seed: int):
    """BERTClassifier weights in the JAX package's tree layout, random from
    `seed`: Glorot-uniform kernels, N(0, 0.02) embeddings and biases, LN
    gains 1 + N(0, 0.02)."""
    rs = np.random.default_rng(seed)
    D, F = cfg["hidden_size"], cfg["intermediate_size"]

    def glorot(n_in, n_out):
        lim = math.sqrt(6.0 / (n_in + n_out))
        return rs.uniform(-lim, lim, (n_in, n_out)).astype(np.float32)

    def small(*shape):
        return rs.standard_normal(shape, dtype=np.float32) * 0.02

    def ln():
        return {"gamma": 1.0 + small(D), "beta": small(D)}

    bert = {"word_embeddings": small(cfg["vocab"], D),
            "position_embeddings": small(cfg["seq_len"], D),
            "token_type_embeddings": small(2, D),
            "emb_ln": ln(),
            "pooler_kernel": glorot(D, D), "pooler_bias": small(D)}
    for i in range(cfg["n_block"]):
        bert[f"bert_block{i}"] = {
            "attn": {"qkv_kernel": glorot(D, 3 * D), "qkv_bias": small(3 * D),
                     "out_kernel": glorot(D, D), "out_bias": small(D)},
            "ln1": ln(), "ln2": ln(),
            "ffn_in_kernel": glorot(D, F), "ffn_in_bias": small(F),
            "ffn_out_kernel": glorot(F, D), "ffn_out_bias": small(D)}
    return {"bert": bert, "cls_kernel": small(D, num_classes),
            "cls_bias": small(num_classes)}


def make_request(rs, batch: int, cfg):
    T = cfg["seq_len"]
    ids = rs.integers(0, cfg["vocab"], (batch, T), dtype=np.int64)
    lengths = rs.integers(32, T + 1, batch)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int64)
    return [ids, mask]


def check_logits(name, got, want, tol):
    err = float(np.abs(got - want).max())
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    ok = (got.shape == want.shape and bool(np.isfinite(got).all())
          and err <= tol)
    emit({"phase": "serving_check", "check": name, "max_abs_err": err,
          "rel_l2_err": rel, "tol": tol, "logit_abs_max":
          float(np.abs(want).max()), "ok": ok})
    if not ok:
        raise SystemExit(f"chip_smoke: {name} outside tolerance")


def profile_predict(im, x, p50_ms: float, reps: int = 3):
    """Where a forward's device time goes: torch.profiler over `reps`
    predicts, device time of the kernels (and copies) summed by name;
    operator-level rows are left out, since they repeat their kernels'
    time. The idle share compares device time per predict with the
    unprofiled predict p50."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            im.predict(x)
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.key, e.self_device_time_total / 1e3 / reps,
                         e.count / reps))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"phase": "profile", "device_ms_per_predict": device_ms,
            "predict_p50_ms": p50_ms,
            "idle_share": (1.0 - device_ms / p50_ms) if device_ms else None,
            "top": [{"kernel": name[:96], "ms": ms,
                     "share": ms / device_ms, "calls": calls}
                    for name, ms, calls in rows[:10]]}


def phase_serving(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BERT_BASE
    t0 = time.perf_counter()
    state = convert.params_from_jax(
        random_classifier_tree(cfg, NUM_CLASSES, seed))
    model = BERTClassifier(NUM_CLASSES, use_flash=True, device="cuda", **cfg)
    model.load_state_dict(state)
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    servers = {}
    for dtype_name, m in (("float32", model), ("bfloat16", model_bf16)):
        im = InferenceModel(max_batch=32).load_keras(m)
        if im.serving_dtype != dtype_name:
            raise SystemExit(f"chip_smoke: serving {im.serving_dtype}, "
                             f"expected {dtype_name}")
        T = cfg["seq_len"]
        im.warmup([np.zeros(T, np.int64), np.ones(T, np.int64)])
        emit({"phase": "warmup", "dtype": dtype_name,
              "buckets": sorted(im.warmed_buckets),
              "seconds": im.warmup_report})
        servers[dtype_name] = im
    emit({"phase": "load", "seconds": time.perf_counter() - t0})

    rs = np.random.default_rng(seed + 1)
    requests = {b: [make_request(rs, b, cfg)
                    for _ in range(REQUESTS_PER_BATCH)]
                for b in REQUEST_BATCHES}
    check_batch = make_request(rs, 3, cfg)

    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    forwards = 0
    latencies = {}
    outputs = {}
    for dtype_name, im in servers.items():
        for b in REQUEST_BATCHES:
            times = []
            for x in requests[b]:
                t1 = time.perf_counter()
                out = im.predict(x)
                times.append((time.perf_counter() - t1) * 1e3)
                forwards += 1
                if out.shape != (b, NUM_CLASSES) or not np.isfinite(out).all():
                    raise SystemExit(f"chip_smoke: bad output {out.shape} "
                                     f"for batch {b} ({dtype_name})")
            latencies[(dtype_name, b)] = times
        outputs[dtype_name] = im.predict(check_batch)
        forwards += 1
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    for (dtype_name, b), times in latencies.items():
        emit({"phase": "serving", "dtype": dtype_name, "batch": b,
              "seq_len": cfg["seq_len"], "requests": len(times),
              "p50_ms": float(np.percentile(times, 50)),
              "p80_ms": float(np.percentile(times, 80)),
              "p99_ms": float(np.percentile(times, 99)),
              "mean_ms": float(np.mean(times)), "card": card})
    launches = counts.get(fa.KERNEL_NAME, 0)
    per_forward = launches / forwards
    emit({"phase": "serving_launches", "counts": counts,
          "forwards": forwards, "flash_per_forward": per_forward})
    if launches != cfg["n_block"] * forwards:
        raise SystemExit(f"chip_smoke: {launches} flash launches over "
                         f"{forwards} forwards, expected "
                         f"{cfg['n_block']} per forward")
    missing = [k["name"] for k in KERNELS if counts.get(k["name"], 0) == 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernels not launched on the main "
                         f"path: {missing}")

    # one forward is exactly 12 launches; the full-mask route launches none
    LAUNCHES.reset()
    servers["float32"].predict(check_batch)
    one = LAUNCHES.get(fa.KERNEL_NAME)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    q, k, v = (torch.randn((1, 12, 512, 64), device="cuda", generator=gen)
               for _ in range(3))
    full = torch.triu(torch.full((512, 512), -10000.0, device="cuda"),
                      diagonal=1)[None, None]
    full_out = fa.flash_attention(q, k, v, mask=full)
    full_err = (full_out - fa._reference_attention(q, k, v, full)
                ).abs().max().item()
    full_launches = LAUNCHES.get(fa.KERNEL_NAME) - one
    emit({"phase": "routing", "launches_one_forward": one,
          "launches_full_mask": full_launches, "full_mask_err": full_err})
    if one != cfg["n_block"] or full_launches != 0 or full_err > 1e-6:
        raise SystemExit("chip_smoke: routing check failed")

    for dtype_name, im in servers.items():
        b = REQUEST_BATCHES[-1]
        p50 = float(np.percentile(latencies[(dtype_name, b)], 50))
        emit(dict(profile_predict(im, requests[b][0], p50),
                  dtype=dtype_name, batch=b, card=card))

    # the same weights served by the port on the CPU (plain attention)
    cpu_model = BERTClassifier(NUM_CLASSES, use_flash=True, device="cpu",
                               **cfg)
    cpu_model.load_state_dict(state)
    t1 = time.perf_counter()
    cpu_logits = InferenceModel(max_batch=32, device="cpu").load_keras(
        cpu_model).predict(check_batch)
    emit({"phase": "cpu_reference", "seconds": time.perf_counter() - t1})
    check_logits("card_f32_vs_cpu_f32", outputs["float32"], cpu_logits,
                 LOGIT_TOL["float32"])
    check_logits("card_bf16_vs_card_f32", outputs["bfloat16"],
                 outputs["float32"], LOGIT_TOL["bfloat16"])
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    card = phase_device_and_build()
    attn = phase_kernels(card, args.seed)
    counts = phase_serving(card, args.seed)
    main_case = attn[(MAIN_SHAPE, True, torch.float32)]
    kernels = []
    for spec in KERNELS:
        kernels.append(dict(
            spec, launches=counts.get(spec["name"], 0),
            max_abs_err=main_case["max_abs_err_o"], ms=main_case["kernel_ms"],
            plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"],
            shape=main_case["shape"], dtype=main_case["dtype"],
            verdict="ok" if all(r["ok"] for r in attn.values()) else "fail",
            card=card))
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
