#!/usr/bin/env python3
"""Fused-Adam sources A/B on one NVIDIA GPU: copies of
`analytics_zoo_tpu_torch/csrc/fused_adam.cu` (older commits with the same
C interface, or variants) on the same leaves, timed in turns, round after
round.

Leaf mixes: the fused-Adam phase's of `chip_smoke.py`, drawn the same
way: ResNet-50's 161 leaves in f32 (conv kernels channels_last) and
BERT-base's 153 leaves in f32 and in bf16. Each source builds with nvcc
(the repository's flags, `csrc/` on the include path), reports its chunk
and leaves a launch (`azt_fused_adam_config`), and steps one sweep from
the same state, held bit for bit against the plain version. Times are
device ms of a sweep (`chip_smoke.device_ms`: the profiler's kernel time
over 10 sweeps); every round times each source once, in the order given,
so a drift of the card shows as a spread across rounds rather than as a
gap between sources. Each round also times the host side of the
repository's own sweep (`fused_adam_step`: the host's ms to issue it, as
`chip_smoke.host_ms` reads it) with its checked leaves remembered, as the
training paths run it, and with every leaf checked again on every call
(the remembered leaves dropped before each sweep).

    mkdir -p _archive_check/v1
    cp analytics_zoo_tpu_torch/csrc/fused_adam.cu _archive_check/v1/
    # ... edit the copy ...
    python3 scripts/fused_adam_ab.py \\
        new=analytics_zoo_tpu_torch/csrc/fused_adam.cu \\
        v1=_archive_check/v1/fused_adam.cu --rounds 3

Prints the card's name and power limit, then each source's registers
(ptxas) and launch geometry, then one JSON line per leaf mix: for each
source its device ms per round, their median, its share of the bound
and its max abs error against the plain version; the wrapper's host ms a
sweep per round, remembered and checked every call, and their medians.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from analytics_zoo_tpu_torch.kernels import _build  # noqa: E402
from analytics_zoo_tpu_torch.kernels import fused_adam as fad  # noqa: E402
from analytics_zoo_tpu_torch.models.bert import BERTClassifier  # noqa: E402
from analytics_zoo_tpu_torch.models.image import resnet  # noqa: E402


def build(sources: dict) -> dict:
    """{label: (multi-launch function, geometry, registers)}, one nvcc a
    source, all started together."""
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {label: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
         "-o", str(out_dir / f"adam_{label}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, src in sources.items()}
    built = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{label}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"adam_{label}.so"))
        fn = lib.azt_fused_adam_multi
        fn.argtypes = fad.MULTI_ARGTYPES
        fn.restype = ctypes.c_int
        cfg_fn = lib.azt_fused_adam_config
        cfg_fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        out = (ctypes.c_longlong * 5)()
        if cfg_fn(out):
            raise SystemExit(f"{label}: azt_fused_adam_config failed")
        cfg = dict(zip(("chunk", "max_leaves", "threads", "sms",
                        "blocks_per_sm"), list(out)))
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        built[label] = (fn, cfg, regs)
    return built


def sweep_fn(fn, cfg, table, scalars):
    """One sweep of a source over `table` (from `fad._build_table`),
    planned at the source's own chunk size and leaves a launch."""
    a, b, lrwd = scalars
    hp = cs.ADAM_HP
    b1, b2 = hp["b1"], hp["b2"]
    table = table._replace(launches=fad._launch_plan(
        table.numel, cfg["max_leaves"], cfg["chunk"]))

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        for args in fad.launch_args(table):
            rc = fn(*args, a, b, lrwd, b1, b2, 1.0 - b1, 1.0 - b2, stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
    return call


def run_mix(built, leaves, pdtype, gen, mix: str, rounds: int):
    def rnd(t, s=1.0, dtype=torch.float32):
        fmt = torch.channels_last if t.dim() == 4 and t.is_contiguous(
            memory_format=torch.channels_last) and not t.is_contiguous() \
            else torch.contiguous_format
        return (torch.randn(t.shape, device="cuda", generator=gen)
                * s).to(dtype).contiguous(memory_format=fmt)
    params = {i: rnd(t, 0.02, pdtype) for i, t in enumerate(leaves)}
    mu = {i: rnd(t, 1e-3) for i, t in enumerate(leaves)}
    nu = {i: rnd(t, 1e-3) ** 2 for i, t in enumerate(leaves)}
    grads = {i: rnd(t, 1e-2, pdtype) for i, t in enumerate(leaves)}
    start = [{i: t.clone() for i, t in d.items()} for d in (params, mu, nu)]
    plain = [{i: t.clone() for i, t in d.items()} for d in start]
    cs.plain_adam_sweep(*plain, grads, 1)
    hp = cs.ADAM_HP
    scalars = fad._fold_scalars(1, hp["lr"], hp["b1"], hp["b2"], hp["eps"],
                                hp["weight_decay"])
    names = list(params)
    table = fad._build_table([params[i] for i in names],
                             [mu[i] for i in names], [nu[i] for i in names],
                             [grads[i] for i in names])
    calls = {label: sweep_fn(fn, cfg, table, scalars)
             for label, (fn, cfg, _) in built.items()}
    flops, nbytes = fad.update_cost(params, grads)
    bound_ms = max(nbytes / cs.MEM_BYTES_PER_S,
                   flops / cs.PEAK_FLOPS[torch.float32]) * 1e3
    row = {"leaf_mix": mix, "param_dtype": str(pdtype)[6:],
           "leaves": len(leaves), "elements": sum(t.numel() for t in leaves),
           "bound_ms": bound_ms, "max_abs_err": {}, "ms": {}}
    for label, call in calls.items():
        for d, s in zip((params, mu, nu), start):
            for i in d:
                d[i].copy_(s[i])
        call()
        torch.cuda.synchronize()
        row["max_abs_err"][label] = cs.adam_max_err((params, mu, nu), plain)

    def wrapper_sweep():
        cs.adam_sweep(params, mu, nu, grads, 2)

    def checked_sweep():
        fad._STATES.clear()
        wrapper_sweep()
    host = {"remembered": [], "checked_every_call": []}
    for _ in range(rounds):
        for label, call in calls.items():
            row["ms"].setdefault(label, []).append(cs.device_ms(call, 10)[0])
        host["remembered"].append(cs.host_ms(wrapper_sweep, 20))
        host["checked_every_call"].append(cs.host_ms(checked_sweep, 20))
    row["wrapper_host_ms"] = host
    row["wrapper_host_median_ms"] = {k: float(np.median(v))
                                     for k, v in host.items()}
    # the median: now and then a profiling window misses kernels and reads
    # short (below the bound, seen on the card)
    row["median_ms"] = {k: float(np.median(v)) for k, v in row["ms"].items()}
    row["pct_of_bound"] = {k: 100.0 * bound_ms / v
                           for k, v in row["median_ms"].items()}
    print(json.dumps(row), flush=True)
    del params, mu, nu, grads, start, plain
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="+",
                        help="label=path of a fused_adam.cu copy")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_adam_ab: needs an NVIDIA GPU")
    sources = {}
    for spec in args.sources:
        label, _, path = spec.rpartition("=")
        sources[label or os.path.basename(path)] = os.path.abspath(path)
    print(cs.card_line(), flush=True)
    built = build(sources)
    for label, (_, cfg, regs) in built.items():
        print(json.dumps({"source": label, "registers": regs, **cfg}),
              flush=True)
    bert = list(BERTClassifier(cs.NUM_CLASSES, device="cuda",
                               **cs.BERT_BASE).parameters())
    resnet50 = list(resnet(50, cs.IMG_CLASSES, cs.IMG_SHAPE).parameters())
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 40)
    run_mix(built, resnet50, torch.float32, gen, "resnet50", args.rounds)
    for pdtype in (torch.float32, torch.bfloat16):
        run_mix(built, bert, pdtype, gen, "bert_base", args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
