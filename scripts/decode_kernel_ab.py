#!/usr/bin/env python3
"""Decode-attention sources A/B on one NVIDIA GPU: copies of
`analytics_zoo_tpu_torch/csrc/decode_attention.cu` (older commits, or
variants) on the same inputs, timed in turns, round after round.

Cases: the decode-kernel phase's shapes of `chip_smoke.py` (32 slots, 12
heads, head dim 64, a 1024-position pool, blocks of 16, lengths uniform
in [1, bucket], kv buckets 128, 1024 and 512, f32 and bf16, drawn from the
seed as that phase draws them). Times are device ms by CUDA-graph replay
over pool sets holding more than twice the L2 (`chip_smoke.graph_ms`,
`cycling`). Every round times each source once, in the order given, so a
drift of the card shows as a spread across rounds rather than as a gap
between sources.

Each source's C signature is read from its own text: arguments are passed
by name, so a source with or without the split plan's `n_split` argument
runs alike. A source that takes `n_split` runs at the plan of the
repository's wrapper (`_split_plan`), or at each count of `--splits`.

    mkdir -p _archive_check/old
    git show <commit>:analytics_zoo_tpu_torch/csrc/decode_attention.cu \\
        > _archive_check/old/decode_attention.cu
    git show <commit>:analytics_zoo_tpu_torch/csrc/common.cuh \\
        > _archive_check/old/common.cuh
    python3 scripts/decode_kernel_ab.py \\
        old=_archive_check/old/decode_attention.cu \\
        new=analytics_zoo_tpu_torch/csrc/decode_attention.cu --rounds 3

Prints the card's name and power limit, then each source's ptxas report,
then one JSON line per case: for each source (and split count) its
[contiguous ms, paged ms] per round, their means, the bound, and the max
abs error against the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from analytics_zoo_tpu_torch.kernels import _build  # noqa: E402
from analytics_zoo_tpu_torch.kernels import \
    decode_attention as da  # noqa: E402

ENTRIES = ("azt_decode_attention", "azt_paged_decode_attention")
C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float}


def signature(text: str, entry: str):
    """[(argument name, ctypes type)] of `entry`'s definition in a C
    source's text."""
    m = re.search(rf"\bint\s+{entry}\s*\(([^)]*)\)", text)
    if m is None:
        raise SystemExit(f"decode_kernel_ab: no {entry} in the source")
    args = []
    for part in m.group(1).split(","):
        words = part.replace("*", " * ").split()
        name = words[-1]
        kind = "void*" if "*" in words else words[-2]
        args.append((name, C_TYPES[kind]))
    return args


def build(sources: dict) -> dict:
    """{label: (library, {entry: argument names}, ptxas report)}, one nvcc
    a source, all started together."""
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {label: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
         str(out_dir / f"{label}.so"), src], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for label, src in sources.items()}
    libs = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{label}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{label}.so"))
        with open(sources[label]) as f:
            text = f.read()
        names = {}
        for entry in ENTRIES:
            sig = signature(text, entry)
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = [t for _, t in sig], ctypes.c_int
            names[entry] = [n for n, _ in sig]
        libs[label] = (lib, names, cs.ptxas_parse(log))
    return libs


def caller(built, paged: bool, n_split: int, kv: int):
    """A call of one kernel on one pool set, returning its output."""
    lib, names, _ = built
    entry = ENTRIES[paged]
    fn = getattr(lib, entry)

    def call(q, k, v, n, kp, vp, t):
        S, H, D = q.shape
        out = torch.empty_like(q)
        kk, vv = (kp, vp) if paged else (k, v)
        values = {"q": q.data_ptr(), "k": kk.data_ptr(), "v": vv.data_ptr(),
                  "tables": t.data_ptr(), "lengths": n.data_ptr(),
                  "out": out.data_ptr(), "S": S, "H": H, "L": k.shape[2],
                  "block_len": kp.shape[2], "D": D,
                  "table_stride": t.shape[1], "kv_bucket": kv,
                  "n_split": n_split, "scale": 1.0 / math.sqrt(D),
                  "dtype": 0 if q.dtype == torch.float32 else 1, "vec": 1,
                  "stream": torch.cuda.current_stream().cuda_stream}
        rc = fn(*(values[name] for name in names[entry]))
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")
        return out
    return call


def run_case(libs, sets, kv: int, dtype, rounds: int, splits):
    q, k, v, n = sets[0][:4]
    S, H, D = q.shape
    ref = da._reference_decode_attention(q, k, v, n, kv)
    turns = []
    for label, built in libs.items():
        if "n_split" in built[1][ENTRIES[0]]:
            for s in splits or [da._split_plan(kv)]:
                turns.append((f"{label} n_split={s}", built, s))
        else:
            turns.append((label, built, 1))
    reps = max(12, len(sets))
    row = {"case": "32 slots", "kv_bucket": kv, "dtype": str(dtype)[6:],
           "S": S, "H": H, "D": D, "pool_sets": len(sets),
           "live_positions": int(n.clamp(max=kv).sum()),
           "bound_ms": cs.decode_bound(n, kv, H, D, dtype)[0],
           "plan_n_split": da._split_plan(kv), "times": {},
           "max_abs_err": {}}
    for _ in range(rounds):
        for key, built, s in turns:
            fns = [caller(built, paged, s, kv) for paged in (False, True)]
            out, out_p = fns[0](*sets[0]), fns[1](*sets[0])
            torch.cuda.synchronize()
            row["max_abs_err"][key] = max(
                (o.float() - ref.float()).abs().max().item()
                for o in (out, out_p))
            row["times"].setdefault(key, []).append(
                [cs.graph_ms(cs.cycling(fn, sets), reps) for fn in fns])
    row["mean"] = {key: [sum(t[i] for t in ts) / len(ts) for i in (0, 1)]
                   for key, ts in row["times"].items()}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="+",
                        help="label=path of a decode_attention.cu copy")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--splits", default="",
                        help="comma-separated n_split counts to time "
                             "(default: the wrapper's plan)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_kernel_ab: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {}
    for spec in args.sources:
        label, _, path = spec.rpartition("=")
        sources[label or os.path.basename(path)] = os.path.abspath(path)
    splits = [int(s) for s in args.splits.split(",") if s]
    print(cs.card_line(), flush=True)
    libs = build(sources)
    for label, (_, _, ptxas) in libs.items():
        print(json.dumps({"source": label, "ptxas": ptxas}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 80)
    for kv in cs.DEC_BUCKETS:
        for dtype in (torch.float32, torch.bfloat16):
            lengths = cs.decode_lengths(gen, kv)
            sets = [cs.decode_case_inputs(gen, lengths, dtype) for _ in range(
                cs.decode_pool_sets(lengths, kv, dtype))]
            run_case(libs, sets, kv, dtype, args.rounds, splits)
            del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
