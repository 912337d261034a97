#!/usr/bin/env python3
"""Each hand kernel of a training step timed in two source trees on one
NVIDIA GPU, in turns: the dropout, flash-attention (forward and the dK/dV
and dQ pair), fused-Adam and segment-Adam kernels, as `chip_smoke.py`'s
kernel phases time them at the main path's shapes.

Each turn is a process of its own in the given tree: it builds that
tree's kernels and runs `chip_smoke.py`'s `phase_kernels`,
`phase_backward`, `phase_dropout`, `phase_fused_adam` and
`phase_segment_adam` there, and the rows each prints are kept. Turns run
A, B, B, A. Use it to show that a change to the kernels' arguments (a
per-step value read through a device pointer) costs nothing:

    git archive HEAD | tar -x -C /tmp/parent
    python3 scripts/kernel_ab.py --a /tmp/parent --b .

Prints the card's name and power limit, then one JSON line a turn and a
last line with each row's times in every turn.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = ("phase_kernels", "phase_backward", "phase_dropout",
          "phase_fused_adam", "phase_segment_adam")
TURN = ("import sys, chip_smoke as c; card = c.phase_device_and_build(); "
        + "; ".join(f"c.{p}(card, 0)" for p in PHASES))
# (phase, the fields that name a row, the time fields kept)
ROWS = {
    "kernel": (("shape", "dtype", "masked"),
               ("kernel_ms", "kernel_ms_dropout", "kernel_graph_ms",
                "kernel_graph_ms_dropout")),
    "backward": (("shape", "dtype", "masked"),
                 ("kernel_ms", "dkv_ms", "dq_ms", "kernel_ms_dropout",
                  "dkv_ms_dropout", "dq_ms_dropout")),
    "dropout": (("shape", "dtype"), ("kernel_ms", "wall_ms")),
    "fused_adam": (("leaf_mix", "param_dtype"),
                   ("kernel_ms_per_sweep", "host_ms", "wall_ms")),
    "segment_adam": (("case", "dtype"), ("kernel_ms", "wall_ms",
                                         "sum_kernel_ms")),
}


def turn(root: str, timeout: float) -> dict:
    """One process in `root`: its rows' times, keyed by phase and row."""
    proc = subprocess.run([sys.executable, "-c", TURN],
                          cwd=os.path.abspath(root), capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise SystemExit(f"kernel_ab: the turn in {root} failed:\n"
                         f"{proc.stderr[-4000:]}")
    rows = {}
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        spec = ROWS.get(d.get("phase"))
        if spec is None:
            continue
        key = d["phase"] + ":" + "/".join(str(d.get(k)) for k in spec[0])
        rows[key] = {k: d[k] for k in spec[1] if k in d}
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--a", required=True, help="the first tree")
    parser.add_argument("--b", default=".", help="the second tree")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    turns = []
    for name, root in (("a", args.a), ("b", args.b), ("b", args.b),
                       ("a", args.a)):
        rows = turn(root, args.timeout)
        turns.append({"tree": name, "root": root, "rows": rows})
        print(json.dumps(turns[-1]), flush=True)
    table = {}
    for t in turns:
        for key, times in t["rows"].items():
            for field, ms in times.items():
                table.setdefault(key, {}).setdefault(field, {}).setdefault(
                    t["tree"], []).append(ms)
    print(json.dumps({"card": card, "rows": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
