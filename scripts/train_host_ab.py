#!/usr/bin/env python3
"""Host-side A/B of the BERT fine-tuning step on one NVIDIA GPU: the
prefetch thread off and on, and two ways to put a block's parameters back
for remat's recompute, timed in turns, round after round.

The step is `chip_smoke.py`'s SQuAD phase (BERT-base, seq 384, batch 32,
bf16, dropout 0.1, the fused AdamW). Variants, each a fit of `--steps`
steps:

- `plain`: remat off, `fit(prefetch=False)` (the batch uploaded in the
  step loop);
- `prefetch`: remat off, the default prefetch thread;
- `remat`: `BERT(remat=True)` as the port runs it (the block's
  `_parameters` entries swapped in by `keras.transformer._run_block`);
- `remat_fcall`: the same recompute through `torch.func.functional_call`.

Every round runs each variant once, in the order given, so the host's
drift within the call shows as a spread across rounds, not as a gap
between variants. Each variant's losses must equal `plain`'s (remat and
the prefetch thread compute the same step).

    python3 scripts/train_host_ab.py --rounds 5

Prints the card's name and power limit, then one JSON line: each
variant's step ms per round and their median.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from analytics_zoo_tpu_torch.keras import transformer  # noqa: E402
from analytics_zoo_tpu_torch.learn.estimator import Estimator  # noqa: E402


def run_block_fcall(self, blk, h, mask, training, seed):
    """`BERT._run_block` with `functional_call` doing the swap."""
    if not (self.remat and torch.is_grad_enabled()):
        return blk.call([h, mask], training=training, seed=seed)
    names, tensors = zip(*blk.named_parameters())

    def run(hh, mm, *params):
        return functional_call(blk, dict(zip(names, params)), ([hh, mm],),
                               {"training": training, "seed": seed})

    return checkpoint(run, h, mask, *tensors, use_reentrant=False,
                      preserve_rng_state=False)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("variants", nargs="*",
                        default=["plain", "prefetch", "remat",
                                 "remat_fcall"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_host_ab: needs an NVIDIA GPU")
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.BERT_BASE
    state = cs.bert_task_state(cfg, "qa", 2, args.seed)
    rs = np.random.default_rng(args.seed + 120)
    data = cs.squad_data(rs, cs.SQUAD_BATCH * args.steps, cfg)
    ours = transformer.BERT._run_block
    ests = {}
    for name in args.variants:
        model = cs.squad_model(state, name.startswith("remat"))
        ests[name] = Estimator.from_keras(model,
                                          optimizer=cs.squad_optimizer(),
                                          loss=cs.squad_loss())
    fit_kw = dict(epochs=1, batch_size=cs.SQUAD_BATCH, mixed_precision=True,
                  fused_optimizer=True)
    times = {name: [] for name in args.variants}
    losses = {name: [] for name in args.variants}
    for r in range(args.rounds + 1):          # round 0 warms each variant
        for name in args.variants:
            transformer.BERT._run_block = run_block_fcall \
                if name == "remat_fcall" else ours
            try:
                t0 = time.perf_counter()
                hist = ests[name].fit(data, prefetch=name != "plain",
                                      **fit_kw)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            finally:
                transformer.BERT._run_block = ours
            losses[name].append(hist["loss"])
            if r:
                times[name].append(dt / args.steps * 1e3)
    same = all(losses[n] == losses[args.variants[0]] for n in args.variants)
    print(json.dumps({
        "step_ms": times,
        "median_step_ms": {n: float(np.median(t)) for n, t in times.items()},
        "losses_equal": same, "rounds": args.rounds, "steps": args.steps,
        "card": cs.card_line()}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
