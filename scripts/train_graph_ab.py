#!/usr/bin/env python3
"""Eager against graphed training steps on one NVIDIA GPU, for every
model `chip_smoke.py` trains, in turns within one call.

A fit runs its steps as programs (`learn/trainer.py`): on a CUDA device
each is captured once as a CUDA graph and replayed; inside
`compile_cache.eager_programs()` the same programs run eagerly. Each
cell builds its model as `chip_smoke.py`'s phase does (random weights
from the seed, the phase's batch, precision, optimizer and data), warms
it with one graphed fit (the capture), then times fits of the same data
in the order eager, graph, graph, eager, `--rounds` times; a fit's step
ms is its host time over its steps, ending in a synchronize.

Cells: BERT-base classifier (seq 512, batch 32, bf16, dropout 0.1, fused
AdamW), NeuralCF (`bench_ncf.py`'s 2^22 samples, batch 8192, 64 steps a
run, lazy + fused), ResNet-50 (batch 256, bf16), the ImageNet model
(Inception-v1, uint8, batch 256), TextClassifier lstm and gru (batch
128, bf16) and lstm with Adagrad, AnomalyDetector (batch 1024),
WideAndDeep (batch 8192), BERTSQuAD (seq 384, batch 32) and BERTNER
(seq 128, batch 32).

    python3 scripts/train_graph_ab.py [--rounds 1] [--cells bert,ncf]

Prints the card's name and power limit, then one JSON line a cell (step
ms of every turn, the median of each mode, graphed over eager) and a
last line with all cells.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from analytics_zoo_tpu_torch import convert  # noqa: E402
from analytics_zoo_tpu_torch.compile_cache import eager_programs  # noqa: E402
from analytics_zoo_tpu_torch.learn.estimator import Estimator  # noqa: E402
from analytics_zoo_tpu_torch.models.anomalydetection import (  # noqa: E402
    AnomalyDetector, unroll)
from analytics_zoo_tpu_torch.models.bert import BERTNER  # noqa: E402
from analytics_zoo_tpu_torch.models.image import resnet  # noqa: E402
from analytics_zoo_tpu_torch.models.recommendation import \
    WideAndDeep  # noqa: E402
from analytics_zoo_tpu_torch.ops import objectives, optimizers  # noqa: E402


def _bert(rs, seed):
    cfg = cs.BERT_BASE
    state = convert.params_from_jax(
        cs.random_classifier_tree(cfg, cs.NUM_CLASSES, seed))
    hp = cs.ADAM_HP
    est = Estimator.from_keras(
        cs.new_model(state), optimizer=optimizers.fused_adam(
            learning_rate=hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
            weight_decay=hp["weight_decay"]),
        loss=objectives.get("sparse_categorical_crossentropy",
                            from_logits=True))
    data = cs.make_training_data(rs, cs.TRAIN_BATCH * cs.TRAIN_STEPS, cfg)
    return est, data, dict(epochs=1, batch_size=cs.TRAIN_BATCH,
                           mixed_precision=True, fused_optimizer=True), \
        cs.TRAIN_STEPS


def _ncf(rs, seed):
    ncf = cs.new_ncf()
    ncf.model.ensure_built(seed=seed)
    est = Estimator.from_keras(ncf.model, optimizer="adam",
                               loss="sparse_categorical_crossentropy")
    data = cs.ncf_data(rs, cs.NCF_SAMPLES, cs.NCF_CFG["user_count"],
                       cs.NCF_CFG["item_count"])
    return est, data, dict(epochs=1, batch_size=cs.NCF_BATCH,
                           steps_per_run=cs.NCF_SPR, lazy_embeddings=True,
                           fused_optimizer=True), cs.NCF_STEPS


def _resnet(rs, seed):
    model = resnet(50, cs.IMG_CLASSES, cs.IMG_SHAPE)
    model.ensure_built(seed=seed)
    n = cs.IMG_TRAIN_BATCH * cs.IMG_TRAIN_STEPS
    data = {"x": rs.random((n,) + cs.IMG_SHAPE, dtype=np.float32),
            "y": rs.integers(0, cs.IMG_CLASSES, n).astype(np.int32)}
    est = Estimator.from_keras(model, optimizer="adam", loss=cs.IMG_LOSS)
    return est, data, dict(epochs=1, batch_size=cs.IMG_TRAIN_BATCH,
                           mixed_precision=True, fused_optimizer=True), \
        cs.IMG_TRAIN_STEPS


def _imagenet(rs, seed):
    model = cs.imagenet_model()
    model.ensure_built(seed=seed)
    n = cs.INC_BATCH * cs.INC_TRAIN_STEPS
    data = {"x": cs.uint8_images(rs, n),
            "y": rs.integers(0, cs.IMG_CLASSES, n).astype(np.int32)}
    est = Estimator.from_keras(model, optimizer="adam", loss=cs.IMG_LOSS)
    return est, data, dict(epochs=1, batch_size=cs.INC_BATCH,
                           mixed_precision=True, fused_optimizer=True), \
        cs.INC_TRAIN_STEPS


def _text(encoder, optimizer):
    def make(rs, seed):
        clf = cs.text_model(encoder, cs.text_matrix(seed + 80))
        clf.model.ensure_built(seed=seed)
        n = cs.TXT_BATCH * cs.TXT_TRAIN_STEPS
        data = {"x": rs.integers(0, cs.TXT_WORDS + 1, (n, cs.TXT_SEQ)
                                 ).astype(np.int32),
                "y": rs.integers(0, cs.TXT_CLASSES, n).astype(np.int32)}
        est = Estimator.from_keras(clf.model, optimizer=optimizer,
                                   loss=cs.RNN_LOSS)
        kw = dict(epochs=1, batch_size=cs.TXT_BATCH, mixed_precision=True)
        if optimizer == "adam":
            kw["fused_optimizer"] = True
        return est, data, kw, cs.TXT_TRAIN_STEPS
    return make


def _anomaly(rs, seed):
    n = cs.AD_BATCH * cs.AD_TRAIN_STEPS
    series, _ = cs.anomaly_series(rs, n + cs.AD_SHAPE[0])
    x, y = unroll(series, cs.AD_SHAPE[0])
    model = AnomalyDetector(cs.AD_SHAPE).model
    model.ensure_built(seed=seed)
    est = Estimator.from_keras(model, optimizer="adam", loss="mse")
    return est, {"x": x, "y": y}, dict(epochs=1, batch_size=cs.AD_BATCH,
                                       fused_optimizer=True), \
        cs.AD_TRAIN_STEPS


def _wide_and_deep(rs, seed):
    model = WideAndDeep(**cs.WND_CFG).model
    model.ensure_built(seed=seed)
    x, y = cs.wide_and_deep_data(rs, cs.WND_SAMPLES)
    est = Estimator.from_keras(model, optimizer="adam", loss=cs.IMG_LOSS)
    return est, {"x": x, "y": y}, dict(epochs=1, batch_size=cs.WND_BATCH,
                                       fused_optimizer=True), \
        cs.WND_TRAIN_STEPS


def _squad(rs, seed):
    cfg = cs.BERT_BASE
    model = cs.squad_model(cs.bert_task_state(cfg, "qa", 2, seed), False)
    est = Estimator.from_keras(model, optimizer=cs.squad_optimizer(),
                               loss=cs.squad_loss())
    data = cs.squad_data(rs, cs.SQUAD_BATCH * cs.SQUAD_STEPS, cfg)
    return est, data, dict(epochs=1, batch_size=cs.SQUAD_BATCH,
                           mixed_precision=True, fused_optimizer=True), \
        cs.SQUAD_STEPS


def _ner(rs, seed):
    cfg = cs.BERT_BASE
    model = BERTNER(cs.NER_TAGS, use_flash=True, device="cuda", **cfg)
    model.load_state_dict(cs.bert_task_state(cfg, "ner", cs.NER_TAGS, seed))
    est = Estimator.from_keras(
        model, optimizer=optimizers.fused_adam(cs.NER_LR, eps=1e-6,
                                               weight_decay=0.01),
        loss=objectives.get("sparse_categorical_crossentropy",
                            from_logits=True))
    data = cs.ner_data(rs, cs.NER_BATCH * cs.NER_STEPS, cfg)
    return est, data, dict(epochs=1, batch_size=cs.NER_BATCH,
                           mixed_precision=True, fused_optimizer=True), \
        cs.NER_STEPS


CELLS = {"bert": _bert, "ncf": _ncf, "resnet50": _resnet,
         "imagenet_model": _imagenet, "lstm": _text("lstm", "adam"),
         "gru": _text("gru", "adam"), "lstm_adagrad": _text("lstm", "adagrad"),
         "anomaly": _anomaly, "wide_and_deep": _wide_and_deep,
         "squad": _squad, "ner": _ner}
TURNS = ("eager", "graph", "graph", "eager")


def timed_fit(est, data, fit_kw, steps: int, mode: str) -> float:
    """Step ms of one fit, run as `mode` says."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mode == "eager":
        with eager_programs():
            est.fit(data, **fit_kw)
    else:
        est.fit(data, **fit_kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def run_cell(name: str, rounds: int, seed: int) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.default_rng(seed + 400)
    est, data, fit_kw, steps = CELLS[name](rs, seed)
    t0 = time.perf_counter()
    est.fit(data, **fit_kw)                  # the eager run and the capture
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ms = {"eager": [], "graph": []}
    for _ in range(rounds):
        for mode in TURNS:
            ms[mode].append(timed_fit(est, data, fit_kw, steps, mode))
    med = {mode: float(np.median(v)) for mode, v in ms.items()}
    return {"cell": name, "steps": steps, "warm_fit_s": warm_s,
            "step_ms": ms, "median_ms": med,
            "graph_over_eager": med["graph"] / med["eager"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--cells", default=",".join(CELLS))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_graph_ab.py needs an NVIDIA GPU")
    card = cs.phase_device_and_build()
    out = []
    for name in args.cells.split(","):
        row = dict(run_cell(name, args.rounds, args.seed), card=card)
        print(json.dumps(row), flush=True)
        out.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"cells": out, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
