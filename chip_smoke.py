#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (`analytics_zoo_tpu_torch`) on one NVIDIA
GPU: build its kernels, hold each against its plain PyTorch version, serve
a full-width BERT-base classifier through the port's `InferenceModel`,
train it through `Estimator.fit`, train, evaluate and rank with NeuralCF at
MovieLens-20M scale, serve generative decoding at GPT-2 small's widths
through `DecodeServing`, serve and train ResNet-50 at ImageNet's widths,
serve and train the recurrent models (TextClassifier at news20's widths,
AnomalyDetector, SessionRecommender), serve and train the ImageNet model
of `examples/inception_imagenet.py` (uint8 input, a `Lambda`
normalisation, Inception-v1 nested as a layer) and WideAndDeep at
MovieLens-1M widths (saved and reloaded), train with checkpoints and
resume, fine-tune BERT-base for SQuAD and NER (with and without remat,
watched by the trainer's own MFU and roofline gauges and its profiler
window), time the prefetch thread on ResNet-50, serve a fleet of BERT-base
engines started by the serving CLI behind its HTTP gateway (heartbeats,
fleet metrics, merged traces, a live rollout, a killed engine) and a
generative engine streaming by SSE, train the ImageNet model from TFRecord
shards streamed through the data layer, train BERT-base sharded over two
ranks (with ring attention and a pipeline over the same ranks, and the
graphed step over NCCL at one rank), train and serve the text zoo (NER
with its CRF head, KNRM, TransformerLayer, Seq2seq), and print what it
measured.

    python3 chip_smoke.py [--seed N]

Run it from the repository root on a host with an H100 (sm_90a) and the
CUDA toolkit. Phases, in order; any failure exits non-zero:

1. device and build: the card's name and power limit (nvidia-smi), the
   build of every kernel from `analytics_zoo_tpu_torch/csrc/`, all sources
   at once, with each build's seconds, then each flash kernel's registers
   and spills (ptxas) and its count of tensor-core (HMMA) instructions
   (`cuobjdump -sass`): the bf16 kernels run on the tensor cores, the f32
   ones on the CUDA cores;
2. the flash-attention forward against its plain version on the card, one
   JSON line per case, with the error, its tolerance and the times of the
   kernel (also with attention dropout 0.1, and by CUDA graph at seq
   512), the plain version and the PyTorch library call of the same
   function;
3. the flash-attention backward kernels (dK/dV and dQ) against autograd of
   the plain version, f32 and bf16, with and without a padding mask, at the
   training shape, the seq-2048 shape and odd shapes; times (also with
   attention dropout 0.1, and the pair by CUDA graph) and bounds; SDPA's
   backward by CUDA graph;
4. attention dropout at rate 0.1: the kernels' exported keep-scale matrix
   injected into the plain version, forward and gradients compared, keep
   fraction, seeds;
5. the dropout kernel on `[32,512,768]`: exact against its own mask, keep
   fraction, backward mask, rates 0 and 1; times;
6. the fused-Adam kernel (one launch a sweep of up to 704 leaves): edge
   leaves (the four (p, g) dtype pairs, ragged counts, 0-d and empty
   leaves, views off 16-byte alignment) and more leaves than a launch
   takes; then tensors shaped like BERT-base's leaves (f32 and bf16) and
   like ResNet-50's (f32; conv kernels channels_last): 3 steps against the
   plain version, in place, a step at one leaf a launch bit-equal to one
   launch a sweep; device and host times of both launch patterns;
7. serving: BERT-base (vocab 30522, hidden 768, 12 blocks, 12 heads,
   intermediate 3072, seq 512, 2 classes, `use_flash=True`) with random
   weights from the seed, warmed over buckets 1-32, answering requests of
   batch 1, 3, 8 and 32 in f32 and bf16; launches counted; a profiled
   window of batch-32 predicts (device time by kernel, idle share); logits
   checked against the same weights served by the port on the CPU; then
   the same BERT-base served int8 (`phase_int8_serving_lifecycle`): the
   int8 GEMM (`torch._int_mm` through `quantization.int8_mm`) exact at
   BERT's four GEMM shapes at batch 8, against the CPU's product; the int8
   model warmed over buckets 1-32, p50 / p99 at batches 1, 8 and 32, 12
   flash launches a forward, the serving roofline gauges in (0, 1]; its
   forward against the port's int8 path on the CPU at every int8 GEMM,
   teacher-forced (each product bitwise, each f32 stretch between GEMMs
   within 1e-4 on the card's inputs), end to end beside the CPU path's
   one-ulp spread, the same top-1; against f32 on the card (drift, top-1
   agreement);
   the int8 artifact's bytes against f32 and its save / load seconds;
   `load_checkpoint(quantize="int8")` from a checkpoint's sidecar; a
   same-structure `swap_params` (no kernel built, bitwise a fresh load);
   two replicas on the card's streams (bitwise one replica; p50 and
   pipelined ms at batch 8, in turns, and a profiled pipelined window)
   and a fault on replica 1 that quarantines it, probes and revival;
   then the same f32 BERT-base behind a queue (`phase_cluster_serving`):
   the port's `ClusterServing` (pipelined, batch 32) over a `MemoryBroker`,
   the port's TCP broker server and its RESP2 `MiniRedisServer` on
   127.0.0.1:0, records of 512 int64 ids in the b64 codec; 25 requests
   with one in flight over the memory and TCP brokers and 50 over RESP2
   (p50 / p99), a malformed record
   among good ones in one burst ("NaN", its batch-mates answered), 8
   closed-loop client threads on their own RESP2 connections, 400
   requests (records/s, p50 / p99, the dispatched batch sizes, the card's
   busy share in a profiled window); every answer against the direct
   forward of its row (5e-4, same argmax), 12 flash launches a dispatched
   forward, no kernel built after warmup, each `stop()` under 10 s, every
   record answered once and the thread count back where it began, every
   dispatch a replay of the bucket's CUDA graph; then the compile cache
   for serving (`phase_graphs`): the same BERT-base in f32, bf16 and int8
   warmed over buckets 1, 8 and 32 (one CUDA graph a bucket, captured at
   warmup) against the eager forward on the same module (bitwise), 12
   flash launches and one replay a forward (a replay adds the kernel
   nodes its graph holds, read from the captured graph through
   libcuda, and the profiler counts the flash kernels replays run), p50 /
   p99 eager and graphed in turns, the
   graph pool's bytes (and with every bucket up to 512), a "same" swap
   (a batch dispatched before it answers with the old weights, the next
   as an eager forward with the new, no capture, no build) and a
   "restructured" one to int8, two graphed replicas on one card against
   one, eager and graphed, pipelined at 8, and `cli start` of the fleet's
   model (`FLEET_BERT`: BERT-base's widths at 4 of its 12 blocks) with
   an empty `--compile-cache-dir` and build directory (nvcc
   builds, every bucket "compiled", seconds to the first answer); then
   the fleet (`phase_fleet_serving`), as a user starts it, its engines
   restarting warm from that cache (nvcc 0 times, every bucket "cached")
   and its generative engine rebuilding the one entry whose byte was
   flipped: a `cli
   gateway` and two `cli start` engines of that model in
   processes of their own over the port's `MiniRedisServer`, heartbeats
   every 0.5 s, fleet metrics, every request traced, rollout from a
   `CheckpointManager` run dir: 50 `POST /predict` with one in flight
   through the gateway (p50 / p99, each answer against the direct
   forward), `/healthz` with two engines alive, the fleet `/metrics`
   summing `serving_records_total` to the requests sent, a merged
   `/trace/<request_id>` with the gateway's and an engine's spans; a
   second version published while a client keeps sending, converged one
   engine at a time (every answer v1's or v2's, v2's after convergence,
   both heartbeats on v2; seconds to converge); one engine SIGKILLed
   holding records (the other frozen while the burst lands), every
   request answered by the survivor's claim sweep, `/healthz` down to
   one engine after the TTL; the survivor's flash launches 12 a forward
   (its dispatches and two a swap); the engine built in this process as
   `cmd_start` builds it under `leak_check` (12 flash launches a
   dispatched forward, no build, `device_memory_snapshot` against the
   allocator); a generative `cli start` (TinyDecoder at GPT-2 small's
   widths) streaming 8 requests by SSE, its tokens equal to an
   in-process `DecodeServing`'s, 12 decode launches a step in both, its
   heartbeat row; every child out with code 0 on SIGTERM;
8. training: the same BERT-base (dropout 0.1 everywhere) through
   `Estimator.from_keras(..., optimizer=fused_adam(...)).fit(...,
   mixed_precision=True, fused_optimizer=True)` at seq 512, batch 32,
   every training step replayed from a CUDA graph captured after the
   program's first, eager run (the default on the card):
   fits eager (`eager_programs()`), graphed, eager, graphed from the same
   weights under deterministic algorithms, the two eager fits bitwise
   equal and the graphed ones bitwise the eager (losses, parameters);
   step time of each leg, tokens/s, MFU, peak memory, launches per step
   of every kernel in both legs (a replay adds the kernel nodes read from
   its graph), a profiled fit of each leg (idle share); one graph of a
   dropout pass and a dropout attention forward replayed under two step
   seeds in device memory (different masks, each the plain version's);
   the kernel path against the plain path (dropout 0, 3 steps) in f32 and
   in bf16; the bf16 loss falling over 20 steps on one batch;
9. the segment-Adam kernels (row-sparse Adam and its segment sum) on
   tables shaped like NeuralCF's at MovieLens-20M scale ([138001, 64] and
   [27001, 64], f32 and one bf16 case), 3 steps of 8192 ids under three id
   mixes: bit-exact against the plain version, untouched rows unchanged,
   the segment sum the same on two calls and close to the CPU's; times
   beside the bound and `torch.optim.SparseAdam`;
10. NeuralCF (138k users, 27k items, embeddings 64, MLP 128/64/32, 2
   classes) through `Estimator.from_keras(..., optimizer="adam").fit(...,
   batch_size=8192, steps_per_run=64, lazy_embeddings=True,
   fused_optimizer=True)` over `bench_ncf.py`'s 2^22 samples, kept on the
   card by the auto device cache, 64 steps a replay: step time,
   samples/s, the resident bytes, peak memory, launches per step (4
   segment_adam, 4 segment_sum, 1 fused_adam over the 8 dense leaves), a
   profiled fit (idle share); the device-cached graph against the
   host-batched eager fit (`device_cache=False`), bitwise; the dense leg
   (`lazy_embeddings=False`, 1 fused_adam a step over 12 leaves); the
   kernel path against the plain path (3 steps); the loss falling on a
   learnable rule; `evaluate(metrics=["accuracy"])` on held-out pairs and
   `recommend_for_user` against a top-k of `predict`; a warm restart: a
   fit in this process writes an empty `compile_cache_dir`, then a child
   process with an empty kernel build directory fits against it, running
   nvcc 0 times and reporting its program "cached";
11. the decode-attention kernels, contiguous and paged, at 32 slots, 12
   heads, head dim 64, a 1024-position pool and blocks of 16, kv buckets
   128, 1024 and 512 (and 192, checks only), ragged lengths, f32 and bf16:
   each against its plain version, the paged kernel on shuffled blocks
   bitwise equal to the contiguous one, one launch each, a second launch
   and a CUDA graph's replay bitwise equal to the first; the split plan,
   ptxas's registers and spills, device times beside the bound (and its
   share), the plain versions and SDPA with a length mask;
12. generative serving: `TinyDecoder` at GPT-2 small's widths (vocab
   50257, 12 layers, 12 heads, head dim 64, 1024 positions, MLP x4) with
   random weights from the seed, through `load_generative`, both warmups
   and `DecodeServing` over a `MemoryBroker` (32 slots, kv buckets
   128-1024, prompt buckets 64-512), contiguous, then paged (blocks of 16,
   prefill chunks of 256, prefix cache): 64 requests, half of them
   sharing a 256-token prefix, Poisson arrivals 2 ms apart, every stream
   read back; tokens/s, TTFT and ITL p50/p99, slot utilization, peak
   memory; exactly 12 decode-attention launches a decode step and no
   kernel built after warmup, every prefill, chunk and step a replay of
   its CUDA graph; the paged streams against the contiguous ones; a paged
   run with neither chunking nor the prefix cache, bitwise the contiguous
   streams; an eager engine's streams against the graphed ones; a
   crash-resumed stream bitwise the uninterrupted one, every call of the
   engine that resumes it a replay; profiled decode steps and prefills,
   graphed and eager (device time by kernel, idle share, 12 decode
   kernels of the step's mode by the profiler's count) and a summary of tokens/s, TTFT and ITL beside
   `decode_attention`'s device ms in the profiled step; teacher-forced
   logits against the port's CPU run and against the plain path;
13. image serving: ResNet-50 v1.5 (224×224×3, 1000 classes) through
   `ImageClassifier` with random weights from the seed (BatchNorm
   statistics calibrated on one random batch), warmed over buckets 1-128,
   answering batches of 1, 8, 32 and 128 in f32 and bf16; no kernel built
   on the request path; a profiled window at batch 32 (device time by op
   class, idle share); probabilities against the port's CPU run;
14. image training: the same architecture through
   `Estimator.from_keras(..., optimizer="adam").fit(..., batch_size=256,
   mixed_precision=True, fused_optimizer=True)`: step time, images/s, MFU
   from the convolution and dense shapes, peak memory, one fused-Adam
   launch a step (161 leaves) and no gradient copied into its leaf's
   layout, no build after warmup, moving statistics float32, a
   profiled fit (device time by op class); the kernel path against the
   plain path (3 steps, f32 and bf16) beside the rounding floor;
15. one Inception-v1 training step (batch 32): its `Dropout` layer launches
   the dropout kernel forward and backward, checked at that shape;
16. TextClassifier at the news20 example's widths (5,001 x 200 frozen
   `WordEmbedding` of a random matrix, seq 500, hidden 256, 20 classes),
   lstm and gru, through `Estimator.from_keras(..., optimizer="adam")
   .fit(..., batch_size=128, mixed_precision=True, fused_optimizer=True)`:
   step ms, samples/s, tokens/s, MFU from the GEMM shapes, peak memory,
   two dropout and one fused-Adam launch a step, no build after warmup,
   the frozen table unchanged; a profiled fit (device ms and ops a step by
   op class, idle share); the kernel path against the plain path (the
   dropout layer on its plain version with the same keep masks, plain
   Adam; 3 steps, f32 and bf16);
17. TextClassifier (lstm, gru, cnn) through `InferenceModel`, f32 and bf16,
   answering batches of 1, 8, 32 and 128; probabilities against the port's
   CPU run;
18. the recurrence's yardstick: the port's LSTM and GRU layers beside
   `torch.nn.LSTM` / `torch.nn.GRU` (cuDNN: sigmoid gates, reset-after, a
   different function the port never calls) at B 128, T 500, E 200, H
   256, forward and forward + backward, with the FLOP bound (the port's
   device time over one profiled call each, cut from two for time);
19. AnomalyDetector at the JAX defaults on (50, 3) windows, batch 1024,
   "adam", "mse", f32: `unroll` of a seeded series with injected spikes,
   `fit` (six dropout and one fused-Adam launch a step), `InferenceModel`
   predict p50 at batch 1024, `detect_anomalies` finding the spikes, the
   card against the CPU, kernel path against plain path;
20. SessionRecommender (GRU (40, 20), 5,000 items, sessions of 10): the
   card's softmax against the CPU's;
21. the ImageNet model of `examples/inception_imagenet.py:160-167`: uint8
   224×224×3 input, the normalisation `Lambda` (mean 123/117/104, std
   58.4/57.1/57.4, f32 inside), `inception_v1(1000)` nested as a layer,
   through `Estimator.fit(..., batch_size=256, mixed_precision=True,
   fused_optimizer=True)`: step ms, images/s, MFU, the bytes a step
   uploads, peak memory, 2 dropout and one fused-Adam launch a step, a
   profiled fit (device ms by op class, idle share); the kernel path
   against the plain path (3 steps, bf16, cuDNN deterministic); the
   dropout kernel at `[256, 1024]`; served in f32 and bf16 at batches 1,
   8, 32 and 128; the nested model against the flat `inception_v1` fed the
   normalised batch;
22. WideAndDeep at MovieLens-1M widths (the wide-n-deep app's columns:
   users 6,040 and movies 3,952 embedded at 64, MLP 40-20-10, 5 classes)
   through `Estimator.fit(..., batch_size=8192, fused_optimizer=True)` over
   65,536 seeded rows: step ms, samples/s, device ops a step, idle share;
   `InferenceModel` p50 / p99 at batches 1, 32, 1024 and 8192; `save_model`
   → `ZooModel.load_model` → `InferenceModel.load_zoo_model`, predictions
   bitwise equal, save and load seconds; `summary()`'s total;
23. checks without timing: `SessionRecommender(include_history=True)`
   served and fitted one step against the CPU, and the `CustomLoss` of
   `examples/autograd_custom_loss.py` fitted 3 steps against the CPU;
24. TextClassifier-lstm at news20's widths compiled with the JAX
   registry's `"adagrad"`, trained 2 epochs of 8 steps through a
   checkpointed `Estimator` (`model_dir`, the default `EveryEpoch`
   trigger) with a validation split of 256 rows, bf16: step ms,
   samples/s, validation per epoch, checkpoint save seconds and bytes,
   the run directory (`find_resume_checkpoint` must accept it), 2 dropout
   launches a step; then the kernel path against the plain path, f32;
25. WideAndDeep (phase 22's widths, fused Adam) killed by a fault at
   `trainer.step` in epoch 3 and resumed by a fresh instance with
   `auto_resume=True`: the state restored from disk bitwise the saved
   state, the resumed epoch-3 loss, parameters and moments against an
   uninterrupted fit (bitwise or not, and the largest relative
   difference, at most 1e-6), the resume seconds, one fused-Adam launch a
   step;
26. BERTSQuAD at BERT-base widths fine-tuned at seq 384, batch 32, bf16
   (Google BERT's SQuAD 1.1 recipe: lr 3e-5 with 10% warmup and linear
   decay, eps 1e-6, weight decay 0.01, as `fused_adam`; a list of two
   losses), dropout 0.1: 3 steps with `remat=True` against `remat=False`
   from the same weights (bitwise or not); then 8 steps each, remat off
   and on in turns (ABAB): step ms, tokens/s, peak memory, launches a
   step (flash forward 12 / 24), the trainer's `training_mfu` (with
   `flops_per_step` from `bench.py:101-111` at seq 384) beside the
   formula's, `roofline_mfu` and `roofline_hbm_utilization`, the counted
   FLOPs a step against the formula (within 10%) and remat's recompute;
   a profiled fit (idle share); the fit's `profile_steps=(2, 4)` artifact
   read back with `load_trace_events`, holding the events of the flash,
   dropout and fused-Adam kernels; the fused AdamW against the plain
   `adam_weight_decay` over 3 steps;
27. BERTNER at BERT-base widths (seq 128, CoNLL-2003's 9 tags, batch 32,
   bf16) fine-tuned 8 steps, then served through `InferenceModel` at
   batches 1, 8 and 32 (p50 / p99, 12 flash launches a forward); card
   f32 logits against the CPU;
28. ResNet-50 at batch 256, bf16, deterministic cuDNN, trained without
   and with the prefetch thread in turns (three of each, medians): step
   ms, the host-to-device
   copy's device ms a step, its streams and the share of it under
   compute kernels (the fit's own profiler window), bytes a step;
   losses and parameters bitwise equal;
29. the ImageNet model of phase 21 trained at batch 256 from TFRecord
   shards (8 of 160 records, raw 240×240×3 pixels in the ImageNet layout,
   written from the seed) streamed through `TPUDataset.from_tfrecord`
   with 8 decode workers and the native scanner, a random 224 crop and
   mirror per record: the first two batches at 1 and 8 workers bitwise
   equal to each other and to a serial read of the same records; a warm
   streamed epoch, then the timed one (step ms, images/s, the producer's
   ms a batch and the input-pipeline share, `training_input_bound`, 2
   dropout + 1 fused-Adam launches a step, no build, no new capture, no
   pipeline or prefetch thread left); the idle share over a streamed
   2-step window; the streamed fit's per-step losses against an in-memory
   fit of the same batches (1e-5 relative); where cv2 imports, a JPEG
   corpus through the example's parse chain (2 steps of batch 64) and 8
   `image=` JPEG requests through `ClusterServing` against the direct
   forward (5e-4, same argmax);
30. the distributed slice (`phase_distributed`): the collective routes;
   a one-process BERT-base fit (seq 512, global batch 32, bf16, fused
   AdamW, dropout 0, 4 steps) here, then one
   `launch_local_cluster(platform="cuda")` of 2 ranks on the one card over
   gloo (NCCL refuses two ranks on one device) whose workers run
   `init_orca_context(data=1, fsdp=2)` and the same fit with
   `sharding_rules=True`, each rank fed its half of every global batch:
   losses against the one-process fit (`DIST_LOSS_TOL`), each rank's
   parameter and optimizer-state bytes against the replicated fit's
   (about half), launches a step per rank (12 flash forward, 12 dK/dV, 12
   dQ, 1 fused Adam) and one step with dropout 0.1 (the dropout kernel),
   the collectives' calls, host seconds and host-staged copies; ring
   attention at seq 2048 split over the 2 ranks (BERT-base heads, a
   padding mask, f32 and bf16) against the one-process flash kernels at
   full length, forward and gradients, and against the ring's plain path,
   with each rank's flash launches; 12 BERT-base blocks as 2 pipeline
   stages over 4 microbatches against the sequential stack, forward and
   gradients; then `zoo-launch --nproc 1` of this script
   (`--nccl-leg`): `init_orca_context(cluster_mode="multi-host")` over
   NCCL, the graphed BERT-base fit with its gradient all-reduce, bitwise
   the non-distributed graphed fit under deterministic algorithms;
31. the text zoo (`phase_text_zoo`): NER at the JAX defaults (9 tags,
   vocabularies of 20,000 words and 100 chars, 40-word sentences, batch
   128) trained through `Estimator.fit` with fused AdamW (2 dropout and
   1 fused-Adam launches a step) against the CPU's fit, served at batches
   1 and 128, its CRF log-likelihood, loss and Viterbi paths on the card's
   emissions against the CPU's; KNRM at WikiQA's ranker widths fitted with
   `rank_hinge`, its NDCG@3/5 and MAP over 32 queries of 8 candidates
   against the CPU's; TransformerLayer at GPT-1's widths (12 blocks,
   hidden 768, seq 512, batch 8), flash against plain in f32 and bf16, 12
   flash launches a forward; Seq2seq (LSTM, dense bridge, generator)
   forward, fit and `infer` against the CPU; a fitted model deleted with
   the collector off gives its card memory back;
32. the seconds of every phase, and the run's;
33. a `kernels` line listing every kernel of the port;
34. the last line, `{"ok": true, "device": {...}}`.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import gc
import hashlib
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from analytics_zoo_tpu_torch import convert  # noqa: E402
from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build  # noqa: E402
from analytics_zoo_tpu_torch.kernels import dropout as dr  # noqa: E402
from analytics_zoo_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from analytics_zoo_tpu_torch.kernels import fused_adam as fad  # noqa: E402
from analytics_zoo_tpu_torch.kernels import \
    decode_attention as da  # noqa: E402
from analytics_zoo_tpu_torch.kernels import \
    segment_update as seg  # noqa: E402
from analytics_zoo_tpu_torch.kernels.philox import (  # noqa: E402
    DeviceSeed, as_device_seed, attention_keep_scale, site_seed)
from analytics_zoo_tpu_torch.compile_cache import \
    graphs as cgraphs  # noqa: E402
from analytics_zoo_tpu_torch.common.device import \
    resolve_device  # noqa: E402
from analytics_zoo_tpu_torch.common.tree import tree_leaves  # noqa: E402
from analytics_zoo_tpu_torch.data import image as zimage  # noqa: E402
from analytics_zoo_tpu_torch.data import tfrecord as tfr  # noqa: E402
from analytics_zoo_tpu_torch.data.dataset import TPUDataset  # noqa: E402
from analytics_zoo_tpu_torch.data.pipeline import \
    parallel_read  # noqa: E402
from analytics_zoo_tpu_torch.keras import layers as KL  # noqa: E402
from analytics_zoo_tpu_torch.keras import engine as kengine  # noqa: E402
from analytics_zoo_tpu_torch.keras.engine import (  # noqa: E402
    Input, Model, Sequential)
from analytics_zoo_tpu_torch.keras.transformer import \
    TransformerLayer  # noqa: E402
from analytics_zoo_tpu_torch.learn.estimator import Estimator  # noqa: E402
from analytics_zoo_tpu_torch.models.anomalydetection import (  # noqa: E402
    AnomalyDetector, detect_anomalies, unroll)
from analytics_zoo_tpu_torch.models.bert import (  # noqa: E402
    BERTNER, BERTClassifier, BERTSQuAD)
from analytics_zoo_tpu_torch.models.generative import \
    TinyDecoder  # noqa: E402
from analytics_zoo_tpu_torch.models.image import (  # noqa: E402
    ImageClassifier, inception_v1, resnet)
from analytics_zoo_tpu_torch.models.recommendation import (  # noqa: E402
    NeuralCF, SessionRecommender, UserItemFeature, WideAndDeep)
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq  # noqa: E402
from analytics_zoo_tpu_torch.models.textclassification import \
    TextClassifier  # noqa: E402
from analytics_zoo_tpu_torch.models.textmatching import KNRM  # noqa: E402
from analytics_zoo_tpu_torch.models.textmodels import NER  # noqa: E402
from analytics_zoo_tpu_torch.observability.capture import \
    load_trace_events  # noqa: E402
from analytics_zoo_tpu_torch.observability.registry import (  # noqa: E402
    MetricsRegistry, get_registry)
from analytics_zoo_tpu_torch.observability.roofline import \
    get_accountant  # noqa: E402
from analytics_zoo_tpu_torch.ops import (  # noqa: E402
    autograd, crf, objectives, optimizers)
from analytics_zoo_tpu_torch.ops.autograd import Lambda  # noqa: E402
from analytics_zoo_tpu_torch.serving.broker import MemoryBroker  # noqa: E402
from analytics_zoo_tpu_torch.serving.client import (  # noqa: E402
    InputQueue, OutputQueue)
from analytics_zoo_tpu_torch.serving.decode import \
    DecodeServing  # noqa: E402
from analytics_zoo_tpu_torch.serving.inference_model import (  # noqa: E402
    InferenceModel, _next_bucket)

# Published H100 SXM peaks (NVIDIA data sheet, dense): the least time the
# card could take is max(FLOP / peak of the dtype, bytes / memory rate). An
# f32 check runs without TF32, so its peak is the CUDA cores' f32 rate.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
MEM_BYTES_PER_S = 3.35e12

SOURCES = [fa.SOURCE, fa.BWD_SOURCE, dr.SOURCE, fad.SOURCE, seg.SOURCE,
           da.SOURCE]
CSRC = "analytics_zoo_tpu_torch/csrc/"
KERNELS = [
    {"name": fa.KERNEL_NAME, "route": "cuda", "source": CSRC + fa.SOURCE,
     "replaces": "analytics_zoo_tpu/pallas/flash_attention.py:217"},
    {"name": fa.BWD_DKV_NAME, "route": "cuda",
     "source": CSRC + fa.BWD_SOURCE,
     "replaces": "analytics_zoo_tpu/pallas/flash_attention.py:362"},
    {"name": fa.BWD_DQ_NAME, "route": "cuda", "source": CSRC + fa.BWD_SOURCE,
     "replaces": "analytics_zoo_tpu/pallas/flash_attention.py:323"},
    {"name": dr.KERNEL_NAME, "route": "cuda", "source": CSRC + dr.SOURCE,
     "replaces": "analytics_zoo_tpu/pallas/dropout.py:110"},
    {"name": fad.KERNEL_NAME, "route": "cuda", "source": CSRC + fad.SOURCE,
     "replaces": "analytics_zoo_tpu/pallas/fused_adam.py:93"},
    {"name": seg.KERNEL_NAME, "route": "cuda", "source": CSRC + seg.SOURCE,
     "replaces": "analytics_zoo_tpu/pallas/segment_update.py:77"},
    # the segment sum of `segment_compact`, XLA's scatter-add in the JAX
    # package (no Pallas kernel there); written by hand here so that the
    # sum is the same on every call
    {"name": seg.SUM_NAME, "route": "cuda", "source": CSRC + seg.SOURCE,
     "replaces": "analytics_zoo_tpu/pallas/segment_update.py:69",
     "helper": True},
    {"name": da.KERNEL_NAME, "route": "cuda", "source": CSRC + da.SOURCE,
     "replaces": "analytics_zoo_tpu/pallas/decode_attention.py:113"},
    {"name": da.PAGED_NAME, "route": "cuda", "source": CSRC + da.SOURCE,
     "replaces": "analytics_zoo_tpu/pallas/decode_attention.py:225"},
    # a test aid, on no main path: exports the keep mask the three flash
    # kernels draw (the byte rule of `_keep_scale`) for the checks
    {"name": fa.KEEP_SCALE_NAME, "route": "cuda",
     "source": CSRC + fa.BWD_SOURCE,
     "replaces": "analytics_zoo_tpu/pallas/flash_attention.py:189",
     "test_aid": True},
]

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
# product, where the kernel keeps q·kᵀ in f32 (the tensor cores' bf16
# products are exact in f32) and rounds P·keep to bf16 as the TPU kernel
# does, and O is stored in bf16 (2^-9 relative). lse is f32 from the same
# products in both.
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


def time_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean device ms per call over `reps` calls, by CUDA events, after
    `warm` warm calls."""
    for _ in range(warm):
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


def device_ms(fn, reps: int, warm: int = 3):
    """(ms, "profiler" | "graph"): the mean device time per call and how
    it was taken. "profiler": the time of every CUDA kernel and copy
    `torch.profiler` records over `reps` calls (after `warm` warm ones),
    summed. For calls whose kernels are shorter than their host-side
    launch, CUDA events around a run of calls measure the host's launch
    rate instead; this measures the kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    # Now and then a profiling window records no device activity at all,
    # and the next ones may not either (seen on the card for a run of
    # windows); such a call is timed as a CUDA graph instead.
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / reps, "profiler"
    return graph_ms(fn, reps), "graph"


def median_device_ms(fn, reps: int, windows: int = 3):
    """device_ms's median over `windows` profiling windows, and how it was
    taken: now and then a window misses kernels and reads short (seen on
    the card below the bound)."""
    got = sorted(device_ms(fn, reps) for _ in range(windows))
    return got[windows // 2]


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean device ms per call: `reps` calls captured in one CUDA graph
    (after three warm calls), the graph replayed `replays` times between
    two CUDA events. No host work sits between the calls, so this times
    the device where a call's host side is longer than its kernels; the
    launch gaps inside the graph (about a microsecond a kernel) are
    counted. The calls must not synchronise with the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm on the capturing stream
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


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
    per_source = _build.build(SOURCES)
    ptxas = {src: [line.strip() for line in _build.build_log(src).splitlines()
                   if "registers" in line]
             for src in SOURCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "ptxas": ptxas,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": card})
    for src in (fa.SOURCE, fa.BWD_SOURCE):
        emit({"phase": "flash_kernels", "source": src,
              "ptxas": ptxas_report(src), "sass_hmma": hmma_counts(src)})
    return card


_KERNEL_SYMBOL = re.compile(r"(flash_[fb]wd_\w*?kernel)I(\w*?)EEv")
_DECODE_SYMBOL = re.compile(
    r"decode_attention_kernelI(f|13__nv_bfloat16)Lb([01])E")


def kernel_label(symbol: str):
    """`flash_fwd_mma_kernel<64,0>` for a mangled flash kernel symbol
    (template arguments: f for float, else the int and bool values),
    `decode_attention_kernel<bf16,paged>` for a decode kernel, None for any
    other symbol."""
    m = _DECODE_SYMBOL.search(symbol)
    if m is not None:
        dtype = "f32" if m.group(1) == "f" else "bf16"
        mode = "paged" if m.group(2) == "1" else "contiguous"
        return f"decode_attention_kernel<{dtype},{mode}>"
    m = _KERNEL_SYMBOL.search(symbol)
    if m is None:
        return None
    args = re.findall(r"^f|L[ib](\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(a or 'f' for a in args)}>"


def ptxas_report(source: str) -> dict:
    """{kernel: registers, spill bytes, static shared memory} from
    ptxas's report of the build of `source`."""
    return ptxas_parse(_build.build_log(source))


def ptxas_parse(log: str) -> dict:
    """ptxas_report's table from the text of an nvcc -Xptxas=-v run."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = kernel_label(m.group(1))
            if name is not None:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(m.group(1)) if m else 0
    return out


def hmma_counts(source: str):
    """{kernel<template args>: tensor-core (HMMA) instructions} of each
    flash kernel in the built library of `source`, from `cuobjdump
    -sass`; "not available" without cuobjdump. A report: it decides
    nothing."""
    exe = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.access(exe, os.X_OK):
        exe = shutil.which("cuobjdump")
    if exe is None:
        return "not available"
    res = subprocess.run([exe, "-sass", str(_build.library_path(source))],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        return "not available"
    counts, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = kernel_label(line)
            if name is not None:
                counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


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
                # the seed on the card, as a training step passes it (an
                # int would add a fill a call)
                dev_seed = as_device_seed(seed + 5, "cuda")
                kernel_ms_dropout = time_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, mask, ATTN_DROP_RATE, dev_seed), reps)
                plain_ms = time_ms(lambda: fa._reference_attention(
                    q, k, v, mask), reps)
                lib_mask = None if mask is None else mask.to(dtype)
                library_ms = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, attn_mask=lib_mask), reps)
                bound_ms, bound_by = attention_bound(shape, dtype)
                graph = {}
                if T >= 512:
                    # device time without the wrappers' host side, which
                    # is longer than a bf16 kernel at these shapes
                    graph = {
                        "kernel_graph_ms": graph_ms(
                            lambda: fa.flash_attention_fwd(q, k, v, mask),
                            reps),
                        "kernel_graph_ms_dropout": graph_ms(
                            lambda: fa.flash_attention_fwd(
                                q, k, v, mask, ATTN_DROP_RATE, dev_seed),
                            reps),
                        "library_graph_ms": graph_ms(
                            lambda: F.scaled_dot_product_attention(
                                q, k, v, attn_mask=lib_mask), reps)}
                row = {"phase": "kernel", "kernel": fa.KERNEL_NAME,
                       "shape": list(shape), "dtype": str(dtype)[6:],
                       "masked": masked, "max_abs_err_o": err_o,
                       "max_abs_err_lse": err_lse, "tol_o": tol["o"],
                       "tol_lse": tol["lse"], "ok": ok,
                       "kernel_ms": kernel_ms,
                       "kernel_ms_dropout": kernel_ms_dropout,
                       "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by,
                       "launches": LAUNCHES.get(fa.KERNEL_NAME) - before,
                       **graph, "card": card}
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
    missing = [name for name in (fa.KERNEL_NAME,)
               if counts.get(name, 0) == 0]
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


# ---------------------------------------------------------------------------
# int8 serving and the serving lifecycle
# ---------------------------------------------------------------------------
INT8_BATCHES = (1, 8, 32)
INT8_REQUESTS = 20
INT8_CHECK_BATCH = 3
# The card's int8 path against the port's int8 path on the CPU (the CPU
# tests hold that path to the JAX package at 1.5e-8 on a toy BERT). The
# int8 products are exact on both; what differs is f32 rounding in
# attention, LayerNorm, GELU and tanh (the card's order against the
# CPU's). End to end that is not small: the next per-tensor quantizer
# turns a last-bit difference into a whole quantum (max|x| / 127) for the
# few values it moves across a rounding boundary, and within one block
# the sub-quantum differences those leave move many more across at the
# FFN's two quantizers. So the same run measures the CPU path's own spread
# (half the position embeddings one ulp up, `nextafter`) and reports the
# end-to-end error beside it, with the same top-1 on every row; and the
# card is held at each int8 GEMM, teacher-forced: every product bitwise
# the CPU's `int8_matmul` of the card's operands (an f32 product of the
# same operands, the control, is not), and every f32 stretch between
# GEMMs within INT8_SEGMENT_TOL of the CPU's on the card's inputs: five
# times the flash kernel's own f32 tolerance (ATTN_TOL), ten times below
# the 1e-3 asked of the logits.
INT8_SEGMENT_TOL = 1e-4
# int8 against f32 on the card: the JAX package's bound on BERT's logits,
# max |int8 - f32| / max |f32| (`tests/test_quantization.py:156`).
INT8_DRIFT_BOUND = 0.1
# BERT's four GEMMs at batch 8, seq 512: (M, K, N) of qkv, out, ffn in,
# ffn out.
INT8_GEMMS = {"qkv": (8 * 512, 768, 2304), "out": (8 * 512, 768, 768),
              "ffn_in": (8 * 512, 768, 3072), "ffn_out": (8 * 512, 3072, 768)}
INT8_WINDOW = 4             # batches in flight in the pipelined timing


def int8_gemm_checks(card: str, gen) -> dict:
    """`_int_mm` through `quantization.int8_mm` at BERT's GEMM shapes, on
    the card, against the CPU's exact product (f64 of int8 operands: every
    partial sum is an integer below 2^53); device ms of `_int_mm` with the
    weight row-major, as the wrapper passes it, and column-major, in
    turns; and of a bf16 GEMM of the same shape."""
    from analytics_zoo_tpu_torch.serving.quantization import int8_mm
    rows = {}
    for name, (M, K, N) in INT8_GEMMS.items():
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8,
                          device="cuda", generator=gen)
        w = torch.randint(-127, 128, (K, N), dtype=torch.int8,
                          device="cuda", generator=gen)
        got = int8_mm(a, w)
        want = (a.cpu().double() @ w.cpu().double()).to(torch.int64)
        exact = torch.equal(got.cpu().to(torch.int64), want)
        w_col = w.t().contiguous().t()
        layouts = {"row": [], "col": []}
        for turn in ("row", "col", "col", "row"):
            mat2 = w if turn == "row" else w_col
            layouts[turn].append(time_ms(lambda: torch._int_mm(a, mat2), 20))
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        rows[name] = {"shape": [M, K, N], "exact": exact,
                      "row_major_ms": layouts["row"],
                      "col_major_ms": layouts["col"],
                      "int8_ms": time_ms(lambda: int8_mm(a, w), 20),
                      "bf16_ms": time_ms(lambda: ab @ wb, 20),
                      "bound_ms": 2 * M * K * N / 1979e12 * 1e3}
    emit({"phase": "int8_gemm", "cases": rows, "card": card})
    bad = [n for n, r in rows.items() if not r["exact"]]
    if bad:
        raise SystemExit(f"chip_smoke: int8 GEMM not exact at {bad}")
    return rows


@contextlib.contextmanager
def int8_capture(replay=None):
    """Record what the forwards run inside compute: each encoder block's
    `(block, [h, mask], out)` and each int8 GEMM's `(x, w_q, w_scale, y)`,
    as the served path calls them. With `replay`, an iterator of products,
    each int8 GEMM returns the next of them instead of its own."""
    from analytics_zoo_tpu_torch.keras import transformer as tfm
    from analytics_zoo_tpu_torch.serving import quantization as quant
    rec = {"blocks": [], "gemms": []}
    int8_matmul = quant.int8_matmul
    block_call = tfm.TransformerEncoderBlock.call

    def gemm(x, w_q, w_scale):
        y = int8_matmul(x, w_q, w_scale) if replay is None else next(replay)
        rec["gemms"].append((x, w_q, w_scale, y))
        return y

    def block(self, x, **kw):
        y = block_call(self, x, **kw)
        rec["blocks"].append((self, x, y))
        return y
    quant.int8_matmul = gemm
    tfm.TransformerEncoderBlock.call = block
    try:
        yield rec
    finally:
        quant.int8_matmul = int8_matmul
        tfm.TransformerEncoderBlock.call = block_call


def cpu_bert(state):
    """The port's int8 BERT-base on the CPU (plain attention), from a
    state dict."""
    model = BERTClassifier(NUM_CLASSES, use_flash=True, device="cpu",
                           **BERT_BASE)
    model.load_state_dict(state)
    return InferenceModel(max_batch=32, device="cpu").load_keras(
        model, quantize="int8")


def bert_head(net, h):
    """BERTClassifier's logits from the encoder's last hidden state: the
    pooler and the classifier, int8 in an int8 `net`."""
    from analytics_zoo_tpu_torch.serving.quantization import \
        maybe_int8_matmul
    pooled = torch.tanh(maybe_int8_matmul(h[:, 0], net.bert, "pooler_kernel")
                        + net.bert.pooler_bias)
    return maybe_int8_matmul(pooled, net, "cls_kernel") + net.cls_bias


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def int8_stage_checks(im8, state, check, out8, seed: int) -> dict:
    """The card's int8 forward of `check` held to the port's int8 path on
    the CPU at every int8 GEMM, teacher-forced: each GEMM bitwise the CPU's
    `int8_matmul` of the card's operands (with the f32 product of the same
    operands beside it, the control the bitwise check refuses), and each
    f32 stretch between GEMMs (the embeddings, attention, bias, residual,
    LayerNorm, GELU, tanh) within INT8_SEGMENT_TOL of the CPU's, the CPU's
    blocks and head run on the card's block inputs with the card's
    products replayed. Then end to end against the CPU's forward, beside
    that forward's own spread under a one-ulp nudge of its input."""
    from analytics_zoo_tpu_torch.serving.quantization import int8_matmul
    t0 = time.perf_counter()
    # the hooks see Python calls: an unwarmed model on the same module
    # runs the forward eagerly (a warmed bucket replays its CUDA graph)
    eager8 = InferenceModel(max_batch=32).load_fn(im8._fn,
                                                  im8.current_params())
    with int8_capture() as card:
        out_captured = eager8.predict(check)
    del eager8
    gemms = [tuple(t.cpu() for t in g) for g in card["gemms"]]
    blocks = [(h.cpu(), mask.cpu(), y.cpu())
              for _, (h, mask), y in card["blocks"]]
    del card
    bitwise, control = [], []
    for x, w_q, w_scale, y in gemms:
        bitwise.append(torch.equal(y, int8_matmul(x, w_q, w_scale)))
        control.append(max_err(x @ (w_q.float() * w_scale), y))
    cpu_im = cpu_bert(state)
    q_net = cpu_im.current_params()
    with int8_capture() as cpu:
        cpu8 = cpu_im.predict(check)
    segments = {"embeddings": max_err(blocks[0][0], cpu["blocks"][0][1][0])}
    del cpu
    with torch.inference_mode():
        for i, (h, mask, y) in enumerate(blocks):
            forced = gemms[4 * i:4 * i + 4]
            with int8_capture(replay=iter(g[3] for g in forced)) as cpu:
                out = q_net.bert.blocks[i].call([h, mask])
            for name, (x, *_), (want_x, *_) in zip(
                    ("attention", "ln1", "gelu"), cpu["gemms"][1:],
                    forced[1:]):
                segments[f"block{i}.{name}"] = max_err(x, want_x)
            segments[f"block{i}.ln2"] = max_err(out, y)
        forced = gemms[4 * len(blocks):]
        with int8_capture(replay=iter(g[3] for g in forced)) as cpu:
            logits = bert_head(q_net, blocks[-1][2])
        segments["head.tanh"] = max_err(cpu["gemms"][1][0], forced[1][0])
        segments["head.logits"] = max_err(
            logits[:len(out8)], torch.from_numpy(out8))
    del cpu, gemms, blocks
    pos = state["bert.position_embeddings"]
    up = torch.rand(pos.shape, generator=torch.Generator().manual_seed(
        seed + 42)) < 0.5
    nudged = torch.where(up, torch.nextafter(
        pos, torch.full_like(pos, np.inf)), pos)
    spread = float(np.abs(cpu_bert(dict(state, **{
        "bert.position_embeddings": nudged})).predict(check) - cpu8).max())
    out = {"gemms": len(bitwise), "gemms_bitwise": sum(bitwise),
           "f32_product_err_min": min(control),
           "f32_product_err_max": max(control),
           "segments_max_err": max(segments.values()),
           "segments": segments, "tol": INT8_SEGMENT_TOL,
           "served_path_bitwise": bool(np.array_equal(out_captured, out8)),
           "end_to_end_err": float(np.abs(out8 - cpu8).max()),
           "cpu_one_ulp_spread": spread,
           "top1_equal_rows": int((out8.argmax(-1)
                                   == cpu8.argmax(-1)).sum()),
           "rows": len(out8), "card_logits": out8.tolist(),
           "cpu_logits": cpu8.tolist(),
           "seconds": time.perf_counter() - t0}
    emit(dict(out, phase="int8_vs_cpu"))
    return out


def latencies_ms(im, requests):
    times = []
    for x in requests:
        t1 = time.perf_counter()
        out = im.predict(x)
        times.append((time.perf_counter() - t1) * 1e3)
        if not np.isfinite(out).all():
            raise SystemExit("chip_smoke: non-finite int8 output")
    return times


def pipelined_ms(im, requests, window: int = INT8_WINDOW) -> float:
    """Wall ms a batch with `window` batches in flight: dispatch, and
    materialize the oldest once the window is full."""
    inflight = []
    t0 = time.perf_counter()
    for x in requests:
        if len(inflight) == window:
            inflight.pop(0).result()
        inflight.append(im.predict_async(x))
    for p in inflight:
        p.result()
    return (time.perf_counter() - t0) * 1e3 / len(requests)


def profiled_pipelined(im, requests) -> dict:
    """`pipelined_ms` under torch.profiler: wall ms a batch beside the
    device's busy ms a batch (the union of its kernels' and copies'
    intervals over every stream) and the idle share of the window; and
    the kernels' summed ms a batch, above the busy time where streams
    overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = pipelined_ms(im, requests)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, summed, end = 0.0, 0.0, -math.inf
    for start, stop in spans:
        summed += stop - start
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    busy, summed = (v / 1e3 / len(requests) for v in (busy, summed))
    return {"wall_ms": wall, "device_busy_ms": busy,
            "kernel_sum_ms": summed,
            "idle_share": 1.0 - busy / wall if busy else None}


def phase_int8_serving_lifecycle(card: str, seed: int):
    """BERT-base served int8 through `InferenceModel` at seq 512, and the
    rest of the serving path on it: the int8 GEMM, the artifact, the
    checkpoint sidecar, hot swap, two replicas on the card's streams with
    a quarantine, and the serving roofline."""
    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.learn.checkpoint import save_pytree
    from analytics_zoo_tpu_torch.serving import quantization as quant
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg, T = BERT_BASE, BERT_BASE["seq_len"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    gemms = int8_gemm_checks(card, gen)

    state = convert.params_from_jax(
        random_classifier_tree(cfg, NUM_CLASSES, seed))
    model = BERTClassifier(NUM_CLASSES, use_flash=True, device="cuda", **cfg)
    model.load_state_dict(state)
    t0 = time.perf_counter()
    im8 = InferenceModel(max_batch=32).load_keras(model, quantize="int8")
    quantize_s = time.perf_counter() - t0
    if im8.serving_dtype != "int8":
        raise SystemExit(f"chip_smoke: serving {im8.serving_dtype}, "
                         "expected int8")
    sample = [np.zeros(T, np.int64), np.ones(T, np.int64)]
    im8.warmup(sample)
    emit({"phase": "int8_load", "quantize_and_load_s": quantize_s,
          "warmup_s": im8.warmup_report,
          "weight_bytes": im8.weight_bytes(),
          "f32_weight_bytes": sum(t.numel() * t.element_size()
                                  for t in model.state_dict().values())})

    rs = np.random.default_rng(seed + 41)
    requests = {b: [make_request(rs, b, cfg) for _ in range(INT8_REQUESTS)]
                for b in INT8_BATCHES}
    check = make_request(rs, INT8_CHECK_BATCH, cfg)

    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    forwards = 0
    lat = {}
    for b in INT8_BATCHES:
        lat[b] = latencies_ms(im8, requests[b])
        forwards += len(requests[b])
    out8 = im8.predict(check)
    forwards += 1
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    reg = get_registry()
    roofline = {"roofline_mfu": reg.get("roofline_mfu").value(
                    kind="serving"),
                "roofline_hbm_utilization": reg.get(
                    "roofline_hbm_utilization").value(kind="serving"),
                "snapshot": get_accountant().snapshot("serving")}
    for b in INT8_BATCHES:
        emit({"phase": "int8_serving", "batch": b, "seq_len": T,
              "requests": len(lat[b]),
              "p50_ms": float(np.percentile(lat[b], 50)),
              "p99_ms": float(np.percentile(lat[b], 99)),
              "mean_ms": float(np.mean(lat[b])), "card": card})
    launches = counts.get(fa.KERNEL_NAME, 0)
    emit({"phase": "int8_launches", "counts": counts, "forwards": forwards,
          "flash_per_forward": launches / forwards})
    if launches != cfg["n_block"] * forwards:
        raise SystemExit(f"chip_smoke: {launches} flash launches over "
                         f"{forwards} int8 forwards, expected "
                         f"{cfg['n_block']} per forward")
    emit(dict(roofline, phase="int8_roofline", card=card))
    if not all(0.0 < roofline[k] <= 1.0 for k in (
            "roofline_mfu", "roofline_hbm_utilization")):
        raise SystemExit(f"chip_smoke: serving roofline out of (0, 1]: "
                         f"{roofline}")

    # against the port's int8 path on the CPU, GEMM by GEMM (checked at
    # the end of the phase), and against f32 on the card
    vs_cpu = int8_stage_checks(im8, state, check, out8, seed)
    cpu_ok = (vs_cpu["served_path_bitwise"]
              and vs_cpu["gemms"] == 4 * cfg["n_block"] + 2
              and vs_cpu["gemms_bitwise"] == vs_cpu["gemms"]
              and vs_cpu["f32_product_err_min"] > 0.0
              and vs_cpu["segments_max_err"] <= INT8_SEGMENT_TOL
              and vs_cpu["top1_equal_rows"] == vs_cpu["rows"])
    f32 = InferenceModel(max_batch=32).load_keras(model)
    drift_rows = [make_request(rs, 32, cfg) for _ in range(2)]
    p32 = np.concatenate([f32.predict(x) for x in drift_rows + [check]])
    p8 = np.concatenate([im8.predict(x) for x in drift_rows + [check]])
    drift = float(np.abs(p8 - p32).max() / np.abs(p32).max())
    top1 = float((p8.argmax(-1) == p32.argmax(-1)).mean())
    emit({"phase": "int8_vs_f32", "rows": len(p8), "drift": drift,
          "bound": INT8_DRIFT_BOUND, "top1_agreement": top1,
          "f32_p50_ms_b8": float(np.percentile(
              latencies_ms(f32, requests[8]), 50))})
    del f32
    if not drift < INT8_DRIFT_BOUND:
        raise SystemExit(f"chip_smoke: int8 drifted {drift} from f32")

    with tempfile.TemporaryDirectory() as tmp:
        # the int8 artifact onto a fresh instance
        t1 = time.perf_counter()
        quant.save_quantized(model, os.path.join(tmp, "bert_int8"))
        save_s = time.perf_counter() - t1
        fresh = BERTClassifier(NUM_CLASSES, use_flash=True, device="cuda",
                               **cfg)
        t1 = time.perf_counter()
        art = InferenceModel(max_batch=32).load_quantized(
            fresh, os.path.join(tmp, "bert_int8"))
        load_s = time.perf_counter() - t1
        art_bytes = os.path.getsize(os.path.join(tmp, "bert_int8.npz"))
        f32_bytes = sum(t.numel() * 4 for t in state.values())
        art_equal = np.array_equal(art.predict(check), out8)
        emit({"phase": "int8_artifact", "bytes": art_bytes,
              "f32_bytes": f32_bytes, "ratio": art_bytes / f32_bytes,
              "save_s": save_s, "load_s": load_s, "bitwise": art_equal})
        del art, fresh
        # a checkpoint with its sidecar
        tree = convert.state_to_jax(model.state_dict(), model)
        save_pytree(os.path.join(tmp, "model.1"), tree)
        quant.write_int8_sidecar(tmp, 1, model, params=tree)
        del tree
        t1 = time.perf_counter()
        side = InferenceModel(max_batch=32).load_checkpoint(
            model, tmp, version=1, quantize="int8")
        side_s = time.perf_counter() - t1
        side_equal = np.array_equal(side.predict(check), out8)
        emit({"phase": "int8_sidecar", "load_s": side_s,
              "bitwise_vs_quantize_at_load": side_equal})
        del side
    if not (art_equal and side_equal and art_bytes < 0.5 * f32_bytes):
        raise SystemExit("chip_smoke: int8 artifact or sidecar check failed")

    # hot swap: new weights of the same structure
    state2 = convert.params_from_jax(
        random_classifier_tree(cfg, NUM_CLASSES, seed + 7))
    q2 = quant.quantize_model_params(model, params=state2)
    builds = _build.build_events()
    t1 = time.perf_counter()
    how = im8.swap_params(q2.state_dict())
    swap_s = time.perf_counter() - t1
    swapped = im8.predict(check)
    builds_after = _build.build_events()
    fresh2 = InferenceModel(max_batch=32).load_keras(q2).predict(check)
    swap_equal = np.array_equal(swapped, fresh2)
    emit({"phase": "int8_swap", "result": how, "seconds": swap_s,
          "builds": builds, "builds_after": builds_after,
          "bitwise_vs_fresh_load": swap_equal,
          "changed": not np.array_equal(swapped, out8)})
    if how != "same" or builds_after != builds or not swap_equal:
        raise SystemExit("chip_smoke: same-structure swap check failed")

    # two replicas on the card's streams
    one = im8
    two = InferenceModel(max_batch=32, num_replicas=2,
                         devices=["cuda:0", "cuda:0"]).load_keras(q2)
    two.warmup(sample, buckets=[8, 32])
    rep_equal = all(np.array_equal(two.predict(x), one.predict(x))
                    for x in requests[8][:4] + [check])
    streams = [r.stream for r in two._replicas]
    distinct = len({id(s) for s in streams}) == 2 and all(
        s != torch.cuda.default_stream() for s in streams)
    timing = {}
    for turn in ("one", "two", "two", "one"):
        im = one if turn == "one" else two
        timing.setdefault(turn, []).append({
            "p50_ms": float(np.percentile(latencies_ms(im, requests[8]),
                                          50)),
            "pipelined_ms": pipelined_ms(im, requests[8])})
    profiled = {name: profiled_pipelined(im, requests[8][:8])
                for name, im in (("one", one), ("two", two))}
    emit({"phase": "replicas", "bitwise_vs_one": rep_equal,
          "own_streams": distinct, "batch": 8, "timing": timing,
          "profiled_pipelined": profiled,
          "stats": two.replica_stats(), "placement": two.placement_info(),
          "card": card})

    # a fault on replica 1: the supervisor's rule (quarantine on failure)
    # as a callback; a failed request is sent again, as the serving plane
    # redelivers it
    two._on_replica_event = lambda idx, ok, _s: ok or \
        two.quarantine_replica(idx)
    answered, failures = [], 0
    sent = requests[8][:10]
    with faults.injected("replica.dispatch", faults.Fault(
            mode="raise", match=lambda c: c["replica"] == 1)):
        for x in sent:
            for _ in range(2):
                p = two.predict_async(x)
                try:
                    p.result()
                except faults.FaultError:
                    failures += 1
                    # the worker reports after failing the batch
                    deadline = time.monotonic() + 5.0
                    while not two.quarantined_replicas() \
                            and time.monotonic() < deadline:
                        time.sleep(0.001)
                    continue
                answered.append(p.replica)
                break
        quarantined = two.quarantined_replicas()
        probe_sick = two.probe_replica(1)
    probe_well = two.probe_replica(1)
    revived = two.revive_replica(1)
    after = [two.predict_async(x) for x in requests[8][:4]]
    after_replicas = sorted(p.replica for p in after)
    after_equal = all(np.array_equal(p.result(), one.predict(x))
                      for p, x in zip(after, requests[8][:4]))
    emit({"phase": "quarantine", "answered_by": answered,
          "failures": failures, "quarantined": quarantined,
          "probe_while_faulty": probe_sick, "probe_after": probe_well,
          "revived": revived, "replicas_after": after_replicas,
          "bitwise_after": after_equal})
    two.close()
    ok = (rep_equal and distinct and len(answered) == len(sent)
          and set(answered) == {0} and failures >= 1
          and quarantined == [1] and not probe_sick
          and probe_well and revived and set(after_replicas) == {0, 1}
          and after_equal)
    if not ok:
        raise SystemExit("chip_smoke: replica or quarantine check failed")
    if not cpu_ok:
        raise SystemExit(f"chip_smoke: the card's int8 path against the "
                         f"CPU's failed: {vs_cpu}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "int8_serving_lifecycle", "seconds": seconds})
    return {"counts": counts, "gemms": gemms, "seconds": seconds}




# ---------------------------------------------------------------------------
# backward kernels
# ---------------------------------------------------------------------------
# The training shape (BERT-base, seq 512, batch 32), a smaller batch, the
# seq-2048 leg of bench.py:171, a ragged T, the widest head the kernels
# take and a head dim that is not a multiple of 4.
BWD_SHAPES = [(32, 12, 512, 64), (8, 12, 512, 64), (16, 12, 2048, 64),
              (2, 12, 200, 64), (2, 4, 256, 128), (2, 3, 45, 30)]
BWD_MAIN = (BWD_SHAPES[0], True, torch.bfloat16)
# Gradients of the kernels against autograd of the plain version on the
# same input values (upcast to f32), max abs error over max(1, max |ref|).
# f32: both sum in f32 in other orders, rounding only (a short first call
# measured <= 1.4e-6). bf16: the kernels round P·keep and dS to bf16
# before their products (as the TPU kernels do), store dQ, dK, dV in bf16
# (2^-9 relative each) and form delta from the bf16-rounded O (measured
# <= 5.4e-3 on an H100). The f32 checks run with TF32 off.
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def bwd_bound(shape, dtype, products: int, outputs: int):
    """(ms, "bytes" | "operations") for `products` T×T×D products per head
    (2 FLOP each per multiply-add) against q, k, v, dO read once, the f32
    mask, lse and delta, and `outputs` gradients written once."""
    B, H, T, D = shape
    item = torch.finfo(dtype).bits // 8
    flops = 2.0 * products * B * H * T * T * D
    nbytes = ((4 + outputs) * B * H * T * D * item + B * T * 4
              + 2 * B * H * T * 4)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def plain_grads(q, k, v, mask, do, keep=None):
    """O and (dq, dk, dv) by autograd of the plain version, in f32 from the
    inputs' values."""
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    out = fa._reference_attention(qf, kf, vf, mask, keep)
    out.backward(do.float())
    return out.detach(), (qf.grad, kf.grad, vf.grad)


def rel_err(got, want) -> float:
    return ((got.float() - want).abs().max().item()
            / max(1.0, want.abs().max().item()))


def library_bwd_ms(q, k, v, mask, do, reps: int) -> float:
    """SDPA forward+backward minus SDPA forward, a yardstick only, by CUDA
    graph: autograd's backward has a long host side, so CUDA events around
    a run of calls would time the host as much as the card; the graph
    replays the same kernels with no host work between them, as the
    forward's `library_graph_ms` does."""
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_mask = None if mask is None else mask.to(q.dtype)

    def fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=lib_mask)

    def both():
        return torch.autograd.grad(fwd(), (qs, ks, vs), do)
    return graph_ms(both, reps) - graph_ms(fwd, reps)


def random_attention_inputs(shape, dtype, masked: bool, gen):
    B, H, T, D = shape
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    mask = None
    if masked:
        lengths = torch.randint(1, T + 1, (B,), device="cuda", generator=gen)
        mask = padding_mask(lengths, T)
    return q, k, v, do, mask


# the Cluster Serving phase: BERT-base behind the port's RESP2 server
CS_BATCH = 32               # the engine's batch_size and the model's max
# requests with one in flight, per broker: RESP2 is the cell's wire; the
# memory and TCP legs were cut from 50 to 25 to leave time for the fleet
# phase, and to 10 for the graph phase
CS_SINGLE = {"memory": 10, "tcp": 10, "redis": 50}
CS_CLIENTS = 8              # closed-loop client threads, one request each
CS_REQUESTS = 400           # closed-loop requests in all
CS_ROWS = 64                # distinct id rows the requests cycle through
CS_POISON_MATES = 7         # good records sent in one burst with the poison
CS_STOP_S = 10.0            # stop() must return within this


def _close(broker):
    if hasattr(broker, "close"):
        broker.close()


def _stop_timed(engine) -> float:
    t0 = time.perf_counter()
    engine.stop()
    _close(engine.broker)
    return time.perf_counter() - t0


def _answers(name, got, rows, want, tol):
    """Each answered row against the direct forward of its id row: an
    ndarray (no "NaN", no "SHED"), finite, within `tol`, same argmax."""
    err = 0.0
    for y, r in zip(got, rows):
        if not isinstance(y, np.ndarray) or y.shape != want[r].shape \
                or not np.isfinite(y).all():
            raise SystemExit(f"chip_smoke: {name}: a clean record was "
                             f"answered {y!r}")
        err = max(err, float(np.abs(y - want[r]).max()))
        if int(np.argmax(y)) != int(np.argmax(want[r])):
            raise SystemExit(f"chip_smoke: {name}: argmax differs")
    if err > tol:
        raise SystemExit(f"chip_smoke: {name}: {err} above {tol}")
    return err


def _engine_checks(name, engine, sent: int, reset_dispatches: int) -> dict:
    """Every accepted uri answered exactly once: as many read and served
    as were sent, no duplicate writeback. `reset_dispatches`: the
    dispatches counted before the stage timers were reset."""
    dup = engine._records_total.value(outcome="duplicate")
    if engine.records_read != sent or engine.records_served != sent \
            or dup:
        raise SystemExit(
            f"chip_smoke: {name}: read {engine.records_read}, served "
            f"{engine.records_served}, duplicates {dup} of {sent} sent")
    return {"read": engine.records_read, "served": engine.records_served,
            "dispatches": engine.dispatch_timer.count + reset_dispatches}


def _single_in_flight(url, broker, rows, n_rows, n):
    """`n` requests through `InputQueue.predict`, one in flight, on a
    connection of this thread's own (a `TCPBroker` keeps one socket per
    thread, closed when the thread ends): (latencies ms, answers)."""
    import threading
    from analytics_zoo_tpu_torch.serving.broker import connect_broker
    lat, got, errors = [], [], []

    def run():
        br = broker if url is None else connect_broker(url)
        try:
            q = InputQueue(br)
            for k in range(n):
                t1 = time.perf_counter()
                got.append(q.predict(rows[k % n_rows], timeout_s=60))
                lat.append((time.perf_counter() - t1) * 1e3)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(repr(e))
        finally:
            if br is not broker:
                _close(br)

    t = threading.Thread(target=run, name="cs-single")
    t.start()
    t.join(timeout=300)
    if errors or t.is_alive():
        raise SystemExit(f"chip_smoke: single-request client failed: "
                         f"{errors[:1]}")
    return lat, got


def _closed_loop(url, rows, n_rows):
    """CS_CLIENTS threads, each on its own RedisBroker connection with one
    request in flight, CS_REQUESTS in all: (latencies ms, answers and
    their rows, wall s)."""
    import threading
    from analytics_zoo_tpu_torch.serving.broker import connect_broker
    per = CS_REQUESTS // CS_CLIENTS
    lat = [[] for _ in range(CS_CLIENTS)]
    got = [[] for _ in range(CS_CLIENTS)]
    errors = []

    def client(c):
        br = connect_broker(url)
        try:
            q = InputQueue(br)
            for k in range(per):
                r = (c * per + k) % n_rows
                t1 = time.perf_counter()
                y = q.predict(rows[r], timeout_s=60)
                lat[c].append((time.perf_counter() - t1) * 1e3)
                got[c].append((y, r))
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(repr(e))
        finally:
            br.close()

    threads = [threading.Thread(target=client, args=(c,),
                                name=f"cs-client-{c}")
               for c in range(CS_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"chip_smoke: closed-loop clients failed: "
                         f"{errors[:3]}")
    flat = [x for c in got for x in c]
    return [x for c in lat for x in c], flat, wall


def _busy_share(prof, wall_s: float) -> float:
    """The union of the card's kernel and copy intervals over the window's
    wall time (as `profiled_pipelined` reads it)."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e6 / wall_s


def phase_cluster_serving(card: str, seed: int):
    """BERT-base (f32, TF32 off, seq 512, `use_flash=True`) served by the
    port's `ClusterServing` from a queue: 25 requests with one in flight
    over each of the memory and TCP brokers and 50 over RESP2, a poison
    record among
    good ones, then 8 closed-loop clients on their own RESP2 connections
    to the port's `MiniRedisServer`, with a profiled window. Each answer
    is held against the direct forward of its row."""
    import collections
    import threading
    from torch.profiler import ProfilerActivity, profile
    from analytics_zoo_tpu_torch.serving.broker import (TCPBrokerServer,
                                                        encode_ndarray)
    from analytics_zoo_tpu_torch.serving.client import STREAM
    from analytics_zoo_tpu_torch.serving.redis_server import MiniRedisServer
    from analytics_zoo_tpu_torch.serving.server import ClusterServing
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    threads0 = set(threading.enumerate())
    cfg, T = BERT_BASE, BERT_BASE["seq_len"]
    model = BERTClassifier(NUM_CLASSES, use_flash=True, device="cuda", **cfg)
    model.load_state_dict(convert.params_from_jax(
        random_classifier_tree(cfg, NUM_CLASSES, seed)))
    im = InferenceModel(max_batch=CS_BATCH).load_keras(model)
    im.warmup(np.zeros(T, np.int64))          # ids-only rows, every bucket
    rs = np.random.default_rng(seed + 60)
    rows = rs.integers(0, cfg["vocab"], (CS_ROWS, T), dtype=np.int64)
    want = im.predict(rows)                   # the direct forward
    tol = LOGIT_TOL["float32"]
    # count the forwards the engines dispatch (valid rows of each)
    dispatched = []
    predict_async = im.predict_async

    def counted(x, valid_n=None):
        dispatched.append(valid_n if valid_n is not None else len(x))
        return predict_async(x, valid_n=valid_n)

    im.predict_async = counted
    redis = MiniRedisServer().start()
    tcp = TCPBrokerServer().start()
    urls = {"memory": None, "tcp": f"tcp://{tcp.host}:{tcp.port}",
            "redis": redis.url}
    builds = _build.build_events()
    legs, checks, stops, errs = {}, {}, {}, {}
    replays0 = sum(im.program_replays().values())

    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    for name, url in urls.items():
        broker = MemoryBroker() if url is None else url
        engine = ClusterServing(im, broker=broker, batch_size=CS_BATCH)
        engine.start()
        try:
            lat, got = _single_in_flight(url, engine.broker, rows, CS_ROWS,
                                         CS_SINGLE[name])
            sent = CS_SINGLE[name]
            if name == "redis":
                # a malformed b64 payload among good records, in one burst
                good = [(STREAM, {"uri": f"mate{i}", "data": {
                    "t": encode_ndarray(rows[i])}})
                    for i in range(CS_POISON_MATES)]
                poison = (STREAM, {"uri": "poison", "data": {"t": {
                    "b64": "%%%not-base64", "dtype": "int64",
                    "shape": [T]}}})
                engine.broker.xadd_many(good[:3] + [poison] + good[3:])
                out = OutputQueue(engine.broker)
                uris = [f"mate{i}" for i in range(CS_POISON_MATES)]
                res = {}
                deadline = time.monotonic() + 60
                while len(res) < len(uris) + 1 and \
                        time.monotonic() < deadline:
                    res.update(out.query_many(
                        [u for u in uris + ["poison"] if u not in res],
                        delete=True))
                    time.sleep(0.01)
                p = res.get("poison")
                if not (isinstance(p, float) and np.isnan(p)):
                    raise SystemExit(f"chip_smoke: poison answered {p!r}")
                errs["poison_mates"] = _answers(
                    "poison mates", [res.get(u) for u in uris],
                    range(CS_POISON_MATES), want, tol)
                sent += CS_POISON_MATES + 1
                # the engine's stage timers read the closed loop alone
                timers = {"batch": engine.batch_timer,
                          "decode": engine.decode_timer,
                          "dispatch": engine.dispatch_timer,
                          "sink": engine.sink_timer, "predict": im.timer}
                dispatches_before = engine.dispatch_timer.count
                for tm in timers.values():
                    tm.reset()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t_w = time.perf_counter()
                    n_before = len(dispatched)
                    cl_lat, cl_got, cl_wall = _closed_loop(url, rows,
                                                           CS_ROWS)
                    window_s = time.perf_counter() - t_w
                cl_sizes = dispatched[n_before:]
                stages = {k: {f: tm.snapshot()[f] for f in (
                    "count", "avg_ms", "p50_ms", "p99_ms")}
                    for k, tm in timers.items()}
                sent += CS_REQUESTS
                errs["closed_loop"] = _answers(
                    "closed loop", [y for y, _ in cl_got],
                    [r for _, r in cl_got], want, tol)
            errs[name] = _answers(f"{name} single", got,
                                  [k % CS_ROWS
                                   for k in range(CS_SINGLE[name])],
                                  want, tol)
        finally:
            stops[name] = _stop_timed(engine)
        checks[name] = _engine_checks(
            name, engine, sent,
            dispatches_before if name == "redis" else 0)
        legs[name] = lat
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    replays = sum(im.program_replays().values()) - replays0
    builds_after = _build.build_events()
    im.predict_async = predict_async
    redis.stop()
    tcp.stop()
    for name, lat in legs.items():
        emit({"phase": "cluster_serving_single", "broker": name,
              "requests": len(lat), "in_flight": 1,
              "p50_ms": float(np.percentile(lat, 50)),
              "p99_ms": float(np.percentile(lat, 99)),
              "mean_ms": float(np.mean(lat)), "stop_s": stops[name],
              "max_abs_err": errs[name], "card": card})
    busy = _busy_share(prof, window_s)
    # the closed loop's forwards replay their graphs: the flash kernels the
    # profiler recorded there, beside 12 a forward. Printed, not checked:
    # a window of ~10^5 kernel records loses one now and then (1,920 of
    # 1,944 in one run); the check holds `launches`, which each replay adds
    # from the kernel nodes its graph holds, and the graph phase checks
    # the profiler's count over short windows
    from torch.autograd import DeviceType
    cl_flash = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "flash_fwd" in e.name)
    emit({"phase": "cluster_serving_closed_loop", "broker": "redis",
          "clients": CS_CLIENTS, "requests": CS_REQUESTS,
          "records_per_s": CS_REQUESTS / cl_wall,
          "p50_ms": float(np.percentile(cl_lat, 50)),
          "p99_ms": float(np.percentile(cl_lat, 99)),
          "mean_ms": float(np.mean(cl_lat)),
          "dispatched_batch_sizes": dict(sorted(collections.Counter(
              cl_sizes).items())),
          "device_busy_share": busy, "window_s": window_s,
          "forwards": len(cl_sizes), "profiler_flash_kernels": cl_flash,
          "max_abs_err": errs["closed_loop"], "card": card})
    # the closed loop's batches: read → written back ("batch"), and each
    # stage's share of it; "predict" is dispatch + the wait for the card
    emit({"phase": "cluster_serving_stages", "window": "closed_loop",
          "stages_ms": stages, "card": card})
    forwards = len(dispatched)
    launches = counts.get(fa.KERNEL_NAME, 0)
    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - threads0 and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    left = sorted(t.name for t in set(threading.enumerate()) - threads0)
    engine_dispatches = sum(c["dispatches"] for c in checks.values())
    ok = (launches == cfg["n_block"] * forwards
          and forwards == engine_dispatches and builds_after == builds
          and replays == forwards
          and max(stops.values()) < CS_STOP_S and not left)
    emit({"phase": "cluster_serving_checks", "counts": counts,
          "forwards": forwards, "engine_dispatches": engine_dispatches,
          "graph_replays": replays,
          "flash_per_forward": launches / max(forwards, 1),
          "closed_loop_profiler_flash_per_forward":
              cl_flash / max(len(cl_sizes), 1),
          "builds": builds, "builds_after": builds_after,
          "stop_s": stops, "threads_start": len(threads0),
          "threads_left": left, "engines": checks,
          "poison_mates_max_abs_err": errs["poison_mates"], "tol": tol,
          "ok": ok, "seconds": time.perf_counter() - t_phase,
          "card": card})
    if not ok:
        raise SystemExit("chip_smoke: cluster serving checks failed")
    del im, model
    torch.cuda.empty_cache()
    return {"counts": counts, "profiler": {
        "flash_kernels": cl_flash, "forwards": len(cl_sizes)}}


# ---------------------------------------------------------------------------
# the compile cache for serving: CUDA graphs captured at warmup
# ---------------------------------------------------------------------------
GR_BUCKETS = (1, 8, 32)
GR_REQUESTS = 12            # requests a turn per bucket, in the timed turns
GR_TURNS = ("eager", "graph", "graph", "eager")
GR_PROFILE_REPLAYS = 4
GR_PROFILE_WINDOWS = 5       # a run of windows may record nothing
GR_CHECK_ROWS = 3
GR_PIPE_REQUESTS = 24       # pipelined batches of 8 a turn (replicas)
# Graph against eager on the same module and inputs: a CUDA graph replays
# the kernels its capture recorded with the arguments the eager run
# passes, and cuBLAS picked the same algorithms under capture in every
# run on the card (PERF.md), so the checks require the outputs bitwise
# equal, in f32, bf16 and int8.
GR_CLI_START_S = 300.0
GR_RESUME_STEPS = 6         # decode steps before the first engine dies
GR_RESUME_NEW = 24


def _flash_events(im, x, reps: int, want: int,
                  windows: int = GR_PROFILE_WINDOWS):
    """Flash-forward kernels the profiler records over `reps` predicts (a
    replay's kernels are traced one by one), after one untraced warm-up
    step of the profiler's schedule: window after window until one counts
    `want`, at most `windows`. A window that records no device activity
    counts None, and fails like a wrong count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    seen = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for n in (1, reps):
                for _ in range(n):
                    im.predict(x)
                torch.cuda.synchronize()
                prof.step()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        seen.append(int(sum(e.count for e in rows if "flash_fwd" in e.key))
                    if rows else None)
        if seen[-1] == want:
            break
    return seen


def _graph_leg(card, dtype_name, net, requests, check, cc, quantize=None):
    """One BERT-base precision: a graphed model (warmup captures buckets
    1, 8 and 32) and an eager model on the same module; outputs, launches
    and replays, a profiler window, p50 / p99 of both in turns, the graph
    pools' bytes."""
    sample = [np.zeros(BERT_BASE["seq_len"], np.int64),
              np.ones(BERT_BASE["seq_len"], np.int64)]
    g = InferenceModel(max_batch=32, compile_cache=cc).load_keras(
        net, quantize=quantize)
    t0 = time.perf_counter()
    g.warmup(sample, buckets=list(GR_BUCKETS))
    warm_s = time.perf_counter() - t0
    e = InferenceModel(max_batch=32).load_fn(g._fn, g.current_params())
    if g.serving_dtype != dtype_name:
        raise SystemExit(f"chip_smoke: serving {g.serving_dtype}, "
                         f"expected {dtype_name}")
    errs, bitwise, top1 = {}, True, True
    for b in GR_BUCKETS:
        x = requests[b][0]
        og, oe = g.predict(x), e.predict(x)
        errs[b] = float(np.abs(og - oe).max())
        bitwise = bitwise and bool(np.array_equal(og, oe))
        top1 = top1 and bool((og.argmax(-1) == oe.argmax(-1)).all())
    # -- replays: launches and program runs over predicts of every bucket
    replays0 = g.program_replays()
    LAUNCHES.reset()
    forwards = 0
    for b in GR_BUCKETS:
        for x in requests[b][:4]:
            g.predict(x)
            forwards += 1
    counts = LAUNCHES.snapshot()
    replays = {k: v - replays0.get(k, 0)
               for k, v in g.program_replays().items()}
    flash_want = BERT_BASE["n_block"] * GR_PROFILE_REPLAYS
    flash_seen = _flash_events(g, requests[32][0], GR_PROFILE_REPLAYS,
                               flash_want)
    # -- p50 / p99, eager and graphed in turns
    lat = {}
    for mode in GR_TURNS:
        im = g if mode == "graph" else e
        for b in GR_BUCKETS:
            lat.setdefault((mode, b), []).extend(
                latencies_ms(im, requests[b][:GR_REQUESTS]))
    timing = {f"{mode}_b{b}": {
        "p50_ms": float(np.percentile(v, 50)),
        "p99_ms": float(np.percentile(v, 99)), "requests": len(v)}
        for (mode, b), v in sorted(lat.items())}
    pools = g.graph_pool_bytes()
    row = {"phase": "graph_serving", "dtype": dtype_name,
           "buckets": list(GR_BUCKETS), "warmup_s": warm_s,
           "warmup_report": g.warmup_report,
           "warmup_source": g.warmup_source,
           "graph_vs_eager_max_abs_err": errs, "bitwise": bitwise,
           "top1_equal": top1,
           "forwards": forwards, "launches": counts,
           "flash_per_forward": counts.get(fa.KERNEL_NAME, 0) / forwards,
           "replays": replays,
           "profiler_flash_kernels": flash_seen,
           "profiler_replays": GR_PROFILE_REPLAYS,
           "timing": timing,
           "graph_pool_bytes": {f"r{k}": v for k, v in pools.items()},
           "programs": g.compile_cache_size(), "card": card}
    emit(row)
    ok = (bitwise and top1
          and counts.get(fa.KERNEL_NAME, 0) == BERT_BASE["n_block"]
          * forwards
          and sum(replays.values()) == forwards
          and all(v in ("compiled", "cached")
                  for v in g.warmup_source.values())
          and flash_want in flash_seen)
    if not ok:
        raise SystemExit(f"chip_smoke: graph serving check failed "
                         f"({dtype_name})")
    return g, e, row


def _graph_pool_ladder(card, net):
    """The graph pool of BERT-base f32 with every bucket up to 512
    captured (largest first), one replica: its bytes, the warmup's
    seconds, and the allocator's peak beside the weights."""
    sample = [np.zeros(BERT_BASE["seq_len"], np.int64),
              np.ones(BERT_BASE["seq_len"], np.int64)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    im = InferenceModel(max_batch=512).load_keras(net)
    t0 = time.perf_counter()
    im.warmup(sample)
    warm_s = time.perf_counter() - t0
    pools = im.graph_pool_bytes()
    row = {"phase": "graph_pool_ladder", "dtype": "float32",
           "buckets": sorted(im.warmed_buckets), "warmup_s": warm_s,
           "warmup_report": im.warmup_report,
           "graph_pool_bytes": {f"r{k}": v for k, v in pools.items()},
           "weight_bytes": im.weight_bytes(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "card": card}
    emit(row)
    del im
    torch.cuda.empty_cache()
    if not pools or not all(pools.values()):
        raise SystemExit("chip_smoke: no graph pool bytes for the ladder")
    return row


def _graph_swaps(card, g, base_state, requests, check, seed):
    """On the f32 graphed model: a batch dispatched before a "same" swap
    answers with the old weights, the next as an eager forward with the
    new ones, with no capture and no build; a "restructured" swap to int8
    recaptures and answers as eager int8."""
    from analytics_zoo_tpu_torch.serving import quantization as quant
    cfg = BERT_BASE
    x = requests[8][0]
    old = g.predict(x)
    state2 = convert.params_from_jax(
        random_classifier_tree(cfg, NUM_CLASSES, seed + 5))
    net2 = BERTClassifier(NUM_CLASSES, use_flash=True, device="cuda", **cfg)
    net2.load_state_dict(state2)
    eager2 = InferenceModel(max_batch=32).load_keras(net2)
    want2 = eager2.predict(x)
    builds, programs = _build.build_events(), g.compile_cache_size()
    pending = g.predict_async(x)
    t0 = time.perf_counter()
    how = g.swap_params(state2)
    same_s = time.perf_counter() - t0
    before = pending.result()
    got2 = g.predict(x)
    same = {"result": how, "seconds": same_s,
            "dispatched_before_is_old": bool(np.array_equal(before, old)),
            "next_vs_eager_new_max_abs_err": float(
                np.abs(got2 - want2).max()),
            "next_bitwise_eager_new": bool(np.array_equal(got2, want2)),
            "changed": not np.array_equal(got2, old),
            "builds_unchanged": _build.build_events() == builds,
            "programs_unchanged": g.compile_cache_size() == programs}
    q2 = quant.quantize_model_params(net2)
    want8 = InferenceModel(max_batch=32).load_keras(q2).predict(x)
    t0 = time.perf_counter()
    how8 = g.swap_params(q2.state_dict())
    re_s = time.perf_counter() - t0
    got8 = g.predict(x)
    restructured = {"result": how8, "seconds": re_s,
                    "serving_dtype": g.serving_dtype,
                    "warmup_source": g.warmup_source,
                    "vs_eager_int8_max_abs_err": float(
                        np.abs(got8 - want8).max()),
                    "bitwise_eager_int8": bool(np.array_equal(got8, want8)),
                    "programs": g.compile_cache_size(),
                    "builds_unchanged": _build.build_events() == builds}
    emit({"phase": "graph_swaps", "same": same,
          "restructured": restructured, "card": card})
    ok = (how == "same" and same["dispatched_before_is_old"]
          and same["changed"] and same["builds_unchanged"]
          and same["programs_unchanged"]
          and same["next_bitwise_eager_new"]
          and how8 == "restructured" and g.serving_dtype == "int8"
          and restructured["bitwise_eager_int8"]
          and restructured["programs"] == programs)
    del eager2, net2, q2
    if not ok:
        raise SystemExit("chip_smoke: graph swap checks failed")
    return {"same": same, "restructured": restructured}


def _graph_replicas(card, net, e_one, g_one, requests, cc):
    """Two replicas on one card's streams, graphed, against one replica,
    eager and graphed, at a pipelined batch of 8, in turns."""
    sample = [np.zeros(BERT_BASE["seq_len"], np.int64),
              np.ones(BERT_BASE["seq_len"], np.int64)]
    devs = ["cuda:0", "cuda:0"]
    two_g = InferenceModel(max_batch=32, num_replicas=2, devices=devs,
                           compile_cache=cc).load_keras(net)
    two_g.warmup(sample, buckets=[8])
    two_e = InferenceModel(max_batch=32, num_replicas=2,
                           devices=devs).load_keras(net)
    reqs = (requests[8] * 4)[:GR_PIPE_REQUESTS]
    models = {"one_eager": e_one, "one_graph": g_one, "two_eager": two_e,
              "two_graph": two_g}
    for im in models.values():          # eager replicas' first calls
        pipelined_ms(im, reqs[:4])
    order = list(models) + list(reversed(list(models)))
    timing = {}
    for name in order:
        timing.setdefault(name, []).append(pipelined_ms(models[name], reqs))
    agree = all(np.array_equal(two_g.predict(x), g_one.predict(x))
                for x in requests[8][:4])
    pools = two_g.graph_pool_bytes()
    row = {"phase": "graph_replicas", "batch": 8, "window": INT8_WINDOW,
           "pipelined_ms": timing,
           "pipelined_ms_mean": {k: float(np.mean(v))
                                 for k, v in timing.items()},
           "two_graph_bitwise_one_graph": agree,
           "warmup_source": two_g.warmup_source,
           "graph_pool_bytes": {f"r{k}": v for k, v in pools.items()},
           "card": card}
    emit(row)
    two_g.close()
    two_e.close()
    if not agree or len(pools) != 2:
        raise SystemExit("chip_smoke: graphed replicas check failed")
    return row


def build_dir_env(root, name):
    """The environment of a child with an empty kernel build directory of
    its own (`$AZT_KERNEL_BUILD_DIR`): what it does not find in its
    compile cache, it builds."""
    path = os.path.join(root, f"build_{name}")
    os.makedirs(path)
    return dict(os.environ, AZT_KERNEL_BUILD_DIR=path)


def _graph_cold_start(card, model_dir, want_row, row, root):
    """`cli start` as a user runs it, with `--compile-cache-dir` naming an
    empty cache and an empty build directory of its own: seconds from the
    spawn to the first answer, the model built and the buckets warmed, the
    buckets' sources and the builds (nvcc builds the flash library, every
    bucket "compiled"). The cache it leaves is the fleet phase's: its two
    engines restart warm from it. The decode library is put in it from
    this process, one payload byte flipped: the fleet's generative
    `cli start` must rebuild that entry and still answer correctly."""
    from analytics_zoo_tpu_torch.compile_cache import CompileCache
    from analytics_zoo_tpu_torch.compile_cache import store as ccstore
    from analytics_zoo_tpu_torch.serving.broker import connect_broker
    from analytics_zoo_tpu_torch.serving.redis_server import MiniRedisServer
    cfg = FLEET_BERT
    conf = "".join(f"    {k}: {v}\n" for k, v in cfg.items())
    redis = MiniRedisServer().start()
    cfg_path = os.path.join(root, "bert_cold.yaml")
    with open(cfg_path, "w") as fh:
        fh.write("model:\n  class: BERTClassifier\n"
                 f"  path: {model_dir}\n  config:\n"
                 f"    num_classes: {NUM_CLASSES}\n    use_flash: true\n"
                 f"{conf}broker: {redis.url}\nparams:\n"
                 f"  batch_size: {CS_BATCH}\n"
                 f"  warmup_shapes: \"{cfg['seq_len']}\"\n"
                 "  warmup_dtype: int64\n")
    cache_dir = os.path.join(root, "cli_cache")
    tol = LOGIT_TOL["float32"]
    try:
        t0 = time.perf_counter()
        child = _Child("cold_start", ["start", "--config", cfg_path,
                                      "--compile-cache-dir", cache_dir],
                       env=build_dir_env(root, "cold_start"))
        try:
            br = connect_broker(redis.url)
            try:
                y = InputQueue(br).predict(row, timeout_s=GR_CLI_START_S)
            finally:
                br.close()
            first_s = time.perf_counter() - t0
            source = json.loads(child.wait_line("warmup source: ", 30)[
                len("warmup source: "):])
            started = child.json_lines("kernel_counts")
        finally:
            code, stop_s = child.terminate()
    finally:
        redis.stop()
    builds = started[0]["builds"] if started else None
    err = float(np.abs(np.asarray(y) - want_row).max())
    libs = [e for e in ccstore.scan_dir(cache_dir)
            if e.get("header", {}).get("kind") == "kernel"]
    # the decode library beside the flash one, then one byte flipped
    _build.load(da.SOURCE, cache=CompileCache(cache_dir,
                                              registry=MetricsRegistry()))
    decode = [e for e in ccstore.scan_dir(cache_dir)
              if e.get("header", {}).get("kind") == "kernel"
              and e["header"]["signature"]["tree"] == da.SOURCE]
    if decode:
        victim = os.path.join(cache_dir, decode[0]["file"])
        blob = bytearray(open(victim, "rb").read())
        blob[-100] ^= 0xFF
        open(victim, "wb").write(bytes(blob))
    out = {"phase": "graph_cold_start", "first_answer_s": first_s,
           "model_built_s": child.seconds_to("placement=", t0),
           "warmed_s": child.seconds_to("warmed ", t0),
           "warmup_report": json.loads(child.find("warmed ").split(
               ": ", 1)[1]) if child.find("warmed ") else None,
           "warmup_source": source, "builds": builds, "exit": code,
           "stop_s": stop_s, "max_abs_err": err, "tol": tol,
           "kernel_entries": len(libs), "decode_entry_flipped":
               bool(decode), "card": card}
    emit(out)
    ok = (code == 0 and err <= tol and builds is not None
          and builds["compiles"] >= 1 and len(libs) == 1 and decode
          and set(source.values()) == {"compiled"})
    if not ok:
        raise SystemExit(f"chip_smoke: cold start checks failed: "
                         f"{child.lines[-20:]}")
    return dict(out, cache_dir=cache_dir)


def phase_graphs(card: str, seed: int):
    """The compile cache for serving: BERT-base at seq 512 served from
    CUDA graphs captured at warmup (f32, bf16, int8; buckets 1, 8, 32)
    against the eager forward on the same module, swaps, two graphed
    replicas, and the warm restart of `cli start` through
    `compile_cache_dir`."""
    from analytics_zoo_tpu_torch.compile_cache import CompileCache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = BERT_BASE
    state = convert.params_from_jax(
        random_classifier_tree(cfg, NUM_CLASSES, seed))
    base = BERTClassifier(NUM_CLASSES, use_flash=True, device="cuda", **cfg)
    base.load_state_dict(state)
    rs = np.random.default_rng(seed + 80)
    requests = {b: [make_request(rs, b, cfg) for _ in range(GR_REQUESTS)]
                for b in GR_BUCKETS}
    check = make_request(rs, GR_CHECK_ROWS, cfg)
    tmp = tempfile.mkdtemp(prefix="graph_smoke_")
    ok = False
    try:
        # the weights `cli start` serves: the fleet's model
        model_dir = os.path.join(tmp, "model")
        os.makedirs(model_dir)
        fleet_model = BERTClassifier(NUM_CLASSES, use_flash=True,
                                     device="cuda", **FLEET_BERT)
        fleet_model.load_state_dict(convert.params_from_jax(
            random_classifier_tree(FLEET_BERT, NUM_CLASSES, seed)))
        fleet_model.save_weights(os.path.join(model_dir, "weights"))
        cc = CompileCache(os.path.join(tmp, "cc"),
                          registry=MetricsRegistry())
        legs = {}
        g32, e32, legs["float32"] = _graph_leg(card, "float32", base,
                                               requests, check, cc)
        ladder = _graph_pool_ladder(card, base)
        bf16 = copy.deepcopy(base).to(torch.bfloat16)
        g16, _, legs["bfloat16"] = _graph_leg(card, "bfloat16", bf16,
                                              requests, check, cc)
        del g16, bf16
        g8, _, legs["int8"] = _graph_leg(card, "int8", base, requests,
                                         check, cc, quantize="int8")
        del g8
        torch.cuda.empty_cache()
        replicas = _graph_replicas(card, base, e32, g32, requests, cc)
        # `cli start` serves ids-only rows, as the Cluster Serving phase
        want_row = fleet_model.predict(check[0][:1])[0]
        del fleet_model
        swaps = _graph_swaps(card, g32, state, requests, check, seed)
        del g32, e32
        torch.cuda.empty_cache()
        cold = _graph_cold_start(card, model_dir, want_row, check[0][0],
                                 tmp)
        ok = True
    finally:
        # the cache stays for the fleet phase, which removes it
        if not ok:
            shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "graphs", "seconds": seconds,
          "cache_stats": {"entries": cc.stats()["entries"],
                          "bytes": cc.stats()["bytes"]}, "card": card})
    del base
    torch.cuda.empty_cache()
    return {"legs": legs, "replicas": replicas, "swaps": swaps,
            "cold": cold, "ladder": ladder, "seconds": seconds,
            "cache_root": tmp, "cache_dir": cold["cache_dir"]}


# the model of the cold `cli start` and of the fleet: BERT-base's widths
# at a third of its depth (4 of 12 blocks), cut to pay for the
# distributed phase: its weights file (written, read and CRC-checked by
# every engine start and rollout) falls from 438 MB to about 210 MB
FLEET_BERT = dict(BERT_BASE, n_block=4)
FS_ROWS = 32                # distinct id rows (each held against v1 and v2)
FS_SINGLE = 50              # gateway requests with one in flight
FS_BURST = 24               # requests in flight when an engine is killed
FS_INPROC = 8               # HTTP requests in the in-process leg
FS_TTL_S = 3.0              # engine_ttl_s; heartbeats every 0.5 s
FS_CLAIM_IDLE_S = 2.0       # a dead engine's records are claimable after
FS_START_S = 300.0          # children up and converged on v1 within this
FS_STOP_S = 30.0            # a child exits on SIGTERM within this
FS_LEAK_TOL = 64 << 20      # a few cuBLAS workspaces; BERT-base is 438 MB
FS_GEN = dict(slots=8, max_kv_len=256, max_new_tokens=32)
FS_GEN_REQUESTS = 8
FS_STREAM = "serving_stream"


class _Child:
    """One `python -m analytics_zoo_tpu_torch.serving.cli ...` process,
    its output (stdout and stderr) collected on a daemon thread."""

    def __init__(self, name, args, env=None):
        import threading
        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.cli",
             *args], cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        self.lines = []
        self.times = []             # perf_counter() at each line's arrival
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name=f"fleet-child-{name}")
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.times.append(time.perf_counter())
            self.lines.append(line.rstrip("\n"))

    def seconds_to(self, prefix, t0):
        """Seconds from `t0` to the first line starting with `prefix`."""
        for t, line in zip(list(self.times), list(self.lines)):
            if line.startswith(prefix):
                return t - t0
        return None

    def find(self, prefix):
        return next((ln for ln in list(self.lines)
                     if ln.startswith(prefix)), None)

    def json_lines(self, key):
        out = []
        for ln in list(self.lines):
            if ln.startswith("{") and f'"{key}"' in ln:
                try:
                    out.append(json.loads(ln))
                except ValueError:
                    pass
        return out

    def wait_line(self, prefix, timeout_s):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            line = self.find(prefix)
            if line is not None:
                return line
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise SystemExit(f"chip_smoke: {self.name} printed no {prefix!r} "
                         f"(exit {self.proc.poll()}): {self.lines[-30:]}")

    def terminate(self, timeout_s=FS_STOP_S):
        """SIGTERM, then (exit code, seconds to exit); a child still up
        after `timeout_s` is killed and reads (None, timeout_s)."""
        import signal
        t0 = time.perf_counter()
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            code = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
            code = None
        self._reader.join(timeout=10)
        return code, time.perf_counter() - t0


def _http_json(url, body=None, timeout=60):
    """(status, parsed body) of one request; an HTTP error's body too."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except ValueError:
            return e.code, None


def _http_text(url, timeout=30):
    import urllib.request
    req = urllib.request.Request(url, headers={"Accept": "text/plain"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


def _wait_for(pred, timeout_s, what, interval=0.1):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(interval)
    raise SystemExit(f"chip_smoke: timed out waiting for {what}")


def _predict(base, row):
    """One `POST /predict` of one id row: (ms, status, logits or None,
    request id or None)."""
    t0 = time.perf_counter()
    code, body = _http_json(base + "/predict",
                            {"instances": [row.tolist()]})
    ms = (time.perf_counter() - t0) * 1e3
    if code != 200:
        return ms, code, None, None
    y = np.asarray(body["predictions"][0], np.float32)
    rid = (body.get("request_ids") or [None])[0]
    return ms, code, y, rid


def _check_answer(name, y, want, tol):
    """An answer against the direct forward of its row: finite, within
    `tol`, the same argmax; its error."""
    if y is None or y.shape != want.shape or not np.isfinite(y).all():
        raise SystemExit(f"chip_smoke: {name}: answered {y!r}")
    err = float(np.abs(y - want).max())
    if err > tol or int(np.argmax(y)) != int(np.argmax(want)):
        raise SystemExit(f"chip_smoke: {name}: error {err} (tol {tol}) or "
                         "argmax differs")
    return err


def _fleet_records(text, outcome="served"):
    """serving_records_total{outcome} from a fleet Prometheus scrape: the
    scope="fleet" rollup and the sum of the per-engine series."""
    fleet, engines = 0.0, 0.0
    for line in text.splitlines():
        if not line.startswith("serving_records_total{"):
            continue
        labels, _, value = line.rpartition(" ")
        if f'outcome="{outcome}"' not in labels:
            continue
        if 'scope="fleet"' in labels:
            fleet += float(value)
        elif 'engine="' in labels:
            engines += float(value)
    return fleet, engines


def _bert_config(path, model_dir, url, rollout_dir, cfg):
    """The engines' serving config: the BERT-base classifier by class, its
    weights at `<model_dir>/weights`, the fleet plane on, rollout from
    `rollout_dir`."""
    conf = "".join(f"    {k}: {v}\n" for k, v in cfg.items())
    with open(path, "w") as fh:
        fh.write(
            "model:\n  class: BERTClassifier\n"
            f"  path: {model_dir}\n  config:\n"
            f"    num_classes: {NUM_CLASSES}\n    use_flash: true\n{conf}"
            f"broker: {url}\n"
            "params:\n"
            f"  batch_size: {CS_BATCH}\n"
            f"  warmup_shapes: \"{cfg['seq_len']}\"\n"
            "  warmup_dtype: int64\n"
            "  heartbeat_interval_s: 0.5\n"
            f"  engine_ttl_s: {FS_TTL_S}\n"
            f"  claim_min_idle_s: {FS_CLAIM_IDLE_S}\n"
            "  claim_interval_s: 0.5\n"
            "  trace_sample: 1.0\n"
            "  trace_export_interval_s: 0.5\n"
            "  fleet_metrics_interval_s: 0.5\n"
            "  rollout:\n"
            f"    model_dir: {rollout_dir}\n"
            "    poll_interval_s: 0.5\n")


def _converged(base, version, n_engines):
    """The gateway's rollout status once every alive engine serves
    `version` and the controller is idle on it; else None."""
    code, st = _http_json(base + "/rollout/status")
    if code != 200:
        return None
    versions = st.get("fleet_versions") or {}
    if st["state"] == "idle" and st["active_version"] == version and \
            len(versions) == n_engines and \
            all(v == version for v in versions.values()):
        return st
    return None


def _fleet_alive(base):
    code, h = _http_json(base + "/healthz")
    return (h or {}).get("fleet", {}).get("alive") if h else None


def _fleet_claims(base):
    """serving_claimed_records_total's scope="fleet" rollup."""
    return sum(float(ln.rpartition(" ")[2])
               for ln in _http_text(base + "/metrics").splitlines()
               if ln.startswith("serving_claimed_records_total{")
               and 'scope="fleet"' in ln)


def _beat_rows(url):
    from analytics_zoo_tpu_torch.serving.broker import connect_broker
    from analytics_zoo_tpu_torch.serving.fleet import engines_key
    br = connect_broker(url)
    try:
        return [json.loads(v) for v in
                br.hgetall(engines_key(FS_STREAM)).values()]
    finally:
        br.close()


def _gen_config(path, url):
    conf = "".join(f"    {k}: {v}\n" for k, v in GEN_CFG.items())
    gen = "".join(f"    {k}: {v}\n" for k, v in FS_GEN.items())
    with open(path, "w") as fh:
        fh.write("model:\n  class: TinyDecoder\n  config:\n" + conf
                 + f"broker: {url}\nhttp_port: 0\nparams:\n"
                 "  heartbeat_interval_s: 0.5\n"
                 f"  engine_ttl_s: {FS_TTL_S}\n"
                 "  generative:\n" + gen)


def _sse_tokens(base, prompt, max_new):
    """One `POST /predict?stream=1`: (token frames seen, final tokens)."""
    import urllib.request
    body = json.dumps({"prompt": prompt.tolist(),
                       "max_new": int(max_new)}).encode()
    req = urllib.request.Request(base + "/predict?stream=1", data=body)
    frames, done, event = 0, None, None
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                payload = json.loads(line[len("data: "):])
                if event == "done":
                    done = payload
                elif event == "error":
                    raise SystemExit(f"chip_smoke: SSE error {payload}")
                else:
                    frames += 1
                event = None
    if done is None or "tokens" not in done:
        raise SystemExit(f"chip_smoke: SSE stream ended without tokens: "
                         f"{done!r}")
    return frames, [int(t) for t in done["tokens"]]


def _reference_tokens(prompts, max_new):
    """The same prompts through an in-process `DecodeServing` on the same
    weights (TinyDecoder's seed-0 `init_params`), one request at a time
    as the SSE leg sends them: (tokens, decode-kernel launches, steps)."""
    from analytics_zoo_tpu_torch.serving.decode import _pow2_ladder
    dec = TinyDecoder(**GEN_CFG, device="cuda")
    im = InferenceModel(device="cuda").load_generative(
        dec.prefill_fn, dec.step_fn, dec.init_params())
    kv_b = _pow2_ladder(8, FS_GEN["max_kv_len"])
    pr_b = _pow2_ladder(4, max(4, FS_GEN["max_kv_len"] // 2))
    im.warmup_generative(dec.init_kv, slots=FS_GEN["slots"],
                         max_kv_len=FS_GEN["max_kv_len"],
                         prompt_buckets=pr_b, kv_buckets=kv_b)
    broker = MemoryBroker()
    engine = DecodeServing(im, dec.init_kv, broker=broker,
                           slots=FS_GEN["slots"],
                           max_kv_len=FS_GEN["max_kv_len"],
                           kv_buckets=kv_b, prompt_buckets=pr_b,
                           max_new_default=FS_GEN["max_new_tokens"],
                           registry=MetricsRegistry())
    engine.start()
    tokens = []
    try:
        LAUNCHES.reset()
        inq, outq = InputQueue(broker), OutputQueue(broker)
        for i, p in enumerate(prompts):
            uri = inq.enqueue(uri=f"ref{i}", t=p, max_new=int(max_new))
            got = None
            deadline = time.monotonic() + 120
            while got is None and time.monotonic() < deadline:
                got = outq.query(uri, delete=True)
                if got is None:
                    time.sleep(0.002)
            if got is None:
                raise SystemExit("chip_smoke: reference decode timed out")
            tokens.append([int(t) for t in np.asarray(got).reshape(-1)])
        counts = LAUNCHES.snapshot()
        steps = engine.stats["steps"]
    finally:
        engine.stop(drain=False)
    del engine, im, dec
    torch.cuda.empty_cache()
    return tokens, counts, steps


def _inprocess_leg(cfg_path, url, rows, want, tol, card):
    """The engine built as `cmd_start` builds it (`ServingConfig.load`,
    `build_model`, the warmup of every reachable bucket, `ClusterServing`,
    `FrontEnd`), in this process, under `leak_check`: flash launches per
    dispatched forward, no kernel built after warmup,
    `device_memory_snapshot` against the allocator."""
    import gc
    from analytics_zoo_tpu_torch.observability import (
        device_memory_snapshot, leak_check)
    from analytics_zoo_tpu_torch.serving.broker import connect_broker
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    from analytics_zoo_tpu_torch.serving.http_frontend import FrontEnd
    from analytics_zoo_tpu_torch.serving.server import ClusterServing
    T = rows.shape[1]
    with leak_check(tolerance_bytes=FS_LEAK_TOL) as lc:
        cfg = ServingConfig.load(cfg_path)
        cfg.engine_id = "inprocess"      # the fleet has stopped by now
        # registries of their own: the process-wide one would keep the
        # engine's gauge closures (and the model) past this leg
        registry = MetricsRegistry()
        broker = connect_broker(cfg.broker_url)
        model = cfg.build_model(broker=broker)
        cap = _next_bucket(cfg.batch_size, model.buckets)
        model.warmup(np.zeros(T, np.int64),
                     buckets=[b for b in model.buckets if b <= cap])
        dispatched = []
        predict_async = model.predict_async

        def counted(x, valid_n=None):
            dispatched.append(valid_n if valid_n is not None else len(x))
            return predict_async(x, valid_n=valid_n)

        model.predict_async = counted
        builds = _build.build_events()
        serving = ClusterServing(
            model, broker, stream=cfg.stream, batch_size=cfg.batch_size,
            batch_timeout_ms=cfg.batch_timeout_ms, engine_id=cfg.engine_id,
            heartbeat_interval_s=cfg.heartbeat_interval_s,
            claim_min_idle_s=cfg.claim_min_idle_s,
            trace_sample=cfg.trace_sample,
            trace_export_interval_s=cfg.trace_export_interval_s,
            fleet_metrics_interval_s=cfg.fleet_metrics_interval_s,
            registry=registry).start()
        fe = FrontEnd(broker, None, host="127.0.0.1", port=0,
                      fleet_stream=cfg.stream, engine_ttl_s=cfg.engine_ttl_s,
                      trace_sample=cfg.trace_sample,
                      registry=MetricsRegistry()).start()
        fe._srv.serving = serving
        base = f"http://127.0.0.1:{fe.port}"
        try:
            # -- the main path: every count is 0 just before -------------
            LAUNCHES.reset()
            errs = [_check_answer("in-process", _predict(base, rows[k])[2],
                                  want[k], tol) for k in range(FS_INPROC)]
            counts = LAUNCHES.snapshot()
            # ---------------------------------------------------------------
            builds_after = _build.build_events()
            snap = device_memory_snapshot()
            allocated = torch.cuda.memory_allocated(0)
        finally:
            fe.stop()
            serving.stop()
            broker.close()
        forwards = len(dispatched)
        del model, serving, fe, counted, predict_async, registry
        gc.collect()
    launches = counts.get(fa.KERNEL_NAME, 0)
    live = snap["cuda:0"]["live_bytes"]
    ok = (launches == FLEET_BERT["n_block"] * forwards and forwards >= 1
          and builds_after == builds and live == allocated
          and snap["cuda:0"]["source"] == "memory_stats")
    out = {"phase": "fleet_inprocess", "requests": FS_INPROC,
           "forwards": forwards, "counts": counts,
           "flash_per_forward": launches / max(forwards, 1),
           "builds": builds, "builds_after": builds_after,
           "snapshot_live_bytes": live, "memory_allocated": allocated,
           "leak_grew_bytes": lc.grew, "leak_tol_bytes": FS_LEAK_TOL,
           "max_abs_err": max(errs), "tol": tol, "ok": ok, "card": card}
    emit(out)
    if not ok:
        raise SystemExit("chip_smoke: in-process fleet leg failed")
    return counts


def phase_fleet_serving(card: str, seed: int, graphs=None):
    """The fleet plane, the HTTP front end and the serving CLI, as a user
    runs them: a `cli gateway` and two `cli start` BERT-base engines
    (f32, seq 512, flash forward) over the port's `MiniRedisServer`, with
    heartbeats, fleet metrics, merged traces and a live rollout from a
    `CheckpointManager` run dir; a SIGKILLed engine; the engine built in
    this process as `cmd_start` builds it; a generative `cli start`
    (TinyDecoder at GPT-2 small's widths) streaming SSE; SIGTERM to every
    child."""
    import shutil
    import signal
    import threading
    from analytics_zoo_tpu_torch.learn.checkpoint import (
        CheckpointManager, write_publish_marker)
    from analytics_zoo_tpu_torch.serving.broker import connect_broker
    from analytics_zoo_tpu_torch.serving.redis_server import MiniRedisServer
    from analytics_zoo_tpu_torch.serving.server import GROUP
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    threads0 = set(threading.enumerate())
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "fleet_setup", "compute_mode": mode, "card": card})
    if "Exclusive_Process" in mode:
        raise SystemExit("chip_smoke: the card is in Exclusive_Process "
                         "compute mode; two engine processes cannot share "
                         "it")
    cfg, T = FLEET_BERT, FLEET_BERT["seq_len"]
    tol = LOGIT_TOL["float32"]
    tmp = tempfile.mkdtemp(prefix="fleet_smoke_")
    children, codes = {}, {}
    redis = MiniRedisServer().start()
    redis_gen = None
    try:
        # -- setup: weights v1 (the model dir) and v2, the direct forwards
        tree1 = random_classifier_tree(cfg, NUM_CLASSES, seed)
        tree2 = random_classifier_tree(cfg, NUM_CLASSES, seed + 1)
        model = BERTClassifier(NUM_CLASSES, use_flash=True, device="cuda",
                               **cfg)
        model.load_state_dict(convert.params_from_jax(tree1))
        model_dir = os.path.join(tmp, "model")
        os.makedirs(model_dir)
        model.save_weights(os.path.join(model_dir, "weights"))
        im = InferenceModel(max_batch=CS_BATCH).load_keras(model)
        rows = np.random.default_rng(seed + 70).integers(
            0, cfg["vocab"], (FS_ROWS, T), dtype=np.int64)
        want1 = im.predict(rows)
        im.swap_params(convert.params_from_jax(tree2))
        want2 = im.predict(rows)
        del im, model
        torch.cuda.empty_cache()
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        mgr.save(1, tree1)
        write_publish_marker(mgr.run_dir, 1)
        cfg_path = os.path.join(tmp, "bert.yaml")
        _bert_config(cfg_path, model_dir, redis.url, mgr.root, cfg)
        t_setup = time.perf_counter() - t_phase

        # -- the fleet: a gateway and two engines, as a user starts them --
        children["gateway"] = _Child("gateway", [
            "gateway", "--broker", redis.url, "--host", "127.0.0.1",
            "--port", "0", "--engine-ttl", str(FS_TTL_S),
            "--rollout-dir", mgr.root, "--rollout-interval", "0.5",
            "--trace-sample", "1.0", "--engine-config", cfg_path])
        # each engine restarts warm from the graph phase's compile cache,
        # with an empty build directory of its own: nvcc runs 0 times
        cache_args = ["--compile-cache-dir", graphs["cache_dir"]] \
            if graphs else []
        for name in ("engine_a", "engine_b"):
            children[name] = _Child(name, [
                "start", "--config", cfg_path, "--engine-id", "auto",
                *cache_args], env=build_dir_env(tmp, name))
        t_spawn = time.perf_counter()
        port = children["gateway"].wait_line(
            "fleet gateway on :", 120).split(":")[1].split()[0]
        base = f"http://127.0.0.1:{port}"
        _wait_for(lambda: _fleet_alive(base) == 2, FS_START_S,
                  "two engines alive by heartbeat")
        first_ms, code, y, _ = _predict(base, rows[0])
        t_first = time.perf_counter() - t_spawn
        _check_answer("first answer", y, want1[0], tol)
        _wait_for(lambda: _converged(base, 1, 2), FS_START_S,
                  "the fleet on version 1")
        eids, warm = {}, {}
        for name in ("engine_a", "engine_b"):
            line = children[name].wait_line("engine id ", 60)
            eids[name] = line.split()[2]
            src = children[name].wait_line("warmup source: ", 30)
            started = children[name].json_lines("kernel_counts")
            warm[name] = {
                "warmup_source": json.loads(src[len("warmup source: "):]),
                "builds": started[0]["builds"] if started else None,
                "warmed_s": children[name].seconds_to("warmed ", t_spawn)}
        emit({"phase": "fleet_warm_restart", "engines": warm,
              "start_to_first_answer_s": t_first,
              "cache": bool(graphs), "card": card})
        if graphs and not all(
                w["builds"] and w["builds"]["compiles"] == 0
                and w["builds"]["cached"] >= 1
                and set(w["warmup_source"].values()) == {"cached"}
                for w in warm.values()):
            raise SystemExit("chip_smoke: the fleet engines' warm restart "
                             "built a kernel or missed the cache")
        sent = 1

        # -- leg 1: serving through the gateway, one in flight ------------
        lat, errs, rids = [], [], []
        for k in range(FS_SINGLE):
            ms, code, y, rid = _predict(base, rows[k % FS_ROWS])
            errs.append(_check_answer("gateway", y, want1[k % FS_ROWS],
                                      tol))
            lat.append(ms)
            rids.append(rid)
        sent += FS_SINGLE
        alive = _fleet_alive(base)
        fleet_served = _wait_for(
            lambda: (lambda f: f if f[0] == sent and f[1] == sent else None)(
                _fleet_records(_http_text(base + "/metrics"))), 30,
            "the fleet served rollup")

        def merged_trace():
            code, doc = _http_json(base + f"/trace/{rids[-1]}")
            if code != 200:
                return None
            engines = set(doc["engines"])
            if not any(e.startswith("gateway") for e in engines) or \
                    not engines & set(eids.values()):
                return None
            return doc
        doc = _wait_for(merged_trace, 30, "a merged trace")
        gw_name = next(e for e in doc["engines"] if e.startswith("gateway"))
        names = sorted({e["name"] for e in doc["traceEvents"]})
        # where a request's time goes, from the merged traces of the last
        # ten: the medians of the critical path's parts and of coverage
        summaries = [b for c, b in (_http_json(
            base + f"/trace/{rid}/summary") for rid in rids[-10:])
            if c == 200 and any(e.startswith("gateway")
                                for e in b["engines"])]
        path_ms = {k: float(np.median([sm["critical_path_ms"][k]
                                       for sm in summaries]))
                   for k in summaries[0]["critical_path_ms"]} \
            if summaries else None
        emit({"phase": "fleet_gateway", "requests": FS_SINGLE,
              "in_flight": 1, "p50_ms": float(np.percentile(lat, 50)),
              "p99_ms": float(np.percentile(lat, 99)),
              "mean_ms": float(np.mean(lat)),
              "start_to_first_answer_s": t_first,
              "first_answer_ms": first_ms, "engines_alive": alive,
              "fleet_served": fleet_served[0],
              "engines_served_sum": fleet_served[1], "sent": sent,
              "trace_engines": doc["engines"], "trace_gateway": gw_name,
              "trace_span_names": names, "traces_summarised": len(summaries),
              "trace_e2e_ms_median": float(np.median(
                  [sm["e2e_ms"] for sm in summaries])) if summaries else None,
              "critical_path_ms_median": path_ms,
              "trace_coverage_median": float(np.median(
                  [sm["coverage"] for sm in summaries])) if summaries
              else None, "max_abs_err": max(errs),
              "tol": tol, "setup_s": t_setup, "card": card})
        if alive != 2 or not {"gateway_request", "wire", "decode",
                              "writeback"} <= set(names):
            raise SystemExit("chip_smoke: gateway leg checks failed")

        # -- leg 2: a live rollout to v2 with traffic flowing --------------
        flow, stop_flow, flow_err = [], threading.Event(), []

        def client():
            k = 0
            try:
                while not stop_flow.is_set():
                    r = k % FS_ROWS
                    t_sent = time.perf_counter()
                    _, code, y, _ = _predict(base, rows[r])
                    flow.append((r, t_sent, code, y))
                    k += 1
            except Exception as e:  # noqa: BLE001 — raised below
                flow_err.append(repr(e))

        flow_thread = threading.Thread(target=client, name="fleet-flow")
        flow_thread.start()
        try:
            time.sleep(0.5)
            t_pub = time.perf_counter()
            mgr.save(2, tree2)
            write_publish_marker(mgr.run_dir, 2)
            t_published = time.perf_counter()
            status = _wait_for(lambda: _converged(base, 2, 2), 240,
                               "the fleet on version 2")
            t_conv = time.perf_counter()
            time.sleep(1.0)
        finally:
            stop_flow.set()
            flow_thread.join(timeout=120)
        if flow_err or flow_thread.is_alive():
            raise SystemExit(f"chip_smoke: rollout client failed: "
                             f"{flow_err[:1]}")
        h = _http_json(base + "/healthz")[1]
        beat_versions = sorted(row.get("model_version") for row in
                               h["fleet"]["engines"].values()
                               if row.get("alive"))
        v1_n = v2_n = 0
        roll_err = 0.0
        for r, t_sent, code, y in flow:
            if code != 200 or y is None or not np.isfinite(y).all():
                raise SystemExit(f"chip_smoke: rollout lost a request "
                                 f"({code}, {y!r})")
            e1 = float(np.abs(y - want1[r]).max())
            e2 = float(np.abs(y - want2[r]).max())
            if t_sent >= t_conv:
                e1 = math.inf          # after convergence: v2 only
            if min(e1, e2) > tol:
                raise SystemExit(f"chip_smoke: a rollout answer matched "
                                 f"neither version ({e1}, {e2})")
            v1_n += e1 <= e2
            v2_n += e2 < e1
            roll_err = max(roll_err, min(e1, e2))
        sent += len(flow)
        emit({"phase": "fleet_rollout", "requests": len(flow),
              "answered_v1": int(v1_n), "answered_v2": int(v2_n),
              "publish_s": t_published - t_pub,
              "convergence_s": t_conv - t_pub,
              "convergence_after_publish_s": t_conv - t_published,
              "heartbeat_versions": beat_versions,
              "status": {k: status[k] for k in (
                  "state", "active_version", "fleet_versions",
                  "quarantined")},
              "max_abs_err": roll_err, "tol": tol, "card": card})
        if beat_versions != [2, 2] or not v2_n:
            raise SystemExit("chip_smoke: rollout checks failed")

        # -- leg 3: SIGKILL an engine with requests in flight --------------
        # engine_b is frozen while the burst lands, so engine_a reads it;
        # engine_a is killed as soon as it holds records, then engine_b
        # thaws and its claim sweep answers them
        b_pid = children["engine_b"].proc.pid
        poll = connect_broker(redis.url)
        os.kill(b_pid, signal.SIGSTOP)
        burst, burst_threads = {}, []
        try:
            pending0 = poll.pending_count(FS_STREAM, GROUP)

            def one(k):
                burst[k] = _predict(base, rows[k % FS_ROWS])

            for k in range(FS_BURST):
                burst_threads.append(threading.Thread(
                    target=one, args=(k,), name=f"fleet-burst-{k}"))
                burst_threads[-1].start()
            _wait_for(lambda: poll.pending_count(FS_STREAM, GROUP)
                      > pending0, 30, "engine_a holding records",
                      interval=0.002)
            children["engine_a"].proc.kill()
            t_kill = time.perf_counter()
            held = poll.pending_count(FS_STREAM, GROUP) - pending0
        finally:
            os.kill(b_pid, signal.SIGCONT)
            poll.close()
        for t in burst_threads:
            t.join(timeout=120)
        t_last = time.perf_counter()
        kill_err = max(_check_answer("after kill", burst[k][2],
                                     want2[k % FS_ROWS], tol)
                       for k in range(FS_BURST))
        sent += FS_BURST
        t_one = _wait_for(lambda: _fleet_alive(base) == 1 and
                          time.perf_counter(), FS_TTL_S * 10,
                          "the gateway dropping the killed engine")
        claims = _wait_for(lambda: _fleet_claims(base), 15,
                           "a record claimed from the killed engine")
        emit({"phase": "fleet_kill", "burst": FS_BURST,
              "pending_at_kill": held, "claimed_by_peer": claims,
              "kill_to_last_answer_s": t_last - t_kill,
              "kill_to_one_engine_s": t_one - t_kill,
              "engine_ttl_s": FS_TTL_S, "claim_min_idle_s": FS_CLAIM_IDLE_S,
              "exit_code_killed": children["engine_a"].proc.wait(timeout=30),
              "max_abs_err": kill_err, "tol": tol, "card": card})

        # -- the BERT fleet stops on SIGTERM --------------------------------
        for name in ("engine_b", "gateway"):
            codes[name] = children[name].terminate()
        # the surviving engine's own counts, from its output: its flash
        # launches between "started" and "stopped" are 12 a forward, the
        # forwards being its dispatches and the two a rollout swap runs
        # (the old version's and the canary's answer to the golden input)
        served_b = children["engine_b"].json_lines("stages")
        kc_b = children["engine_b"].json_lines("kernel_counts")
        swaps_b = sum("now serves model version" in ln
                      for ln in children["engine_b"].lines)
        child_launch = None
        if served_b and len(kc_b) == 2:
            child_launch = {
                "dispatches": served_b[-1]["stages"]["dispatch"]["count"],
                "swaps": swaps_b,
                "flash_launches": kc_b[1]["launches"].get(fa.KERNEL_NAME, 0)
                - kc_b[0]["launches"].get(fa.KERNEL_NAME, 0),
                "builds_start": kc_b[0]["builds"],
                "builds_stop": kc_b[1]["builds"]}
        emit({"phase": "fleet_engine_b_counts", "counts": child_launch,
              "card": card})
        if child_launch is None or child_launch["flash_launches"] != \
                FLEET_BERT["n_block"] * (child_launch["dispatches"]
                                        + 2 * swaps_b) or \
                child_launch["builds_start"]["compiles"] != \
                child_launch["builds_stop"]["compiles"]:
            raise SystemExit("chip_smoke: the surviving engine's launch "
                             "counts do not show the flash kernel path")

        # -- leg 4: the engine in this process, launches and memory --------
        inproc_counts = _inprocess_leg(cfg_path, redis.url, rows, want1, tol,
                                       card)

        # -- leg 5: generative through the CLI, SSE ------------------------
        redis_gen = MiniRedisServer().start()
        gen_path = os.path.join(tmp, "gen.yaml")
        _gen_config(gen_path, redis_gen.url)
        rs = np.random.default_rng(seed + 80)
        prompts = [rs.integers(0, GEN_CFG["vocab"], int(n), dtype=np.int64)
                   for n in rs.integers(8, 100, FS_GEN_REQUESTS)]
        max_new = FS_GEN["max_new_tokens"]
        # its compile cache holds the decode library with one payload byte
        # flipped (the graph phase): that entry rebuilds
        children["generative"] = _Child("generative", [
            "start", "--config", gen_path, "--engine-id", "auto",
            *cache_args], env=build_dir_env(tmp, "generative"))
        t_gen = time.perf_counter()
        gport = children["generative"].wait_line(
            "http frontend on :", FS_START_S).split(":")[1].split()[0]
        children["generative"].wait_line("cluster serving started",
                                         FS_START_S)
        t_started = time.perf_counter()
        gbase = f"http://127.0.0.1:{gport}"
        beat = _wait_for(lambda: _beat_rows(redis_gen.url), 30,
                         "the decode engine's heartbeat row")
        sse, frames = [], 0
        t_sse = time.perf_counter()
        for p in prompts:
            n, toks = _sse_tokens(gbase, p, max_new)
            frames += n
            sse.append(toks)
        sse_s = time.perf_counter() - t_sse
        codes["generative"] = children["generative"].terminate()
        kc_g = children["generative"].json_lines("kernel_counts")
        stats_g = children["generative"].json_lines("steps")
        ref, gen_counts, ref_steps = _reference_tokens(prompts, max_new)
        child_steps = stats_g[-1]["steps"] if stats_g else None
        child_dec = (kc_g[1]["launches"].get(da.KERNEL_NAME, 0)
                     - kc_g[0]["launches"].get(da.KERNEL_NAME, 0)) \
            if len(kc_g) == 2 else None
        gen_builds = kc_g[0]["builds"] if kc_g else None
        gen_ok = (sse == ref and beat and beat[0].get("role") == "decode"
                  and gen_counts.get(da.KERNEL_NAME, 0)
                  == GEN_CFG["n_layers"] * ref_steps
                  and child_steps is not None
                  and child_dec == GEN_CFG["n_layers"] * child_steps
                  and (not graphs or (gen_builds is not None
                                      and gen_builds["compiles"] == 1)))
        emit({"phase": "fleet_generative", "requests": FS_GEN_REQUESTS,
              "max_new": max_new, "tokens_equal_in_process": sse == ref,
              "sse_token_frames": frames, "sse_seconds": sse_s,
              "start_to_serving_s": t_started - t_gen,
              "heartbeat_row": beat[0], "launches_in_process": gen_counts,
              "steps_in_process": ref_steps,
              "child_decode_launches": child_dec,
              "child_steps": child_steps,
              "child_builds_flipped_entry": gen_builds,
              "ok": bool(gen_ok),
              "card": card})
        if not gen_ok:
            raise SystemExit("chip_smoke: generative CLI leg failed")
    finally:
        for name, child in children.items():
            if name not in codes and name != "engine_a":
                codes[name] = child.terminate()
            elif name == "engine_a" and child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(timeout=30)
        redis.stop()
        if redis_gen is not None:
            redis_gen.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        if graphs:
            shutil.rmtree(graphs["cache_root"], ignore_errors=True)
    # -- leg 6: every child exited 0 on SIGTERM, nothing left behind --------
    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - threads0 and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    left = sorted(t.name for t in set(threading.enumerate()) - threads0
                  if not t.daemon)
    alive = [n for n, c in children.items() if c.proc.poll() is None]
    ok = (all(code == 0 and s < FS_STOP_S for code, s in codes.values())
          and not left and not alive)
    emit({"phase": "fleet_shutdown",
          "exit_codes": {n: c for n, (c, _) in codes.items()},
          "exit_s": {n: s for n, (_, s) in codes.items()},
          "stop_bound_s": FS_STOP_S, "threads_left": left,
          "children_alive": alive, "ok": ok,
          "seconds": time.perf_counter() - t_phase, "card": card})
    if not ok:
        raise SystemExit("chip_smoke: fleet shutdown checks failed")
    return {"counts": inproc_counts, "gen_counts": gen_counts}


def phase_backward(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    results, failed = {}, []
    for shape in BWD_SHAPES:
        B, H, T, D = shape
        for masked in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, do, mask = random_attention_inputs(shape, dtype,
                                                            masked, gen)
                o, lse = fa.flash_attention_fwd(q, k, v, mask)
                dq, dk, dv = fa.flash_attention_bwd(q, k, v, mask, o, lse, do)
                torch.cuda.synchronize()
                _, ref = plain_grads(q, k, v, mask, do)
                errs = {n: rel_err(g, r) for n, g, r in
                        zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
                del ref
                tol = BWD_TOL[dtype]
                ok = (max(errs.values()) <= tol and all(
                    bool(torch.isfinite(g).all()) for g in (dq, dk, dv)))
                reps = 3 if T >= 2048 else (5 if B * T >= 16384 else 10)
                delta = fa._delta(o, do)
                kernel_ms = time_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, mask, o, lse, do), reps)
                dkv_ms = time_ms(lambda: fa._launch_bwd_dkv(
                    q, k, v, mask, do, lse, delta), reps)
                dq_ms = time_ms(lambda: fa._launch_bwd_dq(
                    q, k, v, mask, do, lse, delta), reps)
                # the seed on the card, as a training step passes it
                drop = (ATTN_DROP_RATE, as_device_seed(seed + 5, "cuda"))
                kernel_ms_dropout = time_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, mask, o, lse, do, *drop), reps)
                dkv_ms_dropout = time_ms(lambda: fa._launch_bwd_dkv(
                    q, k, v, mask, do, lse, delta, *drop), reps)
                dq_ms_dropout = time_ms(lambda: fa._launch_bwd_dq(
                    q, k, v, mask, do, lse, delta, *drop), reps)
                plain_ms = time_ms(lambda: fa._reference_attention_bwd(
                    q, k, v, mask, o, lse, do), reps)
                library_ms = library_bwd_ms(q, k, v, mask, do, reps)
                kernel_graph_ms = graph_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, mask, o, lse, do), reps)
                bound_ms, bound_by = bwd_bound(shape, dtype, 5, 3)
                row = {"phase": "backward", "shape": list(shape),
                       "dtype": str(dtype)[6:], "masked": masked,
                       "rel_err": errs, "tol": tol, "ok": ok,
                       "kernel_ms": kernel_ms, "dkv_ms": dkv_ms,
                       "dq_ms": dq_ms,
                       "kernel_ms_dropout": kernel_ms_dropout,
                       "dkv_ms_dropout": dkv_ms_dropout,
                       "dq_ms_dropout": dq_ms_dropout, "plain_ms": plain_ms,
                       "kernel_graph_ms": kernel_graph_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by,
                       "dkv_bound": bwd_bound(shape, dtype, 4, 2),
                       "dq_bound": bwd_bound(shape, dtype, 3, 1),
                       "card": card}
                emit(row)
                results[(shape, masked, dtype)] = row
                if not ok:
                    failed.append(row)
                del q, k, v, do, mask, o, lse, dq, dk, dv, delta
                torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: {len(failed)} backward case(s) "
                         "outside tolerance")
    return results


# ---------------------------------------------------------------------------
# attention dropout
# ---------------------------------------------------------------------------
ATTN_DROP_RATE = 0.1
ATTN_DROP_SHAPES = [(8, 12, 512, 64), (2, 3, 45, 30)]


def keep_fraction_z(frac: float, p: float, n: int) -> float:
    """How many standard deviations a Bernoulli(p) mean over n draws is
    from p."""
    return (frac - p) / math.sqrt(p * (1.0 - p) / n)


def phase_attention_dropout(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    rate = ATTN_DROP_RATE
    t = dr._byte_threshold(rate)
    rows = []
    for shape in ATTN_DROP_SHAPES:
        B, H, T, D = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, mask = random_attention_inputs(shape, dtype, True,
                                                        gen)
            s1 = seed * 1000 + 17
            keep = fa.keep_scale_matrix(shape, rate, s1, "cuda")
            same = torch.equal(keep, fa.keep_scale_matrix(shape, rate, s1,
                                                          "cuda"))
            other = fa.keep_scale_matrix(shape, rate, s1 + 1, "cuda")
            other_differs = float((other != keep).float().mean())
            philox_equal = torch.equal(keep, attention_keep_scale(
                B * H, T, s1, t, "cuda").view(B, H, T, T))
            frac = float((keep > 0).float().mean())
            z = keep_fraction_z(frac, t / 256.0, keep.numel())
            o, lse = fa.flash_attention_fwd(q, k, v, mask, rate, s1)
            grads = fa.flash_attention_bwd(q, k, v, mask, o, lse, do, rate,
                                           s1)
            torch.cuda.synchronize()
            ref_o, ref = plain_grads(q, k, v, mask, do, keep)
            # the gradients agree with the plain version given the forward's
            # mask, and not given another seed's: the backward drew the
            # forward's bits
            _, ref_other = plain_grads(q, k, v, mask, do, other)
            errs = {n: rel_err(g, r) for n, g, r in
                    zip(("dq", "dk", "dv"), grads, ref)}
            err_o = rel_err(o, ref_o)
            err_other = min(rel_err(g, r) for g, r in zip(grads, ref_other))
            tol = BWD_TOL[dtype]
            ok = (max(errs.values()) <= tol and err_o <= tol
                  and err_other > 10 * tol and same and philox_equal
                  and other_differs > 0.05 and abs(z) <= 5.0)
            row = {"phase": "attention_dropout", "shape": list(shape),
                   "dtype": str(dtype)[6:], "rate": rate, "byte_t": t,
                   "rel_err_o": err_o, "rel_err": errs,
                   "rel_err_other_seed_mask": err_other, "tol": tol,
                   "keep_fraction": frac, "expected": t / 256.0,
                   "z": z, "same_seed_same_mask": same,
                   "other_seed_differs_frac": other_differs,
                   "export_equals_plain_philox": philox_equal, "ok": ok,
                   "card": card}
            emit(row)
            rows.append(row)
    if not all(r["ok"] for r in rows):
        raise SystemExit("chip_smoke: attention dropout check failed")
    return rows


# ---------------------------------------------------------------------------
# dropout kernel
# ---------------------------------------------------------------------------
DROPOUT_SHAPE = (32, 512, 768)
DROPOUT_RATE = 0.1


def phase_dropout(card: str, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed + 30)
    rate = DROPOUT_RATE
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(DROPOUT_SHAPE, device="cuda", generator=gen).to(dtype)
        s1 = seed * 1000 + 29
        out = dr.dropout_apply(x, rate, s1)
        torch.cuda.synchronize()
        keep = (out != 0) & (x != 0)
        zero = torch.zeros((), dtype=dtype, device="cuda")
        scale_t = dr._scale(rate, dtype).cuda()
        exact = torch.equal(out, torch.where(keep, x * scale_t, zero))
        keep_bits = dr.dropout_keep(x.shape, s1, rate, "cuda")
        plain = dr._reference_dropout(x, rate, keep_bits)
        max_abs_err = (out.float() - plain.float()).abs().max().item()
        p_keep = 1.0 - dr._dropout_threshold(rate) / 2 ** 32
        frac = float(keep.float().mean())
        z = keep_fraction_z(frac, p_keep, keep.numel())
        xg = x.clone().requires_grad_()
        y = dr.fused_dropout(xg, rate, seed=s1)
        y.backward(torch.ones_like(y))
        # dout = 1: the gradient is the backward's mask times the scale
        bwd_mismatch = int((xg.grad != torch.where(
            keep_bits, scale_t, zero)).sum())
        bwd_same = torch.equal(y.detach(), out) and bwd_mismatch == 0
        rate0 = dr.fused_dropout(x, 0.0, seed=s1) is x
        rate1 = not bool(dr.fused_dropout(x, 1.0, seed=s1).any())
        ok = (exact and max_abs_err == 0.0 and abs(z) <= 5.0 and bwd_same
              and rate0 and rate1)
        # device time: one launch of this kernel is shorter than the
        # host's side of it (CUDA events over 50 calls are kept as wall_ms)
        # timed with the seed on the card, as a training step passes it (an
        # int would add a fill a call)
        dev_seed = as_device_seed(s1, "cuda")
        kernel_ms, kernel_by = device_ms(
            lambda: dr.dropout_apply(x, rate, dev_seed), 50)
        wall_ms = time_ms(lambda: dr.dropout_apply(x, rate, dev_seed), 50)
        plain_ms, plain_by = device_ms(lambda: dr._reference_dropout(
            x, rate, dr.dropout_keep(x.shape, s1, rate, "cuda")), 5)
        library_ms, library_by = device_ms(
            lambda: F.dropout(x, rate, training=True), 50)
        item = torch.finfo(dtype).bits // 8
        bound_ms = 2.0 * x.numel() * item / MEM_BYTES_PER_S * 1e3
        row = {"phase": "dropout", "shape": list(DROPOUT_SHAPE),
               "dtype": str(dtype)[6:], "rate": rate,
               "exact_vs_own_mask": exact, "max_abs_err": max_abs_err,
               "keep_fraction": frac, "expected": p_keep, "z": z,
               "backward_mask_equal": bwd_same,
               "backward_mismatches": bwd_mismatch,
               "zeros_in_x": int((x == 0).sum()), "rate0_identity": rate0,
               "rate1_zeros": rate1, "ok": ok, "kernel_ms": kernel_ms,
               "wall_ms": wall_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "timed_by": {"kernel_ms": kernel_by, "plain_ms": plain_by,
                            "library_ms": library_by},
               "bound_ms": bound_ms, "bound_by": "bytes", "card": card}
        emit(row)
        results[dtype] = row
        del x, out, plain, xg, y
    if not all(r["ok"] for r in results.values()):
        raise SystemExit("chip_smoke: dropout kernel check failed")
    return results


# ---------------------------------------------------------------------------
# fused Adam
# ---------------------------------------------------------------------------
ADAM_HP = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


def adam_sweep(params, mu, nu, grads, count):
    hp = ADAM_HP
    fad.fused_adam_step(params, mu, nu, grads, count, lr=hp["lr"],
                        b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                        weight_decay=hp["weight_decay"])


def adam_sweep_leaf_by_leaf(plan):
    """The kernel at one leaf a launch (the launch pattern before the
    multi-tensor kernel): a sweep's table launched by `plan`
    (`fad._launch_plan(numel, 1)`, made once)."""
    hp = ADAM_HP

    def sweep(params, mu, nu, grads, count):
        table = fad._build_table(*(list(d.values())
                                   for d in (params, mu, nu, grads)))
        fad._launch(table._replace(launches=plan),
                    fad._fold_scalars(count, hp["lr"], hp["b1"], hp["b2"],
                                      hp["eps"], hp["weight_decay"]),
                    hp["b1"], hp["b2"])
    return sweep


def plain_adam_sweep(params, mu, nu, grads, count):
    """The plain version, leaf by leaf, in place."""
    hp = ADAM_HP
    sc = fad._fold_scalars(count, hp["lr"], hp["b1"], hp["b2"], hp["eps"],
                           hp["weight_decay"])
    for i in params:
        pn, mn, vn = fad._adam_math(params[i].float(), mu[i], nu[i],
                                    grads[i].float(), *sc, hp["b1"],
                                    hp["b2"])
        params[i].copy_(pn)
        mu[i].copy_(mn)
        nu[i].copy_(vn)


def adam_max_err(got, want) -> float:
    return max(((a[i].float() - b[i].float()).abs().max().item()
                for a, b in zip(got, want) for i in a if a[i].numel()),
               default=0.0)


def host_ms(fn, reps: int) -> float:
    """Host ms a call to issue `reps` calls (after three warm ones and a
    synchronize), not waiting for the device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def adam_three_steps(leaves, pdtype, gen):
    """Random params (`pdtype`) and f32 moments in each leaf's shape and
    memory format (`leaves`: tensors; a channels_last conv kernel stays
    channels_last, its moments and gradient with it), stepped 3 times by
    the kernel and by the plain version on the same random gradients:
    (params, mu, nu, the last grads, the plain version's (params, mu, nu),
    kernel launches, max abs difference, whether the kernel wrote in
    place)."""
    def rnd(t, s=1.0, dtype=torch.float32):
        fmt = torch.channels_last if t.dim() == 4 and t.is_contiguous(
            memory_format=torch.channels_last) and not t.is_contiguous() \
            else torch.contiguous_format
        return (torch.randn(t.shape, device="cuda", generator=gen)
                * s).to(dtype).contiguous(memory_format=fmt)
    params = {i: rnd(t, 0.02, pdtype) for i, t in enumerate(leaves)}
    mu = {i: rnd(t, 1e-3) for i, t in enumerate(leaves)}
    nu = {i: rnd(t, 1e-3) ** 2 for i, t in enumerate(leaves)}
    plain = [{i: t.clone() for i, t in d.items()}
             for d in (params, mu, nu)]
    ptrs = [{i: t.data_ptr() for i, t in d.items()}
            for d in (params, mu, nu)]
    before = LAUNCHES.get(fad.KERNEL_NAME)
    for count in (1, 2, 3):
        grads = {i: rnd(t, 1e-2, pdtype) for i, t in enumerate(leaves)}
        adam_sweep(params, mu, nu, grads, count)
        plain_adam_sweep(*plain, grads, count)
    torch.cuda.synchronize()
    launches = LAUNCHES.get(fad.KERNEL_NAME) - before
    in_place = all(d[i].data_ptr() == ptr[i]
                   for d, ptr in zip((params, mu, nu), ptrs)
                   for i in params)
    return (params, mu, nu, grads, plain, launches,
            adam_max_err((params, mu, nu), plain), in_place)


def sweep_exact_at(leaves, gen) -> dict:
    """The fused-Adam sweep at a training path's own leaves (`leaves`: the
    f32 masters a fit steps, in their memory formats; the leaf table, the
    chunk prefix sums and the ragged tails follow from them): 3 steps
    against the plain version, bit-exact, in place, `sweep_launches`
    launches a step. The gradients are random: what the kernel computes at
    an element does not depend on where its gradient came from."""
    *_, launches, err, in_place = adam_three_steps(leaves, torch.float32,
                                                   gen)
    want = 3 * fad.sweep_launches(leaves)
    torch.cuda.empty_cache()
    return {"leaves": len(leaves),
            "elements": sum(t.numel() for t in leaves), "steps": 3,
            "max_abs_err": err, "in_place": in_place, "launches": launches,
            "expected_launches": want,
            "ok": err == 0.0 and in_place and launches == want}


def fused_adam_row(card: str, leaves, pdtype, gen, mix: str):
    """The fused-Adam kernel over one leaf mix (`leaves`, as
    `adam_three_steps` takes them): 3 steps against the plain version
    (bit-exact, in place, one launch for every `fad.MAX_LEAVES` leaves a
    step), a 4th step at one leaf a launch (bit-equal to one launch a
    sweep), then a sweep's device and host time beside the same kernel at
    one leaf a launch, the plain version's, `AdamW(fused=True)`'s and the
    bound."""
    copies = fad.GRAD_COPIES.get(fad.KERNEL_NAME)
    (params, mu, nu, grads, plain, launches, max_abs_err,
     in_place) = adam_three_steps(leaves, pdtype, gen)
    per_sweep = fad.sweep_launches(leaves)
    # step 4 both ways from the same state: one launch a sweep, and one
    # leaf a launch (the launch pattern before the multi-tensor kernel)
    for d, p in zip(plain, (params, mu, nu)):
        for i in d:
            d[i].copy_(p[i])
    adam_sweep(params, mu, nu, grads, 4)
    one_plan = fad._launch_plan(np.array(
        [t.numel() for t in leaves if t.numel() > 0], np.int64), 1)
    leaf_by_leaf = adam_sweep_leaf_by_leaf(one_plan)
    before_one = LAUNCHES.get(fad.KERNEL_NAME)
    leaf_by_leaf(*plain, grads, 4)
    torch.cuda.synchronize()
    one_launches = LAUNCHES.get(fad.KERNEL_NAME) - before_one
    one_err = adam_max_err((params, mu, nu), plain)
    grad_copies = fad.GRAD_COPIES.get(fad.KERNEL_NAME) - copies
    del plain
    ok = (max_abs_err == 0.0 and in_place and launches == 3 * per_sweep
          and one_err == 0.0
          and one_launches == len(one_plan))

    def sweep():
        adam_sweep(params, mu, nu, grads, 5)

    def sweep_one_a_launch():
        leaf_by_leaf(params, mu, nu, grads, 5)

    # device time of a sweep (the profiler's kernel time, the median of
    # three windows; one launch a leaf adds the gaps between launches,
    # which it does not count);
    # wall_ms: CUDA events around 10 sweeps, whichever of the host and the
    # device is slower; host_ms: the host's time to issue a sweep
    kernel_ms, kernel_by = median_device_ms(sweep, 10)
    wall_ms = time_ms(sweep, 10)
    issue_ms = host_ms(sweep, 10)
    one_ms, one_by = median_device_ms(sweep_one_a_launch, 10)
    one_wall_ms = time_ms(sweep_one_a_launch, 10)
    one_issue_ms = host_ms(sweep_one_a_launch, 10)
    plain_ms, plain_by = device_ms(
        lambda: plain_adam_sweep(params, mu, nu, grads, 5), 3)
    # the library call on default-format copies (the same bytes)
    lib_leaves = [params[i].detach().clone(
        memory_format=torch.contiguous_format) for i in params]
    for t, i in zip(lib_leaves, params):
        t.grad = grads[i].contiguous()
    opt = torch.optim.AdamW(lib_leaves, lr=ADAM_HP["lr"],
                            betas=(ADAM_HP["b1"], ADAM_HP["b2"]),
                            eps=ADAM_HP["eps"],
                            weight_decay=ADAM_HP["weight_decay"], fused=True)
    library_ms, library_by = device_ms(opt.step, 10)
    del opt, lib_leaves
    flops, nbytes = fad.update_cost(params, grads)
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    bound_ms = max(t_mem, t_ops)
    row = {"phase": "fused_adam", "leaf_mix": mix,
           "param_dtype": str(pdtype)[6:], "leaves": len(leaves),
           "channels_last_leaves": sum(
               1 for p in params.values() if not p.is_contiguous()),
           "elements": sum(t.numel() for t in leaves),
           "chunks": sum(-(-t.numel() // fad.CHUNK) for t in leaves),
           "steps": 3, "max_abs_err": max_abs_err,
           "in_place": in_place, "launches": launches,
           "launches_per_sweep": per_sweep, "grad_layout_copies": grad_copies,
           "one_leaf_a_launch": {"launches": one_launches,
                                 "max_abs_err_vs_one_a_sweep": one_err,
                                 "kernel_ms_per_sweep": one_ms,
                                 "wall_ms": one_wall_ms,
                                 "host_ms": one_issue_ms, "timed_by": one_by},
           "ok": ok, "kernel_ms_per_sweep": kernel_ms, "wall_ms": wall_ms,
           "host_ms": issue_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "pct_of_bound": 100.0 * bound_ms / kernel_ms,
           "timed_by": {"kernel_ms_per_sweep": kernel_by,
                        "plain_ms": plain_by, "library_ms": library_by},
           "bound_ms": bound_ms,
           "bound_by": "bytes" if t_mem >= t_ops else "operations",
           "bytes": nbytes, "card": card}
    emit(row)
    del params, mu, nu, grads
    torch.cuda.empty_cache()
    return row


# The edge leaves of one sweep: the four (p, g) dtype pairs, counts that
# are not multiples of 4 or 8, a 0-d and an empty leaf, channels_last
# leaves, a leaf of more than one chunk; every 1-d leaf once more as a view
# one element into a larger buffer (not 16-byte aligned).
ADAM_EDGE_LEAVES = [((3, 5), "f", "f", False), ((16, 8, 3, 3), "f", "b", True),
                    ((), "f", "f", False), ((0, 4), "b", "b", False),
                    ((fad.CHUNK + 13,), "f", "b", False),
                    ((7, 3, 2, 2), "b", "b", True), ((37,), "b", "f", False),
                    ((64,), "b", "b", False), ((1001,), "f", "f", False)]


def fused_adam_edges(card: str, gen):
    """The edge leaves above in one sweep, then more leaves than a launch
    takes (`fad.MAX_LEAVES` + 9, ragged sizes): 3 steps each, bit-exact
    against the plain version, in place, the launches a sweep expected."""
    dt = {"f": torch.float32, "b": torch.bfloat16}

    def make(shape, dtype, cl, scale, offset=0, square=False):
        t = torch.randn(shape, device="cuda", generator=gen) * scale
        t = (t * t if square else t).to(dtype)
        if cl:
            t = t.contiguous(memory_format=torch.channels_last)
        if offset:
            base = torch.zeros(t.numel() + offset, dtype=dtype,
                               device="cuda")
            base[offset:] = t.reshape(-1)
            t = base[offset:]
        return t

    def case(specs):
        params, mu, nu = {}, {}, {}
        grads = [{} for _ in range(3)]
        for i, (shape, pd, gd, cl, off) in enumerate(specs):
            params[i] = make(shape, dt[pd], cl, 0.5, off)
            mu[i] = make(shape, torch.float32, cl, 1e-2, off)
            nu[i] = make(shape, torch.float32, cl, 3e-2, off, square=True)
            for g in grads:
                g[i] = make(shape, dt[gd], cl, 1.0, off)
        plain = [{i: t.clone() for i, t in d.items()}
                 for d in (params, mu, nu)]
        ptrs = [[t.data_ptr() for t in d.values()] for d in (params, mu, nu)]
        before = LAUNCHES.get(fad.KERNEL_NAME)
        for count, g in enumerate(grads, 1):
            adam_sweep(params, mu, nu, g, count)
            plain_adam_sweep(*plain, g, count)
        torch.cuda.synchronize()
        launches = LAUNCHES.get(fad.KERNEL_NAME) - before
        return {"leaves": len(specs),
                "misaligned_leaves": sum(
                    1 for i in params if any(d[i].data_ptr() % fad.ALIGN
                                             for d in (params, mu, nu))),
                "launches": launches,
                "expected_launches": 3 * fad.sweep_launches(
                    params.values()),
                "max_abs_err": adam_max_err((params, mu, nu), plain),
                "in_place": ptrs == [[t.data_ptr() for t in d.values()]
                                     for d in (params, mu, nu)]}
    edges = [s + (0,) for s in ADAM_EDGE_LEAVES] + [
        s + (1,) for s in ADAM_EDGE_LEAVES if len(s[0]) == 1]
    rs = np.random.default_rng(7)
    many = [((int(n),), "f", "f", False, 0)
            for n in rs.integers(1, 3000, fad.MAX_LEAVES + 9)]
    rows = {"edges": case(edges), "many_leaves": case(many)}
    ok = all(r["max_abs_err"] == 0.0 and r["in_place"]
             and r["launches"] == r["expected_launches"]
             for r in rows.values())
    out = {"phase": "fused_adam_edges", **rows, "ok": ok,
           "config": fad.launch_config(), "card": card}
    emit(out)
    return out


def phase_fused_adam(card: str, seed: int):
    """BERT-base's 153 leaves in f32 and bf16 (keyed by dtype), and
    ResNet-50's 161 (4-d conv kernels channels_last, 1-d BatchNorm
    vectors, the dense head) in f32, the masters a mixed-precision fit
    steps (key "resnet50"); the edge cases (key "edges")."""
    bert = list(BERTClassifier(NUM_CLASSES, device="cuda",
                               **BERT_BASE).parameters())
    resnet50 = list(resnet(50, IMG_CLASSES, IMG_SHAPE).parameters())
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    results = {"edges": fused_adam_edges(card, gen)}
    for pdtype in (torch.float32, torch.bfloat16):
        results[pdtype] = fused_adam_row(card, bert, pdtype, gen,
                                         "bert_base")
    results["resnet50"] = fused_adam_row(card, resnet50, torch.float32, gen,
                                         "resnet50")
    del bert, resnet50
    torch.cuda.empty_cache()
    if not all(r["ok"] for r in results.values()):
        raise SystemExit("chip_smoke: fused Adam check failed")
    return results


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
TRAIN_BATCH = 32
TRAIN_STEPS = 8
# graphed (the default) and eager fits in turns within one call
TRAIN_LEGS = ("eager", "graph", "eager", "graph")
PEAK_BF16 = PEAK_FLOPS[torch.bfloat16]
# f32, dropout 0, 3 steps: the kernel path (flash kernels, fused Adam)
# against the plain path (plain attention, plain AdamW), same weights and
# batches. Losses: f32 rounding through 12 blocks in two attention
# algorithms, ~1e-6 relative per op — 1e-4 absolute. Parameters: Adam's
# m/√v turns rounding noise in a gradient that is near zero (the key bias,
# whose true gradient is zero) into a step of up to ~lr, so a parameter may
# differ by up to lr per step (2·lr·steps bound), but at most 1e-3 of the
# elements may differ by more than 1e-6, and the update (final − initial)
# agrees to 1e-2 in relative L2.
F32_LOSS_TOL = 1e-4
F32_PARAM_MAX = 2 * ADAM_HP["lr"] * 3
F32_PARAM_FRAC = 1e-3
F32_UPDATE_REL = 1e-2
# bf16 (mixed precision), dropout 0, 3 steps: the kernel path (the
# tensor-core flash kernels, fused Adam) against the plain path (plain
# attention, plain AdamW). Both round every weight and activation to bf16
# (2^-9 relative) and differ only in where attention rounds: the kernels
# round P and dS after f32 softmax statistics, the plain path rounds the
# scores and the weights. The serving check holds bf16 logits within
# LOGIT_TOL (5e-2) of f32 on logits of scale ~0.3; the mean cross-entropy
# over 2 classes moves by at most the mean change of the logit gap, and
# rounding of independent sequences partly cancels in the batch mean —
# 2e-2 absolute on each of the 3 losses.
BF16_LOSS_TOL = 2e-2


def make_training_data(rs, n: int, cfg):
    """`{"x": [ids, mask], "y": labels}` as `bench.py:75-77` builds it,
    with real lengths drawn from 32-512 (the mask pads the rest)."""
    ids, mask = make_request(rs, n, cfg)
    return {"x": [ids.astype(np.int32), mask.astype(np.float32)],
            "y": rs.integers(0, NUM_CLASSES, n).astype(np.int32)}


def train_flops_per_step(model, cfg, batch: int, seq: int = 0) -> float:
    """`bench.py:101-111`: 6 FLOPs per matmul parameter per token plus the
    attention scores and context, 12·L·T²·D per sequence (fwd + bwd), at
    sequence length `seq` (default: the position table's)."""
    T = seq or cfg["seq_len"]
    n_params = sum(p.numel() for p in model.parameters())
    n_emb = (cfg["vocab"] + cfg["seq_len"] + 2) * cfg["hidden_size"]
    tokens = batch * T
    return (6.0 * (n_params - n_emb) * tokens + 12.0 * cfg["n_block"]
            * T ** 2 * cfg["hidden_size"] * batch)


def new_model(state, **kw):
    model = BERTClassifier(NUM_CLASSES, use_flash=kw.pop("use_flash", True),
                           device="cuda", **BERT_BASE, **kw)
    model.load_state_dict(state)
    return model


def _profiled_rows(fn, reps: int):
    """(kernel, device ms a call, calls a call) of every device row the
    profiler records over `reps` calls of `fn`, after one untraced call
    (the schedule's warm-up step); the schedule's step ranges
    ("ProfilerStep#N") are device rows too, not kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for n in (1, reps):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


def profile_fit(est, data, fit_kw, steps: int, step_ms: float):
    """Device time per step by kernel over a fit of `steps` steps, after
    an untraced fit of the same data; the idle share compares it with the
    unprofiled step time."""
    rows = [(name, ms / steps, calls / steps) for name, ms, calls in
            _profiled_rows(lambda: est.fit(data, **fit_kw), 1)]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"phase": "train_profile", "device_ms_per_step": device_ms,
            "device_ops_per_step": sum(r[2] for r in rows),
            "step_ms": step_ms,
            "idle_share": (1.0 - device_ms / step_ms) if device_ms else None,
            "top": [{"kernel": name[:96], "ms": ms, "share": ms / device_ms,
                     "calls": calls} for name, ms, calls in rows[:16]]}


def train_leg(state, leg: str, data, fit_kw, make_opt, loss):
    """One leg of the graphed-against-eager check: a fresh BERT-base from
    `state`, a fit whose losses and final parameters the check compares,
    then a fit timed on the host clock ending in a synchronize, every count
    0 just before and read just after (for the graphed leg: replays only).
    The eager leg runs every program eagerly (`eager_programs`)."""
    model = new_model(state)
    est = Estimator.from_keras(model, optimizer=make_opt(), loss=loss)
    ctx = cgraphs.eager_programs() if leg == "eager" \
        else contextlib.nullcontext()
    with ctx:
        hist = est.fit(data, **fit_kw)
        torch.cuda.synchronize()
        params = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
        LAUNCHES.reset()
        t0 = time.perf_counter()
        est.fit(data, **fit_kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = LAUNCHES.snapshot()
    return {"loss": hist["loss"], "params": params, "dt": dt,
            "counts": counts, "est": est}


def leg_profile(leg, est, data, fit_kw, steps: int, step_ms: float):
    """`profile_fit` of one more fit of `est`, run as its leg runs."""
    ctx = cgraphs.eager_programs() if leg == "eager" \
        else contextlib.nullcontext()
    with ctx:
        return profile_fit(est, data, fit_kw, steps, step_ms)


def seed_not_frozen(card: str, seed: int) -> dict:
    """One CUDA graph of a dropout pass and an attention forward with
    dropout, both reading a `DeviceSeed` (a site path under a step seed in
    device memory), replayed under two step seeds: the masks must differ
    between the seeds and each must equal its plain version's for that
    seed (the dropout pass bitwise; the attention's keep-scale matrix, as
    the mask-export kernel writes it for the int site seed, bitwise the
    plain `attention_keep_scale` of the device seed, and the output within
    ATTN_TOL of the plain attention with that matrix)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 58)
    x = torch.randn(DROPOUT_SHAPE, device="cuda", generator=gen)
    q, k, v = (torch.randn(MAIN_SHAPE, device="cuda", generator=gen,
                           dtype=torch.bfloat16) for _ in range(3))
    base = torch.zeros(1, dtype=torch.int64, device="cuda")
    path = (2, 0, 1)
    dev_seed = DeviceSeed(base, path)
    rate = DROPOUT_RATE
    dr.dropout_apply(x, rate, dev_seed)          # loaded before the capture
    fa.flash_attention_fwd(q, k, v, None, ATTN_DROP_RATE, dev_seed)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out_d = dr.dropout_apply(x, rate, dev_seed)
        out_a = fa.flash_attention_fwd(q, k, v, None, ATTN_DROP_RATE,
                                       dev_seed)[0]
    rows, masks, ok = [], [], True
    for step_seed in (seed * 7919 + 11, seed * 7919 + 12):
        base.fill_(step_seed)
        graph.replay()
        torch.cuda.synchronize()
        site = step_seed
        for i in path:
            site = site_seed(site, i)
        keep = dr.dropout_keep(x.shape, site, rate, x.device)
        want_d = dr._reference_dropout(x, rate, keep)
        B, H, T, _ = q.shape
        ks_kernel = fa.keep_scale_matrix(q.shape, ATTN_DROP_RATE, site,
                                         "cuda")
        ks_plain = attention_keep_scale(
            B * H, T, dev_seed, dr._byte_threshold(ATTN_DROP_RATE),
            "cuda").view(B, H, T, T)
        want_a = fa._reference_attention(q, k, v, None, ks_plain)
        err_a = (out_a.float() - want_a.float()).abs().max().item()
        row = {"step_seed": step_seed, "site_seed": site,
               "dropout_bitwise_plain": bool(torch.equal(out_d, want_d)),
               "attn_keep_scale_bitwise_plain":
                   bool(torch.equal(ks_kernel, ks_plain)),
               "attn_max_abs_err": err_a,
               "attn_tol": ATTN_TOL[torch.bfloat16]["o"]}
        ok &= (row["dropout_bitwise_plain"]
               and row["attn_keep_scale_bitwise_plain"]
               and err_a <= row["attn_tol"])
        rows.append(row)
        masks.append(((out_d == 0).clone(), ks_kernel.clone()))
    differ = {"dropout": not torch.equal(masks[0][0], masks[1][0]),
              "attention": not torch.equal(masks[0][1], masks[1][1])}
    ok &= all(differ.values())
    out = {"phase": "train_seed_not_frozen", "path": list(path),
           "replays": rows, "masks_differ": differ, "ok": ok, "card": card}
    emit(out)
    return out


def phase_training(card: str, seed: int):
    cfg = BERT_BASE
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.default_rng(seed + 50)
    state = convert.params_from_jax(
        random_classifier_tree(cfg, NUM_CLASSES, seed))
    loss = objectives.get("sparse_categorical_crossentropy", from_logits=True)
    hp = ADAM_HP

    def fused():
        return optimizers.fused_adam(learning_rate=hp["lr"], b1=hp["b1"],
                                     b2=hp["b2"], eps=hp["eps"],
                                     weight_decay=hp["weight_decay"])

    probe = new_model(state)
    n_leaves = len(list(probe.parameters()))
    sweep = fad.sweep_launches(probe.parameters())
    flops_step = train_flops_per_step(probe, cfg, TRAIN_BATCH)
    del probe
    fit_kw = dict(epochs=1, batch_size=TRAIN_BATCH, mixed_precision=True,
                  fused_optimizer=True)
    data = make_training_data(rs, TRAIN_BATCH * TRAIN_STEPS, cfg)
    expected = {fa.KERNEL_NAME: cfg["n_block"],
                fa.BWD_DKV_NAME: cfg["n_block"],
                fa.BWD_DQ_NAME: cfg["n_block"],
                dr.KERNEL_NAME: 2 * (2 * cfg["n_block"] + 2),
                fad.KERNEL_NAME: sweep}

    # -- graphed and eager fits in turns; the first graphed leg's timed fit
    # is the main path: every count is 0 just before, read just after -----
    # deterministic algorithms: the token-type embedding's backward (one id
    # for every token) sums with atomics otherwise, and two eager fits then
    # differ in its last bits
    legs = {"eager": [], "graph": []}
    counts = None
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for leg in TRAIN_LEGS:
            if leg == "graph" and counts is None:
                torch.cuda.reset_peak_memory_stats()
            run = train_leg(state, leg, data, fit_kw, fused, loss)
            if leg == "graph" and counts is None:
                counts = run["counts"]
                peak = torch.cuda.max_memory_allocated()
            legs[leg].append(run)
            if len(legs[leg]) > 1:
                del run["est"]
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(deterministic)
    # -------------------------------------------------------------------------
    leg_ms = {leg: [r["dt"] / TRAIN_STEPS * 1e3 for r in runs]
              for leg, runs in legs.items()}
    step_ms = leg_ms["graph"][0]
    dt = step_ms * TRAIN_STEPS / 1e3
    tokens = TRAIN_BATCH * cfg["seq_len"] * TRAIN_STEPS
    per_step = {leg: {k: runs[0]["counts"].get(k, 0) / TRAIN_STEPS
                      for k in expected} for leg, runs in legs.items()}

    def same(a, b):
        return a["loss"] == b["loss"] and all(
            torch.equal(a["params"][k], b["params"][k]) for k in a["params"])

    e0, e1 = legs["eager"]
    g0, g1 = legs["graph"]
    bitwise = {"eager_vs_eager": same(e0, e1), "graph_vs_eager": same(g0, e0),
               "graph_vs_graph": same(g0, g1)}
    emit({"phase": "train", "seq_len": cfg["seq_len"],
          "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "legs": TRAIN_LEGS,
          "deterministic_algorithms": True,
          "step_ms": step_ms, "step_ms_by_leg": leg_ms,
          "tokens_per_s": tokens / dt, "flops_per_step": flops_step,
          "mfu": flops_step * TRAIN_STEPS / dt / PEAK_BF16,
          "max_memory_allocated_gb": peak / 1e9, "loss": g0["loss"],
          "launches": counts, "launches_per_step": per_step,
          "expected_per_step": expected, "bitwise": bitwise,
          "leaves": n_leaves, "card": card})
    want = {k: float(v) for k, v in expected.items()}
    if per_step["graph"] != want or per_step["eager"] != want:
        raise SystemExit(f"chip_smoke: launches per step {per_step}, "
                         f"expected {expected}")
    if not all(math.isfinite(x) for x in g0["loss"]):
        raise SystemExit("chip_smoke: non-finite training loss")
    if not all(bitwise.values()):
        raise SystemExit(f"chip_smoke: graphed training not bitwise the "
                         f"eager fit: {bitwise}")
    for leg in ("eager", "graph"):
        emit(dict(leg_profile(leg, legs[leg][0]["est"], data, fit_kw,
                              TRAIN_STEPS, leg_ms[leg][0]),
                  leg=leg, card=card))
    del legs, e0, e1, g0, g1
    gc.collect()
    torch.cuda.empty_cache()
    frozen = seed_not_frozen(card, seed)
    # the batches an earlier profiled fit drew here: the checks below keep
    # the batch they have always run on
    make_training_data(rs, 2 * TRAIN_BATCH, cfg)

    # -- f32, dropout 0: the kernel path against the plain path ------------
    no_drop = dict(hidden_drop=0.0, attn_drop=0.0, dropout=0.0)
    batch = make_training_data(rs, TRAIN_BATCH, cfg)
    plain_adamw = optimizers.adamw(hp["lr"], b1=hp["b1"], b2=hp["b2"],
                                   eps=hp["eps"],
                                   weight_decay=hp["weight_decay"])
    runs = {}
    for name, use_flash, opt in (("kernel", True, fused()),
                                 ("plain", False, plain_adamw)):
        m = new_model(state, use_flash=use_flash, **no_drop)
        LAUNCHES.reset()
        h = Estimator.from_keras(m, optimizer=opt, loss=loss).fit(
            batch, epochs=3, batch_size=TRAIN_BATCH, mixed_precision=False,
            fused_optimizer=name == "kernel")
        runs[name] = (h["loss"], {k: v.detach().clone()
                                  for k, v in m.state_dict().items()},
                      LAUNCHES.snapshot())
        del m
        torch.cuda.empty_cache()
    (lk, pk, ck), (lp, pp, cp) = runs["kernel"], runs["plain"]
    loss_err = max(abs(a - b) for a, b in zip(lk, lp))
    diffs = [(pk[k] - pp[k]).abs() for k in pk]
    total = sum(d.numel() for d in diffs)
    param_max = max(d.max().item() for d in diffs)
    frac_over = sum(int((d > 1e-6).sum()) for d in diffs) / total
    upd_num = math.sqrt(sum(float(((pk[k] - pp[k]).double() ** 2).sum())
                            for k in pk))
    upd_den = math.sqrt(sum(float(((pp[k].cpu() - state[k]).double() ** 2)
                                  .sum()) for k in pp))
    update_rel = upd_num / upd_den
    f32_ok = (loss_err <= F32_LOSS_TOL and param_max <= F32_PARAM_MAX
              and frac_over <= F32_PARAM_FRAC
              and update_rel <= F32_UPDATE_REL
              and ck.get(fa.BWD_DQ_NAME, 0) == 3 * cfg["n_block"]
              and cp.get(fa.KERNEL_NAME, 0) == 0)
    emit({"phase": "train_f32_kernel_vs_plain", "steps": 3,
          "loss_kernel": lk, "loss_plain": lp, "loss_max_abs_err": loss_err,
          "loss_tol": F32_LOSS_TOL, "param_max_abs_err": param_max,
          "param_tol": F32_PARAM_MAX, "param_frac_over_1e-6": frac_over,
          "param_frac_tol": F32_PARAM_FRAC, "update_rel_l2_err": update_rel,
          "update_tol": F32_UPDATE_REL, "launches_kernel_path": ck,
          "launches_plain_path": cp, "ok": f32_ok, "card": card})
    del runs, pk, pp, diffs
    torch.cuda.empty_cache()

    # -- bf16, dropout 0: the kernel path against the plain path -----------
    runs = {}
    for name, use_flash, opt in (
            ("kernel", True, fused()),
            ("plain", False, optimizers.adamw(
                hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                weight_decay=hp["weight_decay"]))):
        m = new_model(state, use_flash=use_flash, **no_drop)
        LAUNCHES.reset()
        h = Estimator.from_keras(m, optimizer=opt, loss=loss).fit(
            batch, epochs=3, batch_size=TRAIN_BATCH, mixed_precision=True,
            fused_optimizer=name == "kernel")
        runs[name] = (h["loss"], LAUNCHES.snapshot())
        del m
        torch.cuda.empty_cache()
    (bk, ck16), (bp, cp16) = runs["kernel"], runs["plain"]
    bf16_err = max(abs(a - b) for a, b in zip(bk, bp))
    want = {name: 3 * cfg["n_block"]
            for name in (fa.KERNEL_NAME, fa.BWD_DKV_NAME, fa.BWD_DQ_NAME)}
    bf16_path_ok = (bf16_err <= BF16_LOSS_TOL
                    and all(math.isfinite(x) for x in bk + bp)
                    and {n: ck16.get(n, 0) for n in want} == want
                    and not any(cp16.get(n, 0) for n in want))
    emit({"phase": "train_bf16_kernel_vs_plain", "steps": 3,
          "loss_kernel": bk, "loss_plain": bp, "loss_max_abs_err": bf16_err,
          "loss_tol": BF16_LOSS_TOL,
          "kernel_vs_f32_plain": max(abs(a - b) for a, b in zip(bk, lp)),
          "plain_vs_f32_plain": max(abs(a - b) for a, b in zip(bp, lp)),
          "launches_kernel_path": ck16, "launches_plain_path": cp16,
          "ok": bf16_path_ok, "card": card})

    # -- bf16, dropout 0.1: the loss falls on one repeated batch -----------
    m = new_model(state)
    h = Estimator.from_keras(m, optimizer=fused(), loss=loss).fit(
        batch, epochs=20, batch_size=TRAIN_BATCH, mixed_precision=True,
        fused_optimizer=True)
    losses = h["loss"]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    bf16_ok = all(math.isfinite(x) for x in losses) and last5 < first5
    emit({"phase": "train_bf16_loss_falls", "steps": 20, "losses": losses,
          "first5_mean": first5, "last5_mean": last5, "ok": bf16_ok,
          "card": card})
    del m
    torch.cuda.empty_cache()
    if not (f32_ok and bf16_path_ok and bf16_ok and frozen["ok"]):
        raise SystemExit("chip_smoke: training check failed")
    return counts


# ---------------------------------------------------------------------------
# segment Adam
# ---------------------------------------------------------------------------
SEG_BATCH = 8192
SEG_DIM = 64
SEG_HP = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)    # "adam"'s defaults
# (name, table rows, ids drawn from, table dtype): NeuralCF's user table
# with uniform ids (~3% duplicates in a batch), its item table (~14%), the
# user table with every id from 512 values, and the user table in bf16.
SEG_CASES = [("uniform_users", 138_001, 138_000, torch.float32),
             ("uniform_items", 27_001, 27_000, torch.float32),
             ("heavy_duplicates", 138_001, 512, torch.float32),
             ("uniform_users_bf16", 138_001, 138_000, torch.bfloat16)]
SEG_MAIN = "uniform_users"
# segment sum on the card against the CPU's plain version: the same adds in
# the same order, so equal in practice; 1e-6 of the largest sum allows for
# a different rounding of the CPU's vectorised add.
SEG_SUM_TOL = 1e-6


def segment_bound(n_slots: int, n_valid: int, dim: int, dtype):
    """(ms, "bytes" | "operations") of one row-Adam launch over this batch:
    the valid flags of every slot, and the uid, gradient row and p, m, v of
    each valid slot read once and p, m, v written once; ~12 flops an
    element."""
    flops, row_bytes = seg.segment_adam_cost(n_valid, dim, dtype)
    nbytes = 4.0 * n_slots + 4.0 * n_valid + row_bytes
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def segment_sum_bound(n: int, dim: int):
    """The segment sum: n gradient rows and the sorted ids, order and slots
    read once, the [n, dim] slots written once; one add an element."""
    nbytes = 8.0 * n * dim + 12.0 * n
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = n * dim / PEAK_FLOPS[torch.float32] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def sparse_adam_ms(table, batches, reps: int):
    """`torch.optim.SparseAdam` stepping the same rows with a coalesced
    sparse gradient, as `device_ms` times it: a yardstick of time only (it
    adds eps without the √(1-β2^t) factor the port's Adam folds in)."""
    param = torch.nn.Parameter(table.detach().float().clone())
    grads = [torch.sparse_coo_tensor(u[v.bool()].long()[None], g[v.bool()],
                                     param.shape).coalesce()
             for u, v, g in batches]
    opt = torch.optim.SparseAdam([param], lr=SEG_HP["lr"],
                                 betas=(SEG_HP["b1"], SEG_HP["b2"]),
                                 eps=SEG_HP["eps"])
    it = itertools.cycle(grads)

    def step():
        param.grad = next(it)
        opt.step()
    timed = device_ms(step, reps)
    del opt, param, grads
    return timed


def cycling(fn, batches):
    """A call of `fn` on the next of `batches` each time: the timed
    launches touch other rows than the last ones (16 batches touch ~100 MB
    of rows, twice the L2 cache), as a training step finds them."""
    it = itertools.cycle(batches)
    return lambda: fn(*next(it))


def phase_segment_adam(card: str, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed + 70)
    rs = np.random.default_rng(seed + 71)
    hp = SEG_HP
    B, dim = SEG_BATCH, SEG_DIM
    results = {}
    for name, rows, id_range, dtype in SEG_CASES:
        table = (torch.randn((rows, dim), device="cuda", generator=gen)
                 * 0.05).to(dtype)
        mu = torch.randn((rows, dim), device="cuda", generator=gen) * 1e-3
        nu = (torch.randn((rows, dim), device="cuda", generator=gen)
              * 1e-3) ** 2
        plain = [t.clone() for t in (table, mu, nu)]
        untouched_same = deterministic = ids_exact = True
        max_abs_err, sum_err, dup_frac = 0.0, 0.0, []
        before = LAUNCHES.snapshot()
        for count in (1, 2, 3):
            ids = torch.from_numpy(rs.integers(1, id_range + 1, B)).cuda()
            d_rows = torch.randn((B, dim), device="cuda", generator=gen) * 1e-2
            start = [t.clone() for t in (table, mu, nu)]
            uids, valid, g_slots = seg.segment_compact(ids, d_rows)
            again = seg.segment_compact(ids, d_rows)
            deterministic &= all(torch.equal(a, b) for a, b in
                                 zip((uids, valid, g_slots), again))
            cu, cv, cg = seg.segment_compact(ids.cpu(), d_rows.cpu())
            ids_exact &= (torch.equal(uids.cpu(), cu)
                          and torch.equal(valid.cpu(), cv))
            sum_err = max(sum_err, (g_slots.cpu() - cg).abs().max().item()
                          / cg.abs().max().item())
            scal = fad._fold_scalars(count, hp["lr"], hp["b1"], hp["b2"],
                                     hp["eps"], 0.0)
            seg.kernel_apply(table, mu, nu, uids, valid, g_slots, scal,
                             b1=hp["b1"], b2=hp["b2"])
            seg._reference_kernel_apply(*plain, uids, valid, g_slots, scal,
                                        hp["b1"], hp["b2"])
            torch.cuda.synchronize()
            max_abs_err = max([max_abs_err] + [
                (a.float() - b.float()).abs().max().item()
                for a, b in zip((table, mu, nu), plain)])
            touched = torch.zeros(rows, dtype=torch.bool, device="cuda")
            touched[uids[valid.bool()].long()] = True
            untouched_same &= all(torch.equal(a[~touched], b[~touched])
                                  for a, b in zip((table, mu, nu), start))
            changed = bool((table[touched] != start[0][touched]).any())
            untouched_same &= changed
            dup_frac.append(1.0 - int(valid.sum()) / B)
            del start
        launches = {k: v - before.get(k, 0)
                    for k, v in LAUNCHES.snapshot().items()
                    if v != before.get(k, 0)}
        # timing: 16 fresh batches in turn, so the rows start cold in L2
        batches = [seg.segment_compact(
            torch.from_numpy(rs.integers(1, id_range + 1, B)).cuda(),
            torch.randn((B, dim), device="cuda", generator=gen) * 1e-2)
            for _ in range(16)]
        n_valid = float(np.mean([int(v.sum()) for _, v, _ in batches]))

        # the scalars on the card, as a training step passes them (host
        # floats would add a copy a call)
        scal_dev = fad.folded_on(scal, "cuda")

        def kernel(u, v, g):
            seg.kernel_apply(table, mu, nu, u, v, g, scal_dev, b1=hp["b1"],
                             b2=hp["b2"])

        def plain_fn(u, v, g):
            seg._reference_kernel_apply(table, mu, nu, u, v, g, scal,
                                        hp["b1"], hp["b2"])
        kernel_ms, kernel_by = device_ms(cycling(kernel, batches), 48)
        wall_ms = time_ms(cycling(kernel, batches), 48)
        plain_ms, plain_by = device_ms(cycling(plain_fn, batches), 16)
        library_ms, library_by = sparse_adam_ms(table, batches, 16)
        bound_ms, bound_by = segment_bound(B, n_valid, dim, dtype)
        sids, order, _, slot = seg.sort_ids(ids)
        sum_ms, sum_by = device_ms(lambda: seg.segment_sum(
            d_rows, sids, order, slot), 50)
        sum_plain_ms, sum_plain_by = device_ms(
            lambda: seg._reference_segment_sum(d_rows, order, slot), 50)
        gathered = d_rows.index_select(0, order.long())
        sum_library_ms, sum_library_by = device_ms(lambda: torch.zeros_like(
            d_rows).index_add_(0, slot, gathered), 50)
        sum_bound = segment_sum_bound(B, dim)
        ok = (max_abs_err == 0.0 and untouched_same and deterministic
              and ids_exact
              and sum_err <= SEG_SUM_TOL
              and launches == {seg.KERNEL_NAME: 3, seg.SUM_NAME: 6})
        row = {"phase": "segment_adam", "case": name, "table": [rows, dim],
               "dtype": str(dtype)[6:], "batch": B, "id_range": id_range,
               "steps": 3, "duplicate_fraction": dup_frac,
               "n_valid_mean_timed": n_valid,
               "max_abs_err_vs_plain": max_abs_err,
               "untouched_rows_unchanged": untouched_same,
               "segment_sum_deterministic": deterministic,
               "uids_valid_equal_cpu": ids_exact,
               "segment_sum_rel_err_vs_cpu": sum_err,
               "segment_sum_tol": SEG_SUM_TOL, "launches": launches,
               "ok": ok, "kernel_ms": kernel_ms, "wall_ms": wall_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "sum_kernel_ms": sum_ms, "sum_plain_ms": sum_plain_ms,
               "sum_library_ms": sum_library_ms, "sum_bound_ms": sum_bound[0],
               "sum_bound_by": sum_bound[1],
               "timed_by": {"kernel_ms": kernel_by, "plain_ms": plain_by,
                            "library_ms": library_by, "sum_kernel_ms": sum_by,
                            "sum_plain_ms": sum_plain_by,
                            "sum_library_ms": sum_library_by},
               "card": card}
        emit(row)
        results[name] = row
        del table, mu, nu, plain, gathered, batches
        torch.cuda.empty_cache()
    if not all(r["ok"] for r in results.values()):
        raise SystemExit("chip_smoke: segment Adam check failed")
    return results


# ---------------------------------------------------------------------------
# NeuralCF
# ---------------------------------------------------------------------------
# `bench_ncf.py:58-66` at MovieLens-20M scale; 64 steps of 8192 samples
# (bench_ncf.py draws 4M samples; 524,288 keep the run short).
NCF_CFG = dict(user_count=138_000, item_count=27_000, class_num=2,
               user_embed=64, item_embed=64, mf_embed=64,
               hidden_layers=(128, 64, 32))
NCF_BATCH = 8192
NCF_SAMPLES = 1 << 22         # bench_ncf.py:58-61: 512 steps an epoch
NCF_STEPS = NCF_SAMPLES // NCF_BATCH
NCF_SPR = 64                  # steps a run (bench_ncf.py's BENCH_SPR)
NCF_CHILD_SAMPLES = 2 * NCF_SPR * NCF_BATCH   # two runs of the program
NCF_CHILD_S = 300.0
NCF_LR = SEG_HP["lr"]
# f32, 3 steps, the kernel path against the plain path
# (`make_lazy_one_step`: dense gradients, `row_adam_update`, plain Adam):
# the same forward, so losses agree to rounding (1e-5); the two Adams
# round differently (folded scalars against bias-corrected moments) and
# the segment sum adds in another order than the embedding backward, so a
# parameter may move apart by up to lr a step where m/√v amplifies
# rounding (2·lr·steps), but at most 1e-3 of the dense parameters and
# touched rows beyond 1e-6.
NCF_LOSS_TOL = 1e-5
NCF_PARAM_MAX = 2 * NCF_LR * 3
NCF_PARAM_FRAC = 1e-3


def ncf_data(rs, n: int, users: int, items: int, rule: bool = False):
    """(x, y): ids uniform in [1, users) and [1, items), labels in {0, 1}
    as `bench_ncf.py:70-73` draws them; with `rule`, labels from
    `examples/recommendation_ncf.py`'s (u·7 + i·3) % 5."""
    x = np.stack([rs.integers(1, users, n), rs.integers(1, items, n)],
                 axis=1).astype(np.int32)
    if rule:
        y = ((x[:, 0].astype(np.int64) * 7 + x[:, 1] * 3) % 5)
    else:
        y = rs.integers(0, 2, n)
    return x, y.astype(np.int32)


def new_ncf(state=None, **kw):
    """A NeuralCF on the card; `state` (another instance's state dict) is
    loaded by position, since auto-named layers (`dense_5`) differ between
    instances."""
    ncf = NeuralCF(**dict(NCF_CFG, **kw))
    if state is not None:
        keys = list(ncf.model.state_dict())
        ncf.model.load_state_dict(dict(zip(keys, state.values())))
    return ncf


def timed_ncf_fit(est, data, fit_kw, steps: int):
    """Warm fit, then a fit timed on the host clock ending in a
    synchronize, with every launch count 0 just before and read just
    after. Returns (history, step_ms, launch counts, peak bytes)."""
    est.fit(data, **fit_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    hist = est.fit(data, **fit_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    return hist, dt / steps * 1e3, counts, torch.cuda.max_memory_allocated()


def table_rows_touched(x: np.ndarray, spec_col: int, rows: int):
    touched = torch.zeros(rows, dtype=torch.bool)
    touched[torch.from_numpy(x[:, spec_col]).long()] = True
    return touched


def ncf_cache_fit(cfg, n: int, batch: int, spr: int, cache: str) -> dict:
    """NeuralCF (`cfg`, `n` samples from seed 0, `spr` steps a run)
    fitted against `compile_cache_dir=cache`: its kernel builds and where
    each training program came from."""
    from analytics_zoo_tpu_torch.learn import trainer
    ncf = NeuralCF(**cfg)
    rs = np.random.default_rng(0)
    x = np.stack([rs.integers(1, cfg["user_count"], n),
                  rs.integers(1, cfg["item_count"], n)],
                 axis=1).astype(np.int32)
    y = rs.integers(0, 2, n).astype(np.int32)
    est = Estimator.from_keras(ncf.model, optimizer="adam",
                               loss="sparse_categorical_crossentropy")
    h = est.fit((x, y), epochs=1, batch_size=batch, steps_per_run=spr,
                lazy_embeddings=True, fused_optimizer=True,
                compile_cache_dir=cache)
    return {"build_events": _build.build_events(),
            "programs": trainer.program_sources(ncf.model),
            "loss": h["loss"]}


# a child process's `ncf_cache_fit`
NCF_CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[2])
import chip_smoke
print(json.dumps(chip_smoke.ncf_cache_fit(*json.loads(sys.argv[1]))))
'''


def ncf_warm_restart(card: str) -> dict:
    """`ncf_cache_fit` (the phase's widths, 128 steps, the 64-step
    device-cached program) into an empty `compile_cache_dir`, first in
    this process, whose kernels are built (every program "compiled"; the
    layer names counted afresh, as a new process counts them, since a
    capture record's key holds the state dict's names), then in a child
    process with an empty kernel build directory of its own, which must
    run nvcc 0 times, report every program "cached" and give the same
    loss."""
    root = tempfile.mkdtemp(prefix="azt_ncf_cc_")
    here = os.path.dirname(os.path.abspath(__file__))
    args = [NCF_CFG, NCF_CHILD_SAMPLES, NCF_BATCH, NCF_SPR,
            os.path.join(root, "cache")]
    try:
        counters = dict(kengine._name_counters)
        kengine._name_counters.clear()
        t0 = time.perf_counter()
        try:
            cold = ncf_cache_fit(*args)
        finally:
            kengine._name_counters.clear()
            kengine._name_counters.update(counters)
        cold.update(leg="in_process", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", NCF_CHILD, json.dumps(args), here],
            env=build_dir_env(root, "warm"), cwd=here, text=True,
            capture_output=True, timeout=NCF_CHILD_S)
        if proc.returncode != 0:
            raise SystemExit(f"chip_smoke: NCF warm child failed:\n"
                             f"{proc.stderr[-4000:]}")
        warm = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                    leg="child", seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = (warm["build_events"]["compiles"] == 0
          and bool(warm["programs"]) and bool(cold["programs"])
          and all(p["source"] == "cached" for p in warm["programs"])
          and all(p["source"] == "compiled" for p in cold["programs"])
          and cold["loss"] == warm["loss"])
    out = {"phase": "ncf_warm_restart", "children": [cold, warm], "ok": ok,
           "card": card}
    emit(out)
    return out


def phase_ncf(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.default_rng(seed + 60)
    users, items = NCF_CFG["user_count"], NCF_CFG["item_count"]
    n = NCF_SAMPLES
    data = ncf_data(rs, n, users, items)
    ncf = new_ncf()
    ncf.model.ensure_built(seed=seed)
    init = {k: v.detach().clone() for k, v in ncf.model.state_dict().items()}
    n_dense = sum(1 for k in init if not k.endswith("embeddings"))
    fit_kw = dict(epochs=1, batch_size=NCF_BATCH, steps_per_run=NCF_SPR,
                  lazy_embeddings=True, fused_optimizer=True)
    est = Estimator.from_keras(ncf.model, optimizer="adam",
                               loss="sparse_categorical_crossentropy")
    # -- the main path: every count is 0 just before, read just after -----
    hist, step_ms, counts, peak = timed_ncf_fit(est, data, fit_kw,
                                                NCF_STEPS)
    # -------------------------------------------------------------------------
    # the 8 dense leaves in one fused-Adam launch a step
    expected = {seg.KERNEL_NAME: 4, seg.SUM_NAME: 4,
                fad.KERNEL_NAME: -(-n_dense // fad.MAX_LEAVES)}
    per_step = {k: v / NCF_STEPS for k, v in counts.items()}
    resident = sum(t.numel() * t.element_size() for t in tree_leaves(
        ncf.model.__dict__["_device_data"][1:3]) if t is not None)
    emit({"phase": "ncf_train", "leg": "lazy_fused", "config": NCF_CFG,
          "batch": NCF_BATCH, "steps": NCF_STEPS, "samples": n,
          "steps_per_run": NCF_SPR, "device_resident_bytes": resident,
          "step_ms": step_ms,
          "ncf_train_samples_per_sec_via_estimator_fit":
              NCF_BATCH / step_ms * 1e3,
          "max_memory_allocated_gb": peak / 1e9, "loss": hist["loss"],
          "launches": counts, "launches_per_step": per_step,
          "expected_per_step": expected, "card": card})
    if per_step != {k: float(v) for k, v in expected.items()}:
        raise SystemExit(f"chip_smoke: NCF launches per step {per_step}, "
                         f"expected {expected}")
    if not all(math.isfinite(v) for v in hist["loss"]):
        raise SystemExit("chip_smoke: non-finite NCF loss")
    emit(dict(profile_fit(est, data, fit_kw, NCF_STEPS, step_ms),
              leg="lazy_fused", card=card))
    del est, ncf
    gc.collect()
    torch.cuda.empty_cache()

    # -- the device-cached 64-step graph against the host-batched eager
    # fit: one epoch of 128 steps (an eager run and a replay) from the same
    # weights and seed -------------------------------------------------------
    legs = {}
    sub = tuple(a[:NCF_CHILD_SAMPLES] for a in data)   # two runs of 64
    for leg in ("graph", "eager"):
        m = new_ncf(init)
        est = Estimator.from_keras(m.model, optimizer="adam",
                                   loss="sparse_categorical_crossentropy")
        kw = dict(fit_kw) if leg == "graph" else dict(fit_kw,
                                                      device_cache=False)
        ctx = cgraphs.eager_programs() if leg == "eager" \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            h = est.fit(sub, **kw)
        torch.cuda.synchronize()
        legs[leg] = (h["loss"], {k: v.detach().clone() for k, v in zip(
            init, m.model.state_dict().values())},
            time.perf_counter() - t0)
        del est, m
        gc.collect()
    dc_bitwise = legs["graph"][0] == legs["eager"][0] and all(
        torch.equal(legs["graph"][1][k], legs["eager"][1][k]) for k in init)
    emit({"phase": "ncf_device_cache_vs_host_eager",
          "steps": NCF_CHILD_SAMPLES // NCF_BATCH,
          "steps_per_run": NCF_SPR, "loss_graph": legs["graph"][0],
          "loss_eager_host": legs["eager"][0],
          "fit_s": {k: v[2] for k, v in legs.items()},
          "bitwise": dc_bitwise, "card": card})
    del legs
    torch.cuda.empty_cache()
    if not dc_bitwise:
        raise SystemExit("chip_smoke: the device-cached NCF graph is not "
                         "bitwise the host-batched eager fit")

    # -- dense + fused: bench_ncf.py's A/B ---------------------------------
    dense = new_ncf(init)
    dense_kw = dict(fit_kw, lazy_embeddings=False)
    est = Estimator.from_keras(dense.model, optimizer="adam",
                               loss="sparse_categorical_crossentropy")
    dhist, dstep_ms, dcounts, dpeak = timed_ncf_fit(est, data, dense_kw,
                                                    NCF_STEPS)
    dper_step = {k: v / NCF_STEPS for k, v in dcounts.items()}
    emit({"phase": "ncf_train", "leg": "dense_fused", "batch": NCF_BATCH,
          "steps": NCF_STEPS, "step_ms": dstep_ms,
          "ncf_train_samples_per_sec_via_estimator_fit":
              NCF_BATCH / dstep_ms * 1e3,
          "max_memory_allocated_gb": dpeak / 1e9, "loss": dhist["loss"],
          "launches_per_step": dper_step,
          "lazy_speedup": dstep_ms / step_ms, "card": card})
    dense_sweep = -(-len(init) // fad.MAX_LEAVES)     # 12 leaves, 1 launch
    if dper_step != {fad.KERNEL_NAME: float(dense_sweep)}:
        raise SystemExit(f"chip_smoke: dense NCF launches per step "
                         f"{dper_step}, expected {dense_sweep} fused_adam")
    emit(dict(profile_fit(est, data, dense_kw, NCF_STEPS, dstep_ms),
              leg="dense_fused", card=card))
    del est, dense
    gc.collect()
    torch.cuda.empty_cache()

    # -- f32, 3 steps: the kernel path against the plain path --------------
    batch = tuple(a[:NCF_BATCH] for a in data)
    runs = {}
    for name, fused in (("kernel", True), ("plain", False)):
        m = new_ncf(init)
        LAUNCHES.reset()
        h = Estimator.from_keras(
            m.model, optimizer="adam",
            loss="sparse_categorical_crossentropy").fit(
            batch, epochs=3, batch_size=NCF_BATCH, lazy_embeddings=True,
            fused_optimizer=fused)
        runs[name] = (h["loss"], {k: v.detach().cpu().clone() for k, v in
                                  zip(init, m.model.state_dict().values())},
                      LAUNCHES.snapshot())
        del m
    (lk, pk, ck), (lp, pp, cp) = runs["kernel"], runs["plain"]
    loss_err = max(abs(a - b) for a, b in zip(lk, lp))
    touched = {"ncf_mlp_user": table_rows_touched(batch[0], 0, users + 1),
               "ncf_mf_user": table_rows_touched(batch[0], 0, users + 1),
               "ncf_mlp_item": table_rows_touched(batch[0], 1, items + 1),
               "ncf_mf_item": table_rows_touched(batch[0], 1, items + 1)}
    diffs, untouched_same = [], True
    for k in pk:
        start = init[k].cpu()
        layer = k.split(".")[0]
        if layer in touched:
            t = touched[layer]
            diffs.append((pk[k][t] - pp[k][t]).abs())
            untouched_same &= (torch.equal(pk[k][~t], start[~t])
                               and torch.equal(pp[k][~t], start[~t]))
        else:
            diffs.append((pk[k] - pp[k]).abs())
    total = sum(d.numel() for d in diffs)
    param_max = max(d.max().item() for d in diffs)
    frac_over = sum(int((d > 1e-6).sum()) for d in diffs) / total
    kp_ok = (loss_err <= NCF_LOSS_TOL and param_max <= NCF_PARAM_MAX
             and frac_over <= NCF_PARAM_FRAC and untouched_same
             and ck.get(seg.KERNEL_NAME, 0) == 12
             and cp.get(seg.KERNEL_NAME, 0) == 0)
    emit({"phase": "ncf_kernel_vs_plain", "steps": 3, "loss_kernel": lk,
          "loss_plain": lp, "loss_max_abs_err": loss_err,
          "loss_tol": NCF_LOSS_TOL, "param_max_abs_err": param_max,
          "param_tol": NCF_PARAM_MAX, "param_frac_over_1e-6": frac_over,
          "param_frac_tol": NCF_PARAM_FRAC,
          "untouched_rows_equal_initial": untouched_same,
          "launches_kernel_path": ck, "launches_plain_path": cp,
          "ok": kp_ok, "card": card})
    del runs, pk, pp, diffs

    # -- learning, evaluation and ranking ----------------------------------
    rule = new_ncf(class_num=5)
    rule.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
    x_tr, y_tr = ncf_data(rs, 8 * NCF_BATCH, users, items, rule=True)
    h = rule.fit(x_tr, y_tr, batch_size=NCF_BATCH, nb_epoch=3,
                 lazy_embeddings=True, fused_optimizer=True)
    falls = all(math.isfinite(v) for v in h["loss"]) \
        and h["loss"][-1] < h["loss"][0]
    x_ev, y_ev = ncf_data(rs, 65_536, users, items, rule=True)
    t0 = time.perf_counter()
    metrics = rule.evaluate(x_ev, y_ev, batch_per_thread=NCF_BATCH)
    eval_s = time.perf_counter() - t0
    probs = rule.predict(x_ev, batch_per_thread=NCF_BATCH)
    acc_np = float(np.mean(np.argmax(probs, -1) == y_ev))
    acc = metrics["sparse_categorical_accuracy"]
    eval_ok = (probs.shape == (65_536, 5) and bool(np.isfinite(probs).all())
               and abs(acc - acc_np) <= 1.0 / 65_536)
    rank_users = [int(u) for u in x_ev[:3, 0]]
    cands = [UserItemFeature(u, i) for u in rank_users
             for i in range(1, items + 1)]
    t0 = time.perf_counter()
    recs = rule.recommend_for_user(cands, max_items=5,
                                   batch_per_thread=NCF_BATCH)
    rank_s = time.perf_counter() - t0
    scores = rule.predict(np.array([[f.user_id, f.item_id] for f in cands],
                                   np.int32),
                          batch_per_thread=NCF_BATCH)[:, -1]
    rank_ok = True
    for k, u in enumerate(rank_users):
        top = torch.topk(torch.from_numpy(
            scores[k * items:(k + 1) * items]), 5)
        want = [(int(i) + 1, float(v)) for v, i in zip(top.values,
                                                       top.indices)]
        rank_ok &= [s for _, s in recs[u]] == [s for _, s in want] and \
            [i for i, _ in recs[u]] == [i for i, _ in want]
    emit({"phase": "ncf_learn_eval_rank", "class_num": 5,
          "losses": h["loss"], "loss_falls": falls, "evaluate": metrics,
          "accuracy_from_predict": acc_np, "evaluate_s": eval_s,
          "eval_ok": eval_ok, "rank_users": rank_users,
          "candidates": len(cands), "recommend_s": rank_s,
          "top5": {str(u): recs[u] for u in rank_users},
          "rank_matches_topk": rank_ok, "card": card})
    del rule
    gc.collect()
    torch.cuda.empty_cache()
    warm = ncf_warm_restart(card)
    if not (kp_ok and falls and eval_ok and rank_ok and warm["ok"]):
        raise SystemExit("chip_smoke: NCF check failed")
    return counts


# ---------------------------------------------------------------------------
# decode attention kernels (contiguous and paged)
# ---------------------------------------------------------------------------
# GPT-2 small's attention at the serving engine's pool: 32 slots, 12 heads,
# head dim 64, a 1024-position pool, blocks of 16; the smallest and the
# largest kv bucket of the engine's ladder, then the median step's (PERF.md
# §5), ragged lengths in [1, bucket]. 128 and 1024 come first so that their
# draws from the seed are those the earlier kernel was timed on.
DEC_SLOTS, DEC_HEADS, DEC_LEN, DEC_DIM = 32, 12, 1024, 64
DEC_BUCKETS = (128, 1024, 512)
DEC_BLOCK = 16
DEC_MAIN = (1024, torch.float32)
# Kernel vs plain version, max abs error. f32: both sum in f32 in other
# orders (the kernel online over tiles of 64 keys in each of its cluster's
# n_split spans, its lanes' and slices' partial sums added in a fixed order
# and the spans merged in rank order; the plain version through cuBLAS and a
# softmax) — rounding only, on outputs of magnitude <= ~3. bf16: the plain
# version forms the scores in bf16 (2^-9 relative on scores of magnitude
# ~5) where the kernel keeps them in f32, and both store O in bf16.
DEC_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Timing cycles through pool sets that share one draw of lengths (so the
# bound is of the timed work) and whose live K and V together take at least
# twice the H100's 50 MB L2, so the reads come from device memory; at
# least DEC_MIN_POOLS sets.
DEC_L2_BYTES = 50 * 2 ** 20
DEC_MIN_POOLS = 3


def decode_bound(lengths, kv_bucket: int, heads: int, dim: int, dtype,
                 block_len=None):
    """(ms, "bytes" | "operations") of one decode-attention launch over
    these lengths: each live key and value row read once (positions past
    min(length, kv_bucket) are not needed), q and lengths read and O
    written once, and, paged, the live block-table entries; QKᵀ and PV,
    2·D flops a position each per head."""
    item = torch.finfo(dtype).bits // 8
    live = lengths.clamp(max=kv_bucket).long()
    n = int(live.sum())
    S = lengths.shape[0]
    nbytes = 2.0 * n * heads * dim * item + 2.0 * S * heads * dim * item \
        + 4.0 * S
    if block_len is not None:
        nbytes += 4.0 * int(((live + block_len - 1) // block_len).sum())
    flops = 4.0 * n * heads * dim
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def scatter_blocks(pool, perm, block_len: int):
    """The contiguous pool's bytes re-homed into a block pool at the
    shuffled block ids `perm` ([S, L // block_len], all >= 1; block 0 is
    the scratch block): the same logical values at other addresses."""
    S, H, L, D = pool.shape
    n_kb = L // block_len
    blocks = torch.zeros((S * n_kb + 1, H, block_len, D), dtype=pool.dtype,
                         device=pool.device)
    blocks[perm.reshape(-1).long()] = pool.view(
        S, H, n_kb, block_len, D).permute(0, 2, 1, 3, 4).reshape(
            S * n_kb, H, block_len, D)
    return blocks


def decode_lengths(gen, kv_bucket: int):
    """Ragged lengths in [1, kv_bucket], one per slot."""
    return torch.randint(1, kv_bucket + 1, (DEC_SLOTS,), device="cuda",
                         generator=gen, dtype=torch.int32)


def decode_pool_sets(lengths, kv_bucket: int, dtype) -> int:
    """How many pool sets the timing cycles through (DEC_L2_BYTES)."""
    item = torch.finfo(dtype).bits // 8
    live = int(lengths.clamp(max=kv_bucket).sum())
    per_set = 2 * live * DEC_HEADS * DEC_DIM * item
    return max(DEC_MIN_POOLS, -(-2 * DEC_L2_BYTES // per_set))


def decode_case_inputs(gen, lengths, dtype):
    """One pool set: q, the contiguous pools, their block-pool copies and
    tables, and `lengths`."""
    S, H, L, D = DEC_SLOTS, DEC_HEADS, DEC_LEN, DEC_DIM
    q = torch.randn((S, H, D), device="cuda", generator=gen).to(dtype)
    k = torch.randn((S, H, L, D), device="cuda", generator=gen).to(dtype)
    v = torch.randn((S, H, L, D), device="cuda", generator=gen).to(dtype)
    n_kb = L // DEC_BLOCK
    perm = (torch.randperm(S * n_kb, device="cuda", generator=gen) + 1
            ).to(torch.int32).view(S, n_kb)
    return (q, k, v, lengths, scatter_blocks(k, perm, DEC_BLOCK),
            scatter_blocks(v, perm, DEC_BLOCK), perm)


def sdpa_decode(q, k, v, lengths, kv_bucket: int):
    """The library yardstick the port never calls: SDPA with a one-row
    query and a boolean length mask over the first kv_bucket positions."""
    keep = (torch.arange(kv_bucket, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None], k[:, :, :kv_bucket], v[:, :, :kv_bucket],
        attn_mask=keep)[:, :, 0]


def graph_replay(fn):
    """fn's output from one capture and replay of a CUDA graph (warmed on
    the capturing stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    del graph
    return out


def decode_checks(inputs, kv_bucket: int, dtype) -> dict:
    """Both kernels on one pool set against the plain versions: the error,
    paged bitwise equal to contiguous, one launch each, a second launch
    bitwise equal to the first, and a CUDA graph's replay bitwise equal to
    the eager call."""
    q, k, v, lengths, kp, vp, tables = inputs

    def contiguous():
        return da.decode_attention(q, k, v, lengths, kv_bucket)

    def paged():
        return da.paged_decode_attention(q, kp, vp, tables, lengths,
                                         kv_bucket)
    before = LAUNCHES.snapshot()
    out, out_p = contiguous(), paged()
    torch.cuda.synchronize()
    after = LAUNCHES.snapshot()
    launched = {name: after.get(name, 0) - before.get(name, 0)
                for name in (da.KERNEL_NAME, da.PAGED_NAME)}
    ref = da._reference_decode_attention(q, k, v, lengths, kv_bucket)
    ref_p = da._reference_paged_decode_attention(q, kp, vp, tables, lengths,
                                                 kv_bucket)
    err = (out.float() - ref.float()).abs().max().item()
    err_p = (out_p.float() - ref_p.float()).abs().max().item()
    twice = bool(torch.equal(contiguous(), out)
                 and torch.equal(paged(), out_p))
    graph = bool(torch.equal(graph_replay(contiguous), out)
                 and torch.equal(graph_replay(paged), out_p))
    n_split = da._split_plan(kv_bucket)
    row = {"max_abs_err": err, "max_abs_err_paged": err_p,
           "tol": DEC_TOL[dtype],
           "paged_bitwise_contiguous": bool(torch.equal(out, out_p)),
           "plain_paged_bitwise_contiguous": bool(torch.equal(ref, ref_p)),
           "twice_bitwise": twice, "graph_bitwise_eager": graph,
           "launches": launched, "n_split": n_split,
           "cluster_size": n_split}
    row["ok"] = (err <= row["tol"] and err_p <= row["tol"]
                 and row["paged_bitwise_contiguous"]
                 and row["plain_paged_bitwise_contiguous"] and twice
                 and graph and bool(torch.isfinite(out).all())
                 and launched == {da.KERNEL_NAME: 1, da.PAGED_NAME: 1})
    return row, ref


def decode_ptxas(dtype) -> dict:
    """ptxas's registers and spills of the two instantiations of `dtype`."""
    tag = "f32" if dtype == torch.float32 else "bf16"
    report = ptxas_report(da.SOURCE)
    return {mode: report.get(f"decode_attention_kernel<{tag},{mode}>")
            for mode in ("contiguous", "paged")}


def phase_decode_kernels(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 80)
    results = {}
    failed = []
    for kv_bucket in DEC_BUCKETS:
        for dtype in (torch.float32, torch.bfloat16):
            lengths = decode_lengths(gen, kv_bucket)
            sets = [decode_case_inputs(gen, lengths, dtype) for _ in range(
                decode_pool_sets(lengths, kv_bucket, dtype))]
            checks, ref = decode_checks(sets[0], kv_bucket, dtype)
            q, k, v, lengths = sets[0][:4]
            lib = sdpa_decode(q, k, v, lengths, kv_bucket)
            lib_err = (lib.float() - ref.float()).abs().max().item()
            # device time of calls replayed from a CUDA graph (a launch's
            # host side is longer than the kernel, so CUDA events around
            # a run of launches time the host: given beside as "wall"),
            # each call on the next pool set so the reads come from
            # device memory; every set has the same lengths, so the bound
            # below is the timed work's
            calls = {
                "kernel": lambda q, k, v, n, *_: da.decode_attention(
                    q, k, v, n, kv_bucket),
                "paged_kernel": lambda q, _k, _v, n, kp, vp, t:
                    da.paged_decode_attention(q, kp, vp, t, n, kv_bucket),
                "plain": lambda q, k, v, n, *_:
                    da._reference_decode_attention(q, k, v, n, kv_bucket),
                "paged_plain": lambda q, _k, _v, n, kp, vp, t:
                    da._reference_paged_decode_attention(
                        q, kp, vp, t, n, kv_bucket),
                "library": lambda q, k, v, n, *_: sdpa_decode(
                    q, k, v, n, kv_bucket),
                "paged_library": lambda q, _k, _v, n, kp, vp, t:
                    sdpa_decode(q, da.gather_kv_window(kp, t, kv_bucket),
                                da.gather_kv_window(vp, t, kv_bucket), n,
                                kv_bucket)}
            reps = max(12, len(sets))      # every set once a replay
            times = {f"{name}_ms": graph_ms(cycling(fn, sets), reps)
                     for name, fn in calls.items()}
            for name in ("kernel", "paged_kernel"):
                times[f"{name}_wall_ms"] = time_ms(
                    cycling(calls[name], sets), max(20, len(sets)))
            bound = decode_bound(lengths, kv_bucket, DEC_HEADS, DEC_DIM,
                                 dtype)
            paged_bound = decode_bound(lengths, kv_bucket, DEC_HEADS,
                                       DEC_DIM, dtype, DEC_BLOCK)
            row = {"phase": "decode_kernel", "kv_bucket": kv_bucket,
                   "dtype": str(dtype)[6:],
                   "shape": [DEC_SLOTS, DEC_HEADS, DEC_LEN, DEC_DIM],
                   "block_len": DEC_BLOCK, "pool_sets": len(sets),
                   "live_positions": int(lengths.clamp(
                       max=kv_bucket).sum()),
                   **checks, "library_err_vs_plain": lib_err, **times,
                   "bound_ms": bound[0], "bound_by": bound[1],
                   "paged_bound_ms": paged_bound[0],
                   "paged_bound_by": paged_bound[1],
                   "pct_of_bound": 100.0 * bound[0] / times["kernel_ms"],
                   "paged_pct_of_bound":
                       100.0 * paged_bound[0] / times["paged_kernel_ms"],
                   "ptxas": decode_ptxas(dtype), "card": card}
            emit(row)
            results[(kv_bucket, dtype)] = row
            if not row["ok"]:
                failed.append(row)
            del sets, q, k, v, lib, ref
    # a bucket the JAX wrapper's 128-key tiling does not divide (its exact
    # path there): on the card both kernels launch at it, as at any bucket
    for dtype in (torch.float32, torch.bfloat16):
        lengths = decode_lengths(gen, 192)
        checks, _ = decode_checks(decode_case_inputs(gen, lengths, dtype),
                                  192, dtype)
        row = {"phase": "decode_kernel_192", "kv_bucket": 192,
               "dtype": str(dtype)[6:], **checks}
        emit(row)
        results[(192, dtype)] = row
        if not row["ok"]:
            failed.append(row)
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: {len(failed)} decode-attention "
                         "case(s) failed")
    return results


# ---------------------------------------------------------------------------
# generative decode serving
# ---------------------------------------------------------------------------
# GPT-2 small's published widths (Radford et al. 2019; the `gpt2` config:
# n_embd 768, n_layer 12, n_head 12, n_positions 1024, vocab 50257) on the
# repo's generative model, f32 as the JAX package serves it, random weights
# from the seed.
GEN_CFG = dict(vocab=50257, n_layers=12, n_heads=12, head_dim=64,
               max_len=1024, mlp_mult=4)
GEN_ENGINE = dict(slots=32, max_kv_len=1024,
                  kv_buckets=[128, 256, 512, 1024],
                  prompt_buckets=[64, 128, 256, 512])
GEN_PAGED = dict(block_len=16, prefill_chunk=256)    # kv_blocks: default
GEN_REQUESTS = 64
GEN_MAX_NEW_CAP = 128
GEN_SHARED_PREFIX = 256
GEN_TEACHER_STEPS = 32
# Teacher-forced logits over one prompt and 32 steps, f32, TF32 off. The
# kernel path against the plain path on the card: the two differ only in
# the attention's summation order — 1e-4. Each card path, and the port's
# CPU run of the same weights, against the model's math in f64 on the host
# (`f64_teacher_logits`): every f32 run sums its matmuls and reductions in
# its own order (cuBLAS's or the CPU's) through 12 blocks of width 768, on
# logits of magnitude ~40 (random weights of scale 0.08, not GPT-2's
# 0.02). A card path passes when it is no further from f64 than
# GEN_F64_FACTOR times the CPU's f32 run is: the card rounds as an f32 run
# does. A wrong model path (a key masked wrongly, a position off by one)
# moves logits by O(1), four orders above.
GEN_KERNEL_TOL = 1e-4
GEN_F64_FACTOR = 2.0
# A paged stream may differ from the contiguous one only where chunked
# prefill or prefix adoption changed a summation order and the contiguous
# logits' top two were closer than this.
GEN_TIE_GAP = 1e-4


def gen_traffic(rs, vocab: int):
    """The request mix: prompt lengths uniform in 16-400 with uniform ids;
    half of the prompts one shared 256-token prefix (16 blocks) and a tail
    of 16-144 tokens; `max_new` from bench_serving.py's bimodal mix with
    the cap at 128 (every 8th request at the cap); Poisson arrivals at a
    2 ms mean gap."""
    n = GEN_REQUESTS
    prefix = rs.integers(0, vocab, GEN_SHARED_PREFIX).astype(np.int32)
    prompts = []
    for i in range(n):
        if i % 2:
            tail = rs.integers(0, vocab, int(rs.integers(16, 145)))
            prompts.append(np.concatenate([prefix, tail]).astype(np.int32))
        else:
            prompts.append(rs.integers(0, vocab, int(rs.integers(16, 401))
                                       ).astype(np.int32))
    max_new = np.minimum(1 + rs.geometric(0.25, n),
                         GEN_MAX_NEW_CAP).astype(int)
    max_new[::8] = GEN_MAX_NEW_CAP
    arrivals = np.cumsum(rs.exponential(0.002, n))
    return prompts, max_new, arrivals


def bucket_ms(registry, phase: str):
    """The engine's own call times by bucket (its `serving_bucket_ms`
    histogram; phase "decode_step" by kv bucket, "prefill" by prompt or
    chunk bucket): count, mean, p50, on the host's clock."""
    out = {}
    fam = registry.snapshot().get("serving_bucket_ms", {})
    for s in fam.get("series", []):
        lab = s.get("labels", {})
        if lab.get("phase") == phase and s["count"]:
            out[lab["bucket"]] = {"steps": s["count"],
                                  "mean_ms": s["sum"] / s["count"],
                                  "p50_ms": s["p50"]}
    return out


def serve_generative(im, dec, paged: bool, traffic, card: str,
                     label: str = "", **engine_kw):
    """One engine over a MemoryBroker: the traffic enqueued at its arrival
    times from this thread while the engine steps in its own, every stream
    read back. Launch counts are reset just before and read just after.
    On a warmed model every prefill, chunk and step replays its program
    (its CUDA graph); `engine_kw` overrides the engine's settings."""
    prompts, max_new, arrivals = traffic
    kw = dict(GEN_ENGINE, max_new_default=GEN_MAX_NEW_CAP,
              registry=MetricsRegistry())
    if paged:
        kw.update(GEN_PAGED, paged=True, init_kv_blocks=dec.init_kv_blocks)
    kw.update(engine_kw)
    broker = MemoryBroker()
    srv = DecodeServing(im, dec.init_kv, broker=broker, **kw)
    inq, outq = InputQueue(broker), OutputQueue(broker)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    builds = _build.build_events()
    replays0 = sum(im.program_replays().values())
    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    srv.start()
    t0 = time.perf_counter()
    uris = []
    for i, prompt in enumerate(prompts):
        dt = t0 + arrivals[i] - time.perf_counter()
        if dt > 0:
            time.sleep(dt)
        uris.append(inq.enqueue(t=prompt, max_new=int(max_new[i]),
                                stream=1))
    while srv.stats["finished"] < len(prompts):
        if not srv.is_alive() or time.perf_counter() - t0 > 600:
            raise SystemExit(f"chip_smoke: decode engine stopped "
                             f"({srv.stats})")
        time.sleep(0.001)
    wall = time.perf_counter() - t0
    srv.stop()
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    replays = sum(im.program_replays().values()) - replays0
    peak = torch.cuda.max_memory_allocated()
    builds_after = _build.build_events()
    streams, ttft, itl = {}, [], []
    for uri, prompt in zip(uris, prompts):
        events = list(outq.stream_tokens(uri, timeout_s=30))
        ms = [e["ms"] for e in events if "i" in e]
        final = events[-1]
        if not final.get("done") or final.get("error"):
            raise SystemExit(f"chip_smoke: request {uri} failed: {final}")
        streams[uri] = [int(t) for t in np.asarray(final["tokens"])]
        ttft.append(ms[0])
        itl += list(np.diff(ms))
    steps = srv.stats["steps"]
    kernel = da.PAGED_NAME if paged else da.KERNEL_NAME
    other = da.KERNEL_NAME if paged else da.PAGED_NAME
    tokens = sum(len(s) for s in streams.values())
    prefills = srv.stats["prefill_chunks"] if paged \
        else srv.stats["prefills"]
    graphed = im.compile_cache_size() > 0
    row = {"phase": "generative_serving", "mode": "paged" if paged
           else "contiguous", "label": label, "graphs": graphed,
           "graph_replays": replays,
           "calls": steps + prefills, "config": GEN_CFG,
           "engine": GEN_ENGINE, "engine_overrides": {
               k: v for k, v in engine_kw.items()},
           "paged": GEN_PAGED if paged else None,
           "requests": len(prompts), "tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_p50_ms": float(np.percentile(ttft, 50)),
           "ttft_p99_ms": float(np.percentile(ttft, 99)),
           "itl_p50_ms": float(np.percentile(itl, 50)),
           "itl_p99_ms": float(np.percentile(itl, 99)),
           "slot_utilization": srv.utilization(), "steps": steps,
           "step_ms_by_bucket": bucket_ms(srv.registry, "decode_step"),
           "prefill_ms_by_bucket": bucket_ms(srv.registry, "prefill"),
           "stats": srv.stats, "launches": counts,
           "launches_per_step": counts.get(kernel, 0) / max(steps, 1),
           "builds_before": builds, "builds_after": builds_after,
           "max_memory_allocated_gb": peak / 1e9, "card": card}
    emit(row)
    if (counts.get(kernel, 0) != GEN_CFG["n_layers"] * steps
            or counts.get(other, 0) or not steps):
        raise SystemExit(f"chip_smoke: {counts} launches over {steps} "
                         f"steps, expected {GEN_CFG['n_layers']} {kernel} "
                         "a step and nothing else")
    if builds_after != builds:
        raise SystemExit(f"chip_smoke: kernels built on the request path: "
                         f"{builds} -> {builds_after}")
    if replays != (steps + prefills if graphed else 0):
        raise SystemExit(f"chip_smoke: {replays} program replays over "
                         f"{steps} steps and {prefills} prefills "
                         f"(graphs: {graphed})")
    if srv.stats["finished"] != len(prompts) or srv.stats["failed"]:
        raise SystemExit(f"chip_smoke: engine stats {srv.stats}")
    for uri, n in zip(uris, max_new):
        if len(streams[uri]) != int(n) or not all(
                0 <= t < GEN_CFG["vocab"] for t in streams[uri]):
            raise SystemExit(f"chip_smoke: stream {uri} has "
                             f"{len(streams[uri])} tokens, expected {n}")
    return [streams[u] for u in uris], row


def _drive_inline(srv, until, max_iters=2000):
    """The engine loop inline (watchdog, intake, step, flush), as `run()`
    iterates it, until `until()`."""
    step = srv._run_paged_step if srv.paged else srv._run_step
    for _ in range(max_iters):
        srv._watchdog()
        srv._intake()
        step()
        srv._flush_pending()
        if until():
            return
    raise SystemExit(f"chip_smoke: inline engine did not finish: "
                     f"{srv.stats}")


def decode_resume(im, dec, card: str, seed: int):
    """A paged engine that dies after GR_RESUME_STEPS steps of one
    streamed request, and a second engine that claims the record and
    resumes it from its durable token rows: the resumed stream against the
    same request decoded uninterrupted, both on the warmed (graphed)
    model."""
    rs = np.random.default_rng(seed + 95)
    prompt = rs.integers(0, GEN_CFG["vocab"], 40).astype(np.int32)
    kw = dict(GEN_ENGINE, **GEN_PAGED, paged=True,
              init_kv_blocks=dec.init_kv_blocks,
              max_new_default=GR_RESUME_NEW)

    def engine(broker, name, **extra):
        return DecodeServing(im, dec.init_kv, broker=broker,
                             registry=MetricsRegistry(), engine_id=name,
                             **dict(kw, **extra))

    import gc
    b0 = MemoryBroker()
    e0 = engine(b0, "uninterrupted")
    uri0 = InputQueue(b0).enqueue(t=prompt, max_new=GR_RESUME_NEW, stream=1)
    _drive_inline(e0, lambda: e0.stats["finished"] >= 1)
    e0.stop(drain=False)            # gives the warmed pool back
    want = [int(t) for t in np.asarray(OutputQueue(b0).query(uri0))]
    b1 = MemoryBroker()
    e1 = engine(b1, "dies")
    uri = InputQueue(b1).enqueue(t=prompt, max_new=GR_RESUME_NEW, stream=1)
    e1._intake()
    for _ in range(GR_RESUME_STEPS):
        e1._run_paged_step()
    emitted = e1.stats["tokens"]
    del e1                          # the engine dies, and its hold on the
    gc.collect()                    # pool with it
    time.sleep(0.1)
    replays0 = sum(im.program_replays().values())
    eager0 = dict(im.gen_eager_calls)
    e2 = engine(b1, "resumes", claim_min_idle_s=0.05, claim_interval_s=0.0)
    _drive_inline(e2, lambda: e2.stats["finished"] >= 1)
    e2.stop(drain=False)
    replays = sum(im.program_replays().values()) - replays0
    got = [int(t) for t in np.asarray(OutputQueue(b1).query(uri))]
    row = {"phase": "generative_resume", "prompt_len": len(prompt),
           "max_new": GR_RESUME_NEW, "tokens_before_death": emitted,
           "resumed": e2.stats["resumed"],
           "recovered_tokens": e2.stats["recovered_tokens"],
           "resumed_engine_replays": replays,
           "resumed_engine_calls": e2.stats["steps"]
           + e2.stats["prefill_chunks"],
           "eager_calls": {k: v - eager0.get(k, 0)
                           for k, v in im.gen_eager_calls.items()},
           "bitwise_uninterrupted": got == want, "card": card}
    emit(row)
    if not (0 < emitted < GR_RESUME_NEW and e2.stats["resumed"] == 1
            and got == want and im.gen_eager_calls == eager0
            and replays == row["resumed_engine_calls"]):
        raise SystemExit(f"chip_smoke: decode resume check failed: {row}")
    return row


def top2_gap(im, dec, context) -> float:
    """The gap between the two largest next-token logits after `context`,
    from the contiguous prefill program on a one-slot pool."""
    P = dec.max_len
    padded = np.zeros(P, np.int32)
    padded[:len(context)] = context
    _, logits = im.generative_prefill(dec.init_kv(1, P), padded,
                                      len(context), 0)
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def f64_teacher_logits(tree, prompt, forced) -> np.ndarray:
    """The teacher-forced logits rows of `teacher_forced_logits` (the
    prefill's last row and one row a step), from `TinyDecoder`'s math (pre-
    LN blocks, learned positions, tanh GELU, untied head, eps 1e-5) in f64
    on the host: one causal pass over prompt + forced, independent of the
    port's programs."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float64))

    def ln(x, g, b):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * t(g) + t(b)

    H, D = GEN_CFG["n_heads"], GEN_CFG["head_dim"]
    ids = torch.as_tensor(np.concatenate([prompt, forced]).astype(np.int64))
    n = ids.shape[0]
    x = t(tree["embed"])[ids] + t(tree["pos"])[:n]
    causal = torch.ones((n, n), dtype=torch.bool).tril()
    for lp in tree["layers"]:
        h = ln(x, lp["ln1_g"], lp["ln1_b"])
        q, k, v = ((h @ t(lp[w])).view(n, H, D).transpose(0, 1)
                   for w in ("wq", "wk", "wv"))
        scores = (q @ k.transpose(1, 2) / math.sqrt(D)).masked_fill(
            ~causal, -math.inf)
        att = torch.softmax(scores, dim=-1) @ v
        x = x + att.transpose(0, 1).reshape(n, H * D) @ t(lp["wo"])
        u = ln(x, lp["ln2_g"], lp["ln2_b"]) @ t(lp["w1"]) + t(lp["b1"])
        gelu = 0.5 * u * (1.0 + torch.tanh(
            math.sqrt(2.0 / math.pi) * (u + 0.044715 * u ** 3)))
        x = x + gelu @ t(lp["w2"]) + t(lp["b2"])
    x = ln(x[len(prompt) - 1:], tree["lnf_g"], tree["lnf_b"])
    return (x @ t(tree["head"])).numpy()


def teacher_forced_logits(im, dec, prompt, forced):
    """Prefill `prompt` into a one-slot pool, then one decode step per
    forced token; every logits row, on the host."""
    P = _next_bucket(len(prompt), GEN_ENGINE["prompt_buckets"])
    padded = np.zeros(P, np.int32)
    padded[:len(prompt)] = prompt
    kv = dec.init_kv(1, GEN_ENGINE["max_kv_len"])
    kv, logits = im.generative_prefill(kv, padded, len(prompt), 0)
    rows = [logits.float().cpu().numpy()]
    for i, tok in enumerate(forced):
        pos = len(prompt) + i
        bucket = _next_bucket(pos + 1, GEN_ENGINE["kv_buckets"])
        kv, logits = im.generative_step(kv, np.asarray([tok], np.int32),
                                        np.asarray([pos], np.int32), bucket)
        rows.append(logits[0].float().cpu().numpy())
    return np.stack(rows)


def phase_generative(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    dec = TinyDecoder(**GEN_CFG, device="cuda")
    tree = dec.init_params(seed)
    emit({"phase": "generative_weights", "seconds": time.perf_counter() - t0,
          "parameters": sum(a.size for a in tree_leaves(tree))})
    im = InferenceModel().load_generative(
        dec.prefill_fn, dec.step_fn, tree,
        paged_prefill_fn=dec.paged_prefill_fn,
        paged_step_fn=dec.paged_step_fn)
    e = GEN_ENGINE
    table_len = e["max_kv_len"] // GEN_PAGED["block_len"]
    chunk_buckets = [b for b in e["prompt_buckets"]
                     if b <= GEN_PAGED["prefill_chunk"]]
    t1 = time.perf_counter()
    im.warmup_generative(dec.init_kv, slots=e["slots"],
                         max_kv_len=e["max_kv_len"],
                         prompt_buckets=e["prompt_buckets"],
                         kv_buckets=e["kv_buckets"])
    t2 = time.perf_counter()
    im.warmup_generative_paged(
        dec.init_kv_blocks, num_blocks=e["slots"] * table_len + 1,
        block_len=GEN_PAGED["block_len"], lanes=e["slots"],
        table_len=table_len, chunk_buckets=chunk_buckets,
        kv_buckets=e["kv_buckets"])
    t3 = time.perf_counter()
    torch.cuda.empty_cache()
    emit({"phase": "generative_warmup", "contiguous_s": t2 - t1,
          "paged_s": t3 - t2, "programs": im.warmup_report,
          "builds": _build.build_events()})

    rs = np.random.default_rng(seed + 90)
    traffic = gen_traffic(rs, GEN_CFG["vocab"])
    contiguous, c_row = serve_generative(im, dec, False, traffic, card)
    paged, p_row = serve_generative(im, dec, True, traffic, card)
    if p_row["stats"]["prefix_hit_tokens"] <= 0 or \
            p_row["stats"]["prefill_chunks"] <= p_row["stats"]["prefills"]:
        raise SystemExit("chip_smoke: the paged run took no prefix hit or "
                         "no chunked prefill")

    # paged streams against contiguous streams
    prompts = traffic[0]
    diffs = []
    for i, (a, b) in enumerate(zip(contiguous, paged)):
        if a == b:
            continue
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = top2_gap(im, dec, np.concatenate(
            [prompts[i], np.asarray(a[:j], np.int32)]))
        diffs.append({"request": i, "first_diff": j, "top2_gap": gap})
    emit({"phase": "generative_parity", "requests": len(prompts),
          "equal_streams": len(prompts) - len(diffs), "differ": diffs,
          "tie_gap_tol": GEN_TIE_GAP})
    if any(d["top2_gap"] >= GEN_TIE_GAP for d in diffs):
        raise SystemExit("chip_smoke: paged streams differ from contiguous "
                         "beyond a near-tie")

    # -- the graphs: paged with neither chunking nor prefix adoption (each
    # prompt one fresh chunk, op for op the contiguous prefill) against the
    # contiguous streams, bit for bit; the eager engine's streams against
    # the graphed ones; a crash-resumed stream
    t_g = time.perf_counter()
    im.warmup_generative_paged(
        dec.init_kv_blocks, num_blocks=e["slots"] * table_len + 1,
        block_len=GEN_PAGED["block_len"], lanes=e["slots"],
        table_len=table_len, chunk_buckets=list(e["prompt_buckets"]),
        kv_buckets=e["kv_buckets"])
    exact, x_row = serve_generative(
        im, dec, True, traffic, card, label="paged_exact",
        prefill_chunk=None, prefix_cache=False,
        chunk_buckets=list(e["prompt_buckets"]))
    exact_equal = sum(a == b for a, b in zip(contiguous, exact))
    eager_im = InferenceModel().load_generative(
        dec.prefill_fn, dec.step_fn, im._params,
        paged_prefill_fn=dec.paged_prefill_fn,
        paged_step_fn=dec.paged_step_fn)
    eager, e_row = serve_generative(eager_im, dec, False, traffic, card,
                                    label="eager")
    eager_diffs = []
    for i, (a, b) in enumerate(zip(contiguous, eager)):
        if a != b:
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            eager_diffs.append({"request": i, "first_diff": j,
                                "top2_gap": top2_gap(eager_im, dec,
                                    np.concatenate([prompts[i], np.asarray(
                                        a[:j], np.int32)]))})
    resume = decode_resume(im, dec, card, seed)
    eager_profiles = {m: profile_decode_step(eager_im, dec, m == "paged",
                                             card)
                      for m in ("contiguous", "paged")}
    del eager_im
    torch.cuda.empty_cache()
    profiles = {m: profile_decode_step(im, dec, m == "paged", card)
                for m in ("contiguous", "paged")}
    graphs_row = {
        "phase": "generative_graphs", "programs": im.compile_cache_size(),
        "paged_exact_equal_streams": exact_equal,
        "requests": len(prompts),
        "eager_equal_streams": len(prompts) - len(eager_diffs),
        "eager_differ": eager_diffs, "tie_gap_tol": GEN_TIE_GAP,
        "resume_bitwise": resume["bitwise_uninterrupted"],
        "graph_pool_bytes": {f"r{k}": v for k, v in
                             im.graph_pool_bytes().items()},
        "kv512_step_ms": {m: {"graph": profiles[m]["step_ms"],
                              "eager": eager_profiles[m]["step_ms"]}
                          for m in profiles},
        "kv512_device_ms": {m: {"graph": profiles[m]["device_ms_per_step"],
                                "eager": eager_profiles[m][
                                    "device_ms_per_step"]}
                            for m in profiles},
        "tokens_per_s": {"graph_contiguous": c_row["tokens_per_s"],
                         "graph_paged": p_row["tokens_per_s"],
                         "graph_paged_exact": x_row["tokens_per_s"],
                         "eager_contiguous": e_row["tokens_per_s"]},
        "ttft_p50_ms": {"graph_contiguous": c_row["ttft_p50_ms"],
                        "graph_paged": p_row["ttft_p50_ms"],
                        "eager_contiguous": e_row["ttft_p50_ms"]},
        "itl_p50_ms": {"graph_contiguous": c_row["itl_p50_ms"],
                       "graph_paged": p_row["itl_p50_ms"],
                       "eager_contiguous": e_row["itl_p50_ms"]},
        "itl_p99_ms": {"graph_contiguous": c_row["itl_p99_ms"],
                       "graph_paged": p_row["itl_p99_ms"],
                       "eager_contiguous": e_row["itl_p99_ms"]},
        "seconds": time.perf_counter() - t_g, "card": card}
    emit(graphs_row)
    if exact_equal != len(prompts) or any(
            d["top2_gap"] >= GEN_TIE_GAP for d in eager_diffs):
        raise SystemExit("chip_smoke: graphed decode streams differ")
    emit({"phase": "generative_summary", "card": card, **{
        mode: {"tokens_per_s": row["tokens_per_s"],
               "ttft_p50_ms": row["ttft_p50_ms"],
               "ttft_p99_ms": row["ttft_p99_ms"],
               "itl_p50_ms": row["itl_p50_ms"],
               "itl_p99_ms": row["itl_p99_ms"],
               "profiled_step_kv_bucket": profiles[mode]["kv_bucket"],
               "decode_attention_device_ms":
                   profiles[mode]["decode_attention_device_ms"],
               "device_ms_per_step": profiles[mode]["device_ms_per_step"],
               "step_ms": profiles[mode]["step_ms"],
               "idle_share": profiles[mode]["idle_share"]}
        for mode, row in (("contiguous", c_row), ("paged", p_row))}})

    # teacher-forced logits: both card paths and the port's CPU run against
    # f64, and the kernel path against the plain path on the card
    prompt = prompts[0][:100]
    forced = contiguous[1][:GEN_TEACHER_STEPS]
    forced = (forced + [7] * GEN_TEACHER_STEPS)[:GEN_TEACHER_STEPS]
    before = LAUNCHES.get(da.KERNEL_NAME)
    card_rows = teacher_forced_logits(im, dec, prompt, forced)
    tf_launches = LAUNCHES.get(da.KERNEL_NAME) - before
    plain_dec = TinyDecoder(**GEN_CFG, use_pallas=False, device="cuda")
    plain_im = InferenceModel().load_generative(
        plain_dec.prefill_fn, plain_dec.step_fn, im._params)
    plain_rows = teacher_forced_logits(plain_im, plain_dec, prompt, forced)
    del plain_im
    t4 = time.perf_counter()
    cpu_dec = TinyDecoder(**GEN_CFG, device="cpu")
    cpu_im = InferenceModel(device="cpu").load_generative(
        cpu_dec.prefill_fn, cpu_dec.step_fn, tree)
    cpu_rows = teacher_forced_logits(cpu_im, cpu_dec, prompt, forced)
    del cpu_im
    cpu_s = time.perf_counter() - t4
    exact = f64_teacher_logits(tree, prompt, np.asarray(forced, np.int64))
    per_row = {"kernel_vs_f64": np.abs(card_rows - exact).max(axis=1),
               "plain_vs_f64": np.abs(plain_rows - exact).max(axis=1),
               "cpu_vs_f64": np.abs(cpu_rows - exact).max(axis=1),
               "kernel_vs_cpu": np.abs(card_rows - cpu_rows).max(axis=1)}
    errs = {k: float(v.max()) for k, v in per_row.items()}
    errs["kernel_vs_plain"] = float(np.abs(card_rows - plain_rows).max())
    f64_tol = GEN_F64_FACTOR * errs["cpu_vs_f64"]
    tols = {"kernel_vs_f64": f64_tol, "plain_vs_f64": f64_tol,
            "kernel_vs_plain": GEN_KERNEL_TOL}
    ok = (all(errs[k] <= tols[k] for k in tols)
          and bool(np.isfinite(card_rows).all())
          and card_rows.shape == (GEN_TEACHER_STEPS + 1, GEN_CFG["vocab"])
          and tf_launches == GEN_CFG["n_layers"] * GEN_TEACHER_STEPS)
    emit({"phase": "generative_check", "prompt_len": len(prompt),
          "steps": GEN_TEACHER_STEPS, "max_abs_err": errs,
          "tol": tols, "f64_factor": GEN_F64_FACTOR,
          "per_row": {k: [float(x) for x in v] for k, v in per_row.items()},
          "logit_abs_max": float(np.abs(exact).max()),
          "kernel_launches": tf_launches, "cpu_seconds": cpu_s,
          "f64_seconds": time.perf_counter() - t4 - cpu_s, "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: generative logits check failed")
    return {"contiguous": c_row, "paged": p_row, "profile": profiles,
            "graphs": graphs_row}


def host_and_device_ms(fn, reps: int, calls=None, want=None,
                       windows: int = GR_PROFILE_WINDOWS):
    """`fn`'s mean time on the host's clock (unprofiled, after three warm
    calls, each call ending in a copy to the host), then its device time
    by kernel under torch.profiler after one untraced warm-up step: (host
    ms, device ms, top kernels). With `calls` (top rows -> calls a call of
    `fn`) and `want`, windows are taken until one reads `want`, at most
    `windows`; a window that recorded nothing is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for n in (1, reps):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # the schedule's step ranges ("ProfilerStep#N") are device rows
        # too: not kernels
        rows = [(ev.key, ev.self_device_time_total / 1e3 / reps,
                 ev.count / reps) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0
                and not ev.key.startswith("ProfilerStep")]
        seen = [{"kernel": name[:96], "ms": ms, "calls": k}
                for name, ms, k in rows]
        if rows and (calls is None or calls(seen) == want):
            break
    rows.sort(key=lambda r: -r[1])
    dev = sum(r[1] for r in rows)
    top = [{"kernel": name[:96], "ms": ms, "share": ms / dev, "calls": k}
           for name, ms, k in rows]
    return host, dev or None, top


def profile_decode_step(im, dec, paged: bool, card: str, reps: int = 5):
    """A steady decode step with every slot live at half the pool (512
    positions, kv bucket 512), the argmax copied to the host as the engine
    does; and one prefill (contiguous: a 512-token prompt; paged: a
    256-token chunk after a 256-token context). Idle share = 1 - device ms
    / host ms."""
    e = GEN_ENGINE
    S, bl = e["slots"], GEN_PAGED["block_len"]
    table_len = e["max_kv_len"] // bl
    bucket = e["max_kv_len"] // 2
    tokens = np.arange(S, dtype=np.int32) % GEN_CFG["vocab"]
    pos = np.full(S, bucket - 1, np.int32)
    # the pools warmup captured the programs on (no engine holds them
    # now): the calls replay them
    owner = _PoolOwner()
    if paged:
        kv = im.serving_kv(dec.init_kv_blocks, owner, paged=True)(
            S * table_len + 1, bl)
        tables = (1 + np.arange(S * table_len, dtype=np.int32)).reshape(
            S, table_len)
        chunk = tokens[:1].repeat(bucket // 2)

        def step():
            _, logits = im.generative_step_paged(kv, tokens, pos, tables,
                                                 bucket)
            return logits.argmax(dim=-1).cpu()

        def prefill():
            _, logits = im.generative_prefill_paged(
                kv, chunk, tables[0], bucket // 2, bucket // 2, bucket // 2)
            return int(torch.argmax(logits))
    else:
        kv = im.serving_kv(dec.init_kv, owner)(S, e["max_kv_len"])
        prompt = tokens[:1].repeat(bucket)

        def step():
            _, logits = im.generative_step(kv, tokens, pos, bucket)
            return logits.argmax(dim=-1).cpu()

        def prefill():
            _, logits = im.generative_prefill(kv, prompt, bucket, 0)
            return int(torch.argmax(logits))
    def mode_calls(top):
        """Decode kernels of this mode a step (None if another mode's
        ran)."""
        attn = [r for r in top if "decode_attention" in r["kernel"]]
        if any((", true>" in r["kernel"]) != paged for r in attn):
            return None
        return sum(r["calls"] for r in attn)

    eager0 = dict(im.gen_eager_calls)
    step_ms, dev_ms, top = host_and_device_ms(
        step, reps, mode_calls, float(GEN_CFG["n_layers"]))
    pre_ms, pre_dev_ms, pre_top = host_and_device_ms(prefill, reps)
    im.release_kv(owner)
    graphed = im.compile_cache_size() > 0
    if graphed and im.gen_eager_calls != eager0:
        raise SystemExit(f"chip_smoke: profiled decode calls ran eagerly: "
                         f"{eager0} -> {im.gen_eager_calls}")
    attn = [r for r in top if "decode_attention" in r["kernel"]]
    row = {"phase": "generative_profile",
           "mode": "paged" if paged else "contiguous", "kv_bucket": bucket,
           "live_positions": bucket, "slots": S, "step_ms": step_ms,
           "device_ms_per_step": dev_ms,
           "idle_share": 1.0 - dev_ms / step_ms if dev_ms else None,
           "decode_attention_device_ms": sum(r["ms"] for r in attn),
           "decode_attention_calls": sum(r["calls"] for r in attn),
           "graphed": graphed,
           "top": top[:10], "prefill_ms": pre_ms,
           "prefill_device_ms": pre_dev_ms,
           "prefill_idle_share":
               1.0 - pre_dev_ms / pre_ms if pre_dev_ms else None,
           "prefill_top": pre_top[:5], "card": card}
    emit(row)
    del kv
    torch.cuda.empty_cache()
    # the decode kernel of this mode, 12 a step by the profiler's count
    if mode_calls(top) != GEN_CFG["n_layers"]:
        raise SystemExit(f"chip_smoke: the profiler saw {attn} decode "
                         f"kernels a {row['mode']} step, expected "
                         f"{GEN_CFG['n_layers']} of this mode")
    return row


class _PoolOwner:
    """What holds a model's warmed KV pool outside an engine."""


# ---------------------------------------------------------------------------
# image classification: ResNet-50 served and trained, Inception-v1's Dropout
# ---------------------------------------------------------------------------
# `examples/inception_imagenet.py:145-165`'s ImageNet setting: ResNet-50 at
# 224×224, 1000 classes, batch 256, "adam", mixed precision.
IMG_SHAPE = (224, 224, 3)
IMG_CLASSES = 1000
IMG_BATCHES = (1, 8, 32, 128)
IMG_REQUESTS = 20
IMG_DISTINCT = 4            # request arrays per batch, cycled
IMG_PROFILE_BATCH = 32
IMG_CALIBRATION = 32
IMG_CHECK_ROWS = 3
# Softmax probabilities over 1000 classes. f32, the card against the port's
# CPU run of the same weights: 53 convolutions summed in cuDNN's order (TF32
# off) instead of the CPU's — 5e-4, as for BERT's logits. bf16 against the
# f32 card: every weight and activation rounds to 8 bits of mantissa through
# 53 convolutions and BatchNorms — 5e-2.
IMG_PROB_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
IMG_TRAIN_BATCH = 256
IMG_TRAIN_STEPS = 8
IMG_WARM_STEPS = 2
IMG_PROFILE_STEPS = 2
# The kernel path (fused Adam) against the plain path (plain Adam): 3 steps
# on one batch of 64 from the same weights, cuDNN deterministic, Adam at lr
# 1e-4. The two optimizers round differently (the kernel folds the bias
# correction into its scalars), so from the second step the runs start
# from parameters a few ulps apart. Adam's m/√v maps such a difference in a
# near-zero gradient onto a step of up to ±lr, ReLUs, max pools and 53
# BatchNorms pass it on, and under bf16 a master an ulp across a rounding
# midpoint moves its bf16 cast by 2^-8. The same run measures that floor:
# the plain path again from the weights one ulp up (`nextafter`). Steps 1
# and 2 (at most one update apart) hold the losses to BERT's tolerances,
# 1e-4 (f32) and 2e-2 (bf16); step 3 to the larger of those and
# IMG_FLOOR_FACTOR times the floor, the largest deviation of the one-ulp
# run over the 3 steps (the two paths' masters differ by up to a few ulps
# after each of two updates, not by one ulp once). Measured on an H100:
# f32 steps 1-2 within 1e-6, step 3 6.9e-4 against a floor of 3.8e-3; bf16
# steps 1-2 equal, step 3 2.1e-2 against a floor of 1.0e-2.
IMG_PATH_BATCH = 64
IMG_PATH_LR = 1e-4
IMG_F32_LOSS_TOL = 1e-4
IMG_BF16_LOSS_TOL = 2e-2
IMG_FLOOR_FACTOR = 3.0
INCEPTION_BATCH = 32
IMG_LOSS = "sparse_categorical_crossentropy"


def op_class(kernel: str) -> str:
    """The op class of a CUDA kernel's name, for the image profiles."""
    n = kernel.lower()
    if "tonchw" in n or "tonhwc" in n:
        return "layout_transpose"
    if "bn_" in n or "batch_norm" in n:
        return "batchnorm"
    if any(k in n for k in ("fprop", "dgrad", "wgrad", "conv", "implicit",
                            "cudnn")):
        return "cudnn_conv"
    if "fused_adam" in n:
        return "fused_adam"
    if "dropout" in n:
        return "dropout"
    if any(k in n for k in ("gemm", "cublas", "cutlass", "nvjet",
                            "splitkreduce")):
        return "dense_gemm"
    if "pool" in n:
        return "pool"
    if "reduce" in n:
        return "reduction"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "elementwise"


def profile_classes(fn, reps: int):
    """Device ms per call by op class and the top kernels, over `reps`
    calls of `fn` under torch.profiler, after one untraced call (the
    schedule's warm-up step: a first traced window over CUDA-graph replays
    can miss their kernels' times; a window that recorded nothing is run
    again)."""
    rows = []
    for _ in range(3):
        rows = _profiled_rows(fn, reps)
        if rows:
            break
    rows.sort(key=lambda r: -r[1])
    dev = sum(r[1] for r in rows)
    classes = {}
    for name, ms, calls in rows:
        c = classes.setdefault(op_class(name), {"ms": 0.0, "calls": 0.0})
        c["ms"] += ms
        c["calls"] += calls
    return dev, dict(sorted(classes.items(), key=lambda kv: -kv[1]["ms"])), [
        {"kernel": name[:96], "ms": ms, "calls": calls}
        for name, ms, calls in rows[:12]]


def image_forward_flops(model) -> float:
    """FLOPs of one image's forward, from the convolution and dense shapes
    of the graph: 2 · output elements · window · input channels / groups a
    convolution, 2 · in · out a dense layer."""
    total = 0.0
    for node in model._order:
        layer = node.layer
        if isinstance(layer, KL._ConvND):
            out, inp = node.shape, node.inputs[0].shape
            tf = layer.dim_ordering == "tf"
            c_in = inp[-1] if tf else inp[1]
            spatial = out[1:-1] if tf else out[2:]
            total += (2.0 * math.prod(spatial) * layer.nb_filter
                      * math.prod(layer.kernel_size) * c_in / layer.groups)
        elif isinstance(layer, KL.Dense):
            total += 2.0 * node.inputs[0].shape[-1] * layer.output_dim
    return total


def calibrate_batchnorm(model, x: torch.Tensor) -> None:
    """Set every BatchNorm's moving statistics to the statistics of batch
    `x` (one training forward at momentum 0; nested models' too), so an
    inference forward of random weights keeps its activations at the
    scale a training forward gives them."""
    bns = [l for l in model.modules()
           if isinstance(l, KL.BatchNormalization)]
    saved = [l.momentum for l in bns]
    for l in bns:
        l.momentum = 0.0
    with torch.no_grad():
        model.apply(x, training=True, seed=0)
    for l, m in zip(bns, saved):
        l.momentum = m


def load_by_order(model, state):
    """A state dict of another instance of the same architecture (layer
    names count per process), matched key by key in graph order."""
    model.load_state_dict(dict(zip(model.state_dict().keys(),
                                   state.values())))
    return model


def phase_image_serving(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    clf = ImageClassifier(depth=50, class_num=IMG_CLASSES,
                          input_shape=IMG_SHAPE)
    model = clf.model
    model.ensure_built(seed=seed)
    # the head N(0, 0.02), as BERT's classifier here: Glorot's limit on a
    # 2048 → 1000 kernel turns random features into logits whose softmax
    # is one-hot, where the bf16 check would compare argmaxes
    head = model.ordered_layers()[-1]
    with torch.no_grad():
        head.kernel.normal_(0.0, 0.02, generator=torch.Generator(
            device="cuda").manual_seed(seed + 69))
    rs = np.random.default_rng(seed + 70)
    calibrate_batchnorm(model, torch.from_numpy(rs.random(
        (IMG_CALIBRATION,) + IMG_SHAPE, dtype=np.float32)).cuda())
    # (a deep copy of the graph would recurse once a node)
    model_bf16 = load_by_order(resnet(50, IMG_CLASSES, IMG_SHAPE),
                               model.state_dict()).to(torch.bfloat16)
    servers = {}
    for dtype_name, m in (("float32", model), ("bfloat16", model_bf16)):
        im = InferenceModel(max_batch=IMG_BATCHES[-1]).load_keras(m)
        if im.serving_dtype != dtype_name:
            raise SystemExit(f"chip_smoke: serving {im.serving_dtype}, "
                             f"expected {dtype_name}")
        im.warmup(np.zeros(IMG_SHAPE, np.float32))
        emit({"phase": "image_warmup", "dtype": dtype_name,
              "buckets": sorted(im.warmed_buckets),
              "seconds": im.warmup_report})
        servers[dtype_name] = im
    bf16_buffers = all(b.dtype == torch.bfloat16
                       for b in model_bf16.buffers())
    emit({"phase": "image_load", "seconds": time.perf_counter() - t0,
          "layers": len(model.ordered_layers()),
          "leaves": len(list(model.parameters())),
          "parameters": sum(p.numel() for p in model.parameters()),
          "moving_stat_values": sum(b.numel() for b in model.buffers()),
          "bf16_buffers": bf16_buffers})
    requests = {b: [rs.random((b,) + IMG_SHAPE, dtype=np.float32)
                    for _ in range(IMG_DISTINCT)] for b in IMG_BATCHES}
    check_x = rs.random((IMG_CHECK_ROWS,) + IMG_SHAPE, dtype=np.float32)
    builds = _build.build_events()

    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    latencies, outputs = {}, {}
    for dtype_name, im in servers.items():
        for b in IMG_BATCHES:
            times = []
            for i in range(IMG_REQUESTS):
                t1 = time.perf_counter()
                out = im.predict(requests[b][i % IMG_DISTINCT])
                times.append((time.perf_counter() - t1) * 1e3)
                if out.shape != (b, IMG_CLASSES) or \
                        not np.isfinite(out).all():
                    raise SystemExit(f"chip_smoke: bad image output "
                                     f"{out.shape} at batch {b}")
            latencies[(dtype_name, b)] = times
        outputs[dtype_name] = im.predict(check_x)
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    builds_after = _build.build_events()
    for (dtype_name, b), times in latencies.items():
        p50 = float(np.percentile(times, 50))
        emit({"phase": "image_serving", "model": "resnet50",
              "dtype": dtype_name, "batch": b, "requests": len(times),
              "p50_ms": p50, "p80_ms": float(np.percentile(times, 80)),
              "p99_ms": float(np.percentile(times, 99)),
              "mean_ms": float(np.mean(times)),
              "images_per_s_at_p50": b / p50 * 1e3, "card": card})
    # no kernel of the port is on this path: convolutions, BatchNorm,
    # pools and the head are cuDNN's and PyTorch's, as they are XLA's in
    # the JAX package
    emit({"phase": "image_serving_launches", "counts": counts,
          "builds_before": builds, "builds_after": builds_after})
    if builds_after != builds or not bf16_buffers:
        raise SystemExit("chip_smoke: a kernel was built on the image "
                         "request path, or bf16 serving kept f32 buffers")
    for dtype_name, im in servers.items():
        x = requests[IMG_PROFILE_BATCH][0]
        p50 = float(np.percentile(latencies[(dtype_name, IMG_PROFILE_BATCH)],
                                  50))
        dev, classes, top = profile_classes(lambda: im.predict(x), 3)
        emit({"phase": "image_profile", "dtype": dtype_name,
              "batch": IMG_PROFILE_BATCH, "device_ms_per_predict": dev,
              "predict_p50_ms": p50,
              "idle_share": (1.0 - dev / p50) if dev else None,
              "by_class": classes, "top": top, "card": card})
    del servers, model_bf16
    torch.cuda.empty_cache()

    cpu_model = load_by_order(resnet(50, IMG_CLASSES, IMG_SHAPE,
                                     device="cpu"), model.state_dict())
    t1 = time.perf_counter()
    cpu_probs = InferenceModel(max_batch=4, device="cpu").load_keras(
        cpu_model).predict(check_x)
    emit({"phase": "image_cpu_reference",
          "seconds": time.perf_counter() - t1})
    check_logits("image_card_f32_vs_cpu_f32", outputs["float32"], cpu_probs,
                 IMG_PROB_TOL["float32"])
    check_logits("image_card_bf16_vs_card_f32", outputs["bfloat16"],
                 outputs["float32"], IMG_PROB_TOL["bfloat16"])
    top1 = [r[0][0] for r in clf.top_n(outputs["float32"], 1)]
    top1_cpu = [r[0][0] for r in clf.top_n(cpu_probs, 1)]
    emit({"phase": "image_top1", "card_f32": top1, "cpu_f32": top1_cpu,
          "same": top1 == top1_cpu})
    del model, cpu_model, clf
    torch.cuda.empty_cache()
    return counts


def image_fit_runs(state, batch, mixed_precision: bool):
    """The kernel path (fused Adam) and the plain path (plain Adam) from
    the same weights over 3 steps of one batch, cuDNN deterministic, and
    the plain path again from the weights one ulp up (`nextafter`): how far
    two runs that differ only in rounding drift apart. {name: (losses,
    moving statistics, launch counts, buffer dtypes)}."""
    runs = {}
    nudged = {k: torch.nextafter(v, torch.full_like(v, math.inf))
              if v.is_floating_point() and "moving" not in k else v
              for k, v in state.items()}
    torch.backends.cudnn.deterministic = True
    try:
        for name, opt, start in (
                ("kernel", optimizers.fused_adam(IMG_PATH_LR), state),
                ("plain", optimizers.adam(IMG_PATH_LR), state),
                ("plain_ulp", optimizers.adam(IMG_PATH_LR), nudged)):
            m = load_by_order(resnet(50, IMG_CLASSES, IMG_SHAPE), start)
            LAUNCHES.reset()
            h = Estimator.from_keras(m, optimizer=opt, loss=IMG_LOSS).fit(
                batch, epochs=3, batch_size=IMG_PATH_BATCH,
                mixed_precision=mixed_precision,
                fused_optimizer=name == "kernel")
            moving = [b.detach().clone() for b in m.buffers()]
            runs[name] = (h["loss"], moving, LAUNCHES.snapshot(),
                          sorted({str(b.dtype)[6:] for b in moving}))
            del m
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    return runs



def phase_image_training(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = resnet(50, IMG_CLASSES, IMG_SHAPE)
    model.ensure_built(seed=seed)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_leaves = len(list(model.parameters()))
    sweep = fad.sweep_launches(model.parameters())
    fwd_flops = image_forward_flops(model)
    flops_step = 3.0 * fwd_flops * IMG_TRAIN_BATCH
    rs = np.random.default_rng(seed + 72)
    n = IMG_TRAIN_BATCH * IMG_TRAIN_STEPS
    t0 = time.perf_counter()
    data = {"x": rs.random((n,) + IMG_SHAPE, dtype=np.float32),
            "y": rs.integers(0, IMG_CLASSES, n).astype(np.int32)}
    data_s = time.perf_counter() - t0
    warm_n = IMG_WARM_STEPS * IMG_TRAIN_BATCH
    est = Estimator.from_keras(model, optimizer="adam", loss=IMG_LOSS)
    fit_kw = dict(epochs=1, batch_size=IMG_TRAIN_BATCH, mixed_precision=True,
                  fused_optimizer=True)
    t0 = time.perf_counter()
    est.fit({"x": data["x"][:warm_n], "y": data["y"][:warm_n]}, **fit_kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    builds = _build.build_events()

    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    fad.GRAD_COPIES.reset()
    t1 = time.perf_counter()
    hist = est.fit(data, **fit_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = LAUNCHES.snapshot()
    grad_copies = fad.GRAD_COPIES.get(fad.KERNEL_NAME)
    # -------------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    builds_after = _build.build_events()
    step_ms = dt / IMG_TRAIN_STEPS * 1e3
    expected = {fad.KERNEL_NAME: sweep}
    per_step = {k: counts.get(k, 0) / IMG_TRAIN_STEPS for k in expected}
    buffers_f32 = all(b.dtype == torch.float32 for b in model.buffers())
    row = {"phase": "image_train", "model": "resnet50",
           "input": list(IMG_SHAPE), "classes": IMG_CLASSES,
           "batch": IMG_TRAIN_BATCH, "steps": IMG_TRAIN_STEPS,
           "data_s": data_s, "warm_fit_s": warm_s, "step_ms": step_ms,
           "images_per_s": n / dt, "forward_flops_per_image": fwd_flops,
           "flops_per_step": flops_step,
           "mfu": flops_step * IMG_TRAIN_STEPS / dt / PEAK_BF16,
           "max_memory_allocated_gb": peak / 1e9, "loss": hist["loss"],
           "launches": counts, "launches_per_step": per_step,
           "expected_per_step": expected, "leaves": n_leaves,
           "grad_layout_copies_per_step": grad_copies / IMG_TRAIN_STEPS,
           "builds_before": builds, "builds_after": builds_after,
           "moving_stats_f32": buffers_f32, "card": card}
    emit(row)
    if per_step != {k: float(v) for k, v in expected.items()}:
        raise SystemExit(f"chip_smoke: image launches per step {per_step}, "
                         f"expected {expected}")
    if builds_after != builds or not buffers_f32 or not all(
            math.isfinite(x) for x in hist["loss"]):
        raise SystemExit("chip_smoke: image training check failed")
    prof_n = IMG_PROFILE_STEPS * IMG_TRAIN_BATCH
    prof_data = {"x": data["x"][:prof_n], "y": data["y"][:prof_n]}
    dev, classes, top = profile_classes(lambda: est.fit(prof_data, **fit_kw),
                                        1)
    dev /= IMG_PROFILE_STEPS
    for c in classes.values():
        c["ms"] /= IMG_PROFILE_STEPS
        c["calls"] /= IMG_PROFILE_STEPS
    emit({"phase": "image_train_profile", "device_ms_per_step": dev,
          "step_ms": step_ms,
          "idle_share": (1.0 - dev / step_ms) if dev else None,
          "by_class": classes, "top": top, "card": card})
    del est, model, data, prof_data
    torch.cuda.empty_cache()

    # -- the kernel path against the plain path, f32 and bf16 --------------
    batch = {"x": rs.random((IMG_PATH_BATCH,) + IMG_SHAPE, dtype=np.float32),
             "y": rs.integers(0, IMG_CLASSES, IMG_PATH_BATCH
                              ).astype(np.int32)}
    ok = True
    for mp, tol in ((False, IMG_F32_LOSS_TOL), (True, IMG_BF16_LOSS_TOL)):
        runs = image_fit_runs(state, batch, mp)
        (lk, mk, ck, dk), (lp, mpl, cp, dp) = runs["kernel"], runs["plain"]
        lu = runs["plain_ulp"][0]
        errs = [abs(a - b) for a, b in zip(lk, lp)]
        floor = max(abs(a - b) for a, b in zip(lu, lp))
        last_tol = max(tol, IMG_FLOOR_FACTOR * floor)
        moving_err = max((a - b).abs().max().item()
                         for a, b in zip(mk, mpl))
        path_ok = (all(e <= tol for e in errs[:2]) and errs[2] <= last_tol
                   and all(math.isfinite(x) for x in lk + lp + lu)
                   and ck.get(fad.KERNEL_NAME, 0) == 3 * sweep
                   and cp.get(fad.KERNEL_NAME, 0) == 0
                   and dk == dp == ["float32"])
        emit({"phase": "image_train_kernel_vs_plain",
              "dtype": "bfloat16" if mp else "float32", "steps": 3,
              "batch": IMG_PATH_BATCH, "lr": IMG_PATH_LR,
              "loss_kernel": lk, "loss_plain": lp, "loss_plain_ulp": lu,
              "loss_err_per_step": errs, "loss_tol_steps_1_2": tol,
              "rounding_floor": floor, "loss_tol_step_3": last_tol,
              "moving_stats_max_abs_diff": moving_err,
              "moving_stat_dtypes": dk, "launches_kernel_path": ck,
              "launches_plain_path": cp, "ok": path_ok, "card": card})
        ok = ok and path_ok
    if not ok:
        raise SystemExit("chip_smoke: image kernel-vs-plain check failed")
    return counts


def phase_image_dropout(card: str, seed: int):
    """One Inception-v1 training step (batch 32, bf16, fused Adam): its
    `Dropout` layer launches the dropout kernel once forward and once
    backward; the kernel checked at that shape against its plain
    version."""
    model = inception_v1(IMG_CLASSES, IMG_SHAPE)
    model.ensure_built(seed=seed)
    sweep = fad.sweep_launches(model.parameters())
    rs = np.random.default_rng(seed + 73)
    data = {"x": rs.random((INCEPTION_BATCH,) + IMG_SHAPE, dtype=np.float32),
            "y": rs.integers(0, IMG_CLASSES, INCEPTION_BATCH
                             ).astype(np.int32)}
    est = Estimator.from_keras(model, optimizer="adam", loss=IMG_LOSS)
    fit_kw = dict(epochs=1, batch_size=INCEPTION_BATCH, mixed_precision=True,
                  fused_optimizer=True)
    est.fit(data, **fit_kw)                        # warm
    torch.cuda.synchronize()
    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    t0 = time.perf_counter()
    hist = est.fit(data, **fit_kw)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    expected = {dr.KERNEL_NAME: 2, fad.KERNEL_NAME: sweep}
    node = next(n for n in model._order if isinstance(n.layer, KL.Dropout))
    drop = node.layer
    shape = (INCEPTION_BATCH, node.inputs[0].shape[-1])
    checks = {}
    gen = torch.Generator(device="cuda").manual_seed(seed + 74)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        got = dr.dropout_apply(x, drop.rate, seed + 75)
        want = dr._reference_dropout(x, drop.rate, dr.dropout_keep(
            shape, seed + 75, drop.rate, "cuda"))
        checks[str(dtype)[6:]] = (got.float() - want.float()).abs().max(
        ).item()
    ok = ({k: counts.get(k, 0) for k in expected} == expected
          and all(v == 0.0 for v in checks.values())
          and all(math.isfinite(x) for x in hist["loss"]))
    emit({"phase": "image_dropout", "model": "inception_v1",
          "batch": INCEPTION_BATCH, "rate": drop.rate, "step_ms": step_ms,
          "launches": counts, "expected": expected,
          "dropout_shape": list(shape), "max_abs_err_vs_plain": checks,
          "loss": hist["loss"], "ok": ok, "card": card})
    del est, model
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("chip_smoke: Inception-v1 Dropout check failed")
    return counts


# ---------------------------------------------------------------------------
# recurrent models: TextClassifier (news20), AnomalyDetector (NYC taxi),
# SessionRecommender
# ---------------------------------------------------------------------------
# TextClassifier at the news20 example's widths
# (`pyzoo/zoo/examples/textclassification/`, the JAX defaults
# sequence_length=500, encoder_output_dim=256): 20 classes, 5,000 words and
# the padding row through `WordEmbedding` of a random [5001, 200] matrix in
# place of GloVe-200d, batch 128.
TXT_CLASSES = 20
TXT_WORDS = 5000
TXT_EMBED = 200
TXT_SEQ = 500
TXT_HIDDEN = 256
TXT_HEAD = 128
TXT_BATCH = 128
TXT_TRAIN_STEPS = 8
TXT_PROFILE_STEPS = 2
TXT_SERVE_BATCHES = (1, 8, 32, 128)
TXT_REQUESTS = 20
TXT_CHECK_ROWS = 3
# Softmax probabilities over 20 classes. f32, the card against the port's
# CPU run of the same weights: 500 recurrent steps of cuBLAS sums in
# another order than the CPU's (TF32 off) — 5e-4, as for BERT and ResNet-50.
# bf16 against the f32 card: h and c round to bf16 at each of the 500
# steps, as in the JAX package — 5e-2.
TXT_PROB_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
# The kernel path (dropout kernel, fused Adam) against the plain path
# (dropout's plain version on the same Philox keep masks, plain Adam): 3
# steps on one batch from the same weights, Adam at lr 1e-4, losses within
# PERF.md §2's 1e-4 (f32) and 2e-2 (bf16).
RNN_PATH_LR = 1e-4
RNN_PATH_TOL = {False: 1e-4, True: 2e-2}       # keyed by mixed precision
# the kernel path's 3-step parameter update against the plain path's
# (`update_errors`), keyed by mixed precision: BERT's f32 path gave
# 1.65e-4 against its 1e-2 (F32_UPDATE_REL) on an H100 80GB HBM3 at
# 700 W; under bf16 the forward rounds
# the masters, so an ulp of difference between the two Adams can flip a
# bf16 weight and the next gradient; a sweep that did nothing scores 1
RNN_UPDATE_TOL = {False: 1e-2, True: 5e-2}
RNN_LOSS = "sparse_categorical_crossentropy"
# AnomalyDetector at the JAX defaults (hidden (8, 32, 15), dropouts 0.2)
# on the reference NYC-taxi app's input (`apps/anomaly-detection/`: 50
# steps of 3 features, batch 1024), "adam", "mse", f32.
AD_SHAPE = (50, 3)
AD_BATCH = 1024
AD_TRAIN_STEPS = 8
AD_PROFILE_STEPS = 2
AD_REQUESTS = 20
AD_SERVE_MAX_BATCH = 512    # a batch of 1024 goes out as two, both in flight
AD_SPIKES = 12
AD_SPIKE = 5.0
AD_CHECK_ROWS = 64
# The regression output, the card against the CPU: 5e-4 of the largest
# magnitude (three LSTMs of 50 steps, summed in another order).
AD_REL_TOL = 5e-4
# SessionRecommender: the default widths, session_length 10, item_count
# 5,000 (chosen here: no published configuration gives them). A check: the
# card's f32 softmax over 5,000 items against the CPU's, 5e-4 of the
# largest probability (each is ~2e-4, so an absolute 5e-4 would hold
# anything).
SR_CFG = dict(item_count=5000, item_embed=100, rnn_hidden_layers=(40, 20),
              session_length=10)
SR_ROWS = 64
SR_REL_TOL = 5e-4
RNN_YARDSTICK_LABEL = ("sigmoid gates / reset-after: a different function, "
                       "never called by the port")


def plain_dropout(x, rate, *, seed=None):
    """`fused_dropout`'s function through the plain version, on the keep
    mask the kernel draws from the same Philox bits: the plain path's
    stand-in for the `Dropout` layers."""
    if rate <= 0.0:
        return x
    return dr._reference_dropout(x, rate, dr.dropout_keep(
        x.shape, seed, rate, x.device))


@contextlib.contextmanager
def plain_dropout_layers():
    saved = KL.fused_dropout
    KL.fused_dropout = plain_dropout
    try:
        yield
    finally:
        KL.fused_dropout = saved


def rnn_fit_runs(new_model, state, data, batch: int, loss,
                 mixed_precision: bool, lr: float = RNN_PATH_LR,
                 weight_decay: float = 0.0):
    """The kernel path and the plain path from the same weights over 3
    steps of one batch: {name: (losses, launch counts, the parameters
    after, in graph order)} and, under "initial", the parameters before.
    The kernel path steps fused Adam, the plain path Adam (AdamW with a
    `weight_decay`) at `lr`."""
    runs = {}
    for name in ("kernel", "plain"):
        m = load_by_order(new_model(), state)
        runs["initial"] = [p.detach().clone() for p in m.parameters()]
        kernel = name == "kernel"
        if kernel:
            opt = optimizers.fused_adam(lr, weight_decay=weight_decay)
        elif weight_decay:
            opt = optimizers.adamw(lr, weight_decay=weight_decay)
        else:
            opt = optimizers.adam(lr)
        LAUNCHES.reset()
        with contextlib.nullcontext() if kernel else plain_dropout_layers():
            h = Estimator.from_keras(m, optimizer=opt, loss=loss).fit(
                data, epochs=3, batch_size=batch,
                mixed_precision=mixed_precision, fused_optimizer=kernel)
        runs[name] = (h["loss"], LAUNCHES.snapshot(),
                      [p.detach().clone() for p in m.parameters()])
        del m
    torch.cuda.empty_cache()
    return runs


def update_errors(initial, kernel, plain) -> dict:
    """How far the kernel path's 3-step parameter update lies from the
    plain path's: the L2 norm of the difference over the plain update's,
    over all leaves and at the worst leaf that moved. A sweep that left
    the parameters as they were scores 1."""
    num = den = 0.0
    worst = 0.0
    for p0, pk, pp in zip(initial, kernel, plain):
        d = float(((pk - pp).double() ** 2).sum())
        u = float(((pp - p0).double() ** 2).sum())
        num, den = num + d, den + u
        if u > 0.0:
            worst = max(worst, math.sqrt(d / u))
    return {"update_rel_l2_err": math.sqrt(num / den) if den else None,
            "update_rel_l2_err_worst_leaf": worst,
            "plain_update_l2": math.sqrt(den),
            "param_max_abs_err": max((pk - pp).abs().max().item()
                                     for pk, pp in zip(kernel, plain)
                                     if pk.numel())}


def rnn_path_checks(phase: str, new_model, state, data, batch: int,
                    loss, sweep: int, drops: int, dtypes, card: str,
                    **run_kw):
    """`rnn_fit_runs` in each dtype: losses within RNN_PATH_TOL, the 3-step
    parameter update within RNN_UPDATE_TOL of the plain path's, the kernel
    path launching `drops` dropout kernels and `sweep` fused-Adam launches
    a step, the plain path none; and the sweep bit-exact at the path's own
    leaves (`sweep_exact_at`). `run_kw`: `rnn_fit_runs`'s `lr` and
    `weight_decay`."""
    ok = True
    for mp in dtypes:
        runs = rnn_fit_runs(new_model, state, data, batch, loss, mp,
                            **run_kw)
        (lk, ck, pk), (lp, cp, pp) = runs["kernel"], runs["plain"]
        errs = [abs(a - b) for a, b in zip(lk, lp)]
        want = {dr.KERNEL_NAME: 3 * drops, fad.KERNEL_NAME: 3 * sweep}
        upd = update_errors(runs["initial"], pk, pp)
        exact = sweep_exact_at(pk, torch.Generator(
            device="cuda").manual_seed(0))
        path_ok = (all(e <= RNN_PATH_TOL[mp] for e in errs)
                   and all(math.isfinite(x) for x in lk + lp)
                   and upd["update_rel_l2_err"] is not None
                   and upd["update_rel_l2_err"] <= RNN_UPDATE_TOL[mp]
                   and exact["ok"]
                   and {k: ck.get(k, 0) for k in want} == want
                   and not any(cp.get(k, 0) for k in want))
        emit({"phase": phase + "_kernel_vs_plain",
              "dtype": "bfloat16" if mp else "float32", "steps": 3,
              "batch": batch, "lr": run_kw.get("lr", RNN_PATH_LR),
              "weight_decay": run_kw.get("weight_decay", 0.0),
              "loss_kernel": lk,
              "loss_plain": lp, "loss_err_per_step": errs,
              "loss_tol": RNN_PATH_TOL[mp],
              "loss_drop_steps_1_3": lp[0] - lp[-1], **upd,
              "update_tol": RNN_UPDATE_TOL[mp],
              "sweep_at_path_leaves": exact, "launches_kernel_path": ck,
              "launches_plain_path": cp, "expected_kernel_path": want,
              "ok": path_ok, "card": card})
        ok = ok and path_ok
        del runs, pk, pp
    if not ok:
        raise SystemExit(f"chip_smoke: {phase} kernel-vs-plain check failed")


def dropout_at(shape, dtype, rate: float, seed: int) -> float:
    """The dropout kernel at one of the path's shapes against its plain
    version on the same keep mask: the max abs difference (0 expected)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    got = dr.dropout_apply(x, rate, seed + 1)
    want = dr._reference_dropout(x, rate, dr.dropout_keep(
        shape, seed + 1, rate, "cuda"))
    return (got.float() - want.float()).abs().max().item()


def text_model(encoder: str, matrix, device=None):
    return TextClassifier(TXT_CLASSES, sequence_length=TXT_SEQ,
                          encoder=encoder, encoder_output_dim=TXT_HIDDEN,
                          embedding_weights=matrix, device=device)


def text_forward_flops(encoder: str) -> float:
    """FLOPs of one sequence's forward, from the shapes: the input GEMM
    2·T·E·n·H, the recurrent GEMM 2·T·H·n·H (n gates: 4 LSTM, 3 GRU) and
    the head 2·H·128 + 2·128·classes; the gate math and the lookup are
    left out."""
    n = {"lstm": 4, "gru": 3}[encoder]
    return (2.0 * TXT_SEQ * (TXT_EMBED + TXT_HIDDEN) * n * TXT_HIDDEN
            + 2.0 * TXT_HIDDEN * TXT_HEAD + 2.0 * TXT_HEAD * TXT_CLASSES)


def text_matrix(seed: int) -> np.ndarray:
    """A random [5001, 200] matrix in GloVe-200d's place (its entries'
    scale, ~0.4)."""
    rs = np.random.default_rng(seed)
    return rs.standard_normal((TXT_WORDS + 1, TXT_EMBED),
                              dtype=np.float32) * 0.4


def profile_fit_by_class(est, data, fit_kw, steps: int):
    """Device ms a step, device ops a step, by op class and the top
    kernels, over a profiled fit of `steps` steps."""
    dev, classes, top = profile_classes(lambda: est.fit(data, **fit_kw), 1)
    for c in list(classes.values()) + top:
        c["ms"] /= steps
        c["calls"] /= steps
    ops = sum(c["calls"] for c in classes.values())
    return dev / steps, ops, classes, top


def phase_text_training(card: str, seed: int, encoder: str):
    """TextClassifier (`encoder` lstm or gru) trained through
    `Estimator.fit(mixed_precision=True, fused_optimizer=True)` at batch
    128: the main path, its profile, and the kernel path against the plain
    path in f32 and bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    matrix = text_matrix(seed + 80)
    clf = text_model(encoder, matrix)
    model = clf.model
    model.ensure_built(seed=seed)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    table = model.layers[0].embeddings.detach().clone()
    n_leaves = len(list(model.parameters()))
    sweep = fad.sweep_launches(model.parameters())
    rs = np.random.default_rng(seed + 81)
    n = TXT_BATCH * TXT_TRAIN_STEPS
    data = {"x": rs.integers(0, TXT_WORDS + 1, (n, TXT_SEQ)).astype(np.int32),
            "y": rs.integers(0, TXT_CLASSES, n).astype(np.int32)}
    est = Estimator.from_keras(model, optimizer="adam", loss=RNN_LOSS)
    fit_kw = dict(epochs=1, batch_size=TXT_BATCH, mixed_precision=True,
                  fused_optimizer=True)
    # the warm fit runs the timed fit's data: a device-resident fit's
    # programs gather from its data's buffers, so the timed fit replays
    t0 = time.perf_counter()
    est.fit(data, **fit_kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    builds = _build.build_events()

    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    t1 = time.perf_counter()
    hist = est.fit(data, **fit_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    builds_after = _build.build_events()
    step_ms = dt / TXT_TRAIN_STEPS * 1e3
    expected = {dr.KERNEL_NAME: 2, fad.KERNEL_NAME: sweep}
    per_step = {k: counts.get(k, 0) / TXT_TRAIN_STEPS for k in expected}
    flops_step = 3.0 * text_forward_flops(encoder) * TXT_BATCH
    table_same = torch.equal(model.layers[0].embeddings.detach(), table)
    emit({"phase": "text_train", "encoder": encoder, "batch": TXT_BATCH,
          "seq": TXT_SEQ, "hidden": TXT_HIDDEN, "embed": TXT_EMBED,
          "classes": TXT_CLASSES, "steps": TXT_TRAIN_STEPS,
          "warm_fit_s": warm_s, "step_ms": step_ms,
          "samples_per_s": n / dt, "tokens_per_s": n * TXT_SEQ / dt,
          "flops_per_step": flops_step,
          "mfu": flops_step * TXT_TRAIN_STEPS / dt / PEAK_BF16,
          "max_memory_allocated_gb": peak / 1e9, "loss": hist["loss"],
          "launches": counts, "launches_per_step": per_step,
          "expected_per_step": expected, "leaves": n_leaves,
          "frozen_table_unchanged": table_same, "builds_before": builds,
          "builds_after": builds_after, "card": card})
    if per_step != {k: float(v) for k, v in expected.items()}:
        raise SystemExit(f"chip_smoke: text {encoder} launches per step "
                         f"{per_step}, expected {expected}")
    if builds_after != builds or not table_same or not all(
            math.isfinite(x) for x in hist["loss"]):
        raise SystemExit(f"chip_smoke: text {encoder} training check failed")
    prof_n = TXT_PROFILE_STEPS * TXT_BATCH
    dev, ops, classes, top = profile_fit_by_class(
        est, {"x": data["x"][:prof_n], "y": data["y"][:prof_n]}, fit_kw,
        TXT_PROFILE_STEPS)
    emit({"phase": "text_train_profile", "encoder": encoder,
          "device_ms_per_step": dev, "device_ops_per_step": ops,
          "step_ms": step_ms, "idle_share": (1.0 - dev / step_ms)
          if dev else None, "by_class": classes, "top": top, "card": card})
    del est, model, clf
    torch.cuda.empty_cache()

    batch = {"x": data["x"][:TXT_BATCH], "y": data["y"][:TXT_BATCH]}
    rnn_path_checks("text_" + encoder,
                    lambda: text_model(encoder, matrix).model, state, batch,
                    TXT_BATCH, RNN_LOSS, sweep, 2, (False, True), card)
    drop_err = dropout_at((TXT_BATCH, TXT_HEAD), torch.bfloat16, 0.2,
                          seed + 82)
    emit({"phase": "text_dropout_shape", "encoder": encoder,
          "shape": [TXT_BATCH, TXT_HEAD], "dtype": "bfloat16",
          "max_abs_err_vs_plain": drop_err, "ok": drop_err == 0.0})
    if drop_err != 0.0:
        raise SystemExit("chip_smoke: dropout kernel at the text shape")
    return {"counts": counts, "step_ms": step_ms, "device_ms": dev,
            "device_ops": ops}


def phase_text_serving(card: str, seed: int):
    """TextClassifier (lstm, gru, cnn) through `InferenceModel`, f32 and
    bf16, at batches 1, 8, 32 and 128; probabilities against the port's
    CPU run. Warmup captures the buckets the requests use (and the check's
    rows'), not all eight up to 128: cut to pay for the text zoo phase."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    matrix = text_matrix(seed + 83)
    rs = np.random.default_rng(seed + 84)
    requests = {b: rs.integers(0, TXT_WORDS + 1, (b, TXT_SEQ)).astype(
        np.int32) for b in TXT_SERVE_BATCHES}
    check_x = requests[TXT_SERVE_BATCHES[-1]][:TXT_CHECK_ROWS]
    result = {}
    for encoder in ("lstm", "gru", "cnn"):
        clf = text_model(encoder, matrix)
        model = clf.model
        model.ensure_built(seed=seed)
        m16 = load_by_order(text_model(encoder, matrix).model,
                            model.state_dict()).to(torch.bfloat16)
        servers = {}
        for dtype_name, m in (("float32", model), ("bfloat16", m16)):
            im = InferenceModel(max_batch=TXT_SERVE_BATCHES[-1]).load_keras(m)
            t0 = time.perf_counter()
            im.warmup(np.zeros((TXT_SEQ,), np.int32), buckets=sorted(
                set(TXT_SERVE_BATCHES)
                | {_next_bucket(TXT_CHECK_ROWS, im.buckets)}))
            emit({"phase": "text_warmup", "encoder": encoder,
                  "dtype": dtype_name, "seconds": time.perf_counter() - t0,
                  "buckets": sorted(im.warmed_buckets)})
            servers[dtype_name] = im
        builds = _build.build_events()

        # -- the main path: every count is 0 just before, read just after -
        LAUNCHES.reset()
        latencies, outputs = {}, {}
        for dtype_name, im in servers.items():
            for b in TXT_SERVE_BATCHES:
                times = []
                for _ in range(TXT_REQUESTS):
                    t1 = time.perf_counter()
                    out = im.predict(requests[b])
                    times.append((time.perf_counter() - t1) * 1e3)
                    if out.shape != (b, TXT_CLASSES) or \
                            not np.isfinite(out).all():
                        raise SystemExit(f"chip_smoke: bad text output "
                                         f"{out.shape} at batch {b}")
                latencies[(dtype_name, b)] = times
            outputs[dtype_name] = im.predict(check_x)
        counts = LAUNCHES.snapshot()
        # ---------------------------------------------------------------------
        builds_after = _build.build_events()
        for (dtype_name, b), times in latencies.items():
            p50 = float(np.percentile(times, 50))
            emit({"phase": "text_serving", "encoder": encoder,
                  "dtype": dtype_name, "batch": b, "requests": len(times),
                  "p50_ms": p50, "p80_ms": float(np.percentile(times, 80)),
                  "p99_ms": float(np.percentile(times, 99)),
                  "mean_ms": float(np.mean(times)),
                  "sequences_per_s_at_p50": b / p50 * 1e3, "card": card})
        # inference runs no dropout and no optimizer: no kernel of the port
        emit({"phase": "text_serving_launches", "encoder": encoder,
              "counts": counts, "builds_before": builds,
              "builds_after": builds_after})
        if builds_after != builds:
            raise SystemExit("chip_smoke: a kernel was built on the text "
                             "request path")
        del servers, m16
        cpu = load_by_order(text_model(encoder, matrix, device="cpu").model,
                            model.state_dict())
        cpu_probs = InferenceModel(max_batch=4, device="cpu").load_keras(
            cpu).predict(check_x)
        check_logits(f"text_{encoder}_card_f32_vs_cpu_f32",
                     outputs["float32"], cpu_probs, TXT_PROB_TOL["float32"])
        check_logits(f"text_{encoder}_card_bf16_vs_card_f32",
                     outputs["bfloat16"], outputs["float32"],
                     TXT_PROB_TOL["bfloat16"])
        result[encoder] = {
            f"{d}_b{b}": float(np.percentile(t, 50))
            for (d, b), t in latencies.items()}
        del model, clf, cpu
        torch.cuda.empty_cache()
    return result


def recurrent_yardstick(card: str, seed: int):
    """The port's LSTM and GRU layers beside cuDNN's `nn.LSTM` / `nn.GRU`
    at TextClassifier's shapes (B 128, T 500, E 200, H 256), forward and
    forward + backward, f32 (TF32 off) and bf16. cuDNN computes sigmoid
    gates and the reset-after GRU: a different function, timed here as a
    yardstick and never called by the port. Times by CUDA events (the
    port's loop is host-bound, so its events read the wall) and the
    port's device time under torch.profiler; the bound counts the input
    and recurrent GEMMs (backward 2x the forward). The port's host-bound
    loop is timed over one call after one warm call (cut from 3 and 3 to
    pay for the distributed phase; a call took 54-533 ms on an NVIDIA
    H100 80GB HBM3 at 700 W). bf16 only, the recurrent phases' training
    dtype: the f32 rows (26 s of the 52.2) went to pay for the text zoo
    phase, and so did the forward's device time (each profiled window of
    the 500-step loop cost ~9 s of host time on the same card); the
    forward + backward's device time, profiled right after its timed
    call, shows the loop host-bound."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, T, E, H = TXT_BATCH, TXT_SEQ, TXT_EMBED, TXT_HIDDEN
    gen = torch.Generator(device="cuda").manual_seed(seed + 85)
    rows = []
    for cell, n, port_cls, lib_cls in (("lstm", 4, KL.LSTM, torch.nn.LSTM),
                                       ("gru", 3, KL.GRU, torch.nn.GRU)):
        for dtype in (torch.bfloat16,):
            layer = port_cls(H, input_shape=(T, E), dtype=dtype)
            layer.build(torch.Generator().manual_seed(seed))
            lib = lib_cls(E, H, batch_first=True).to("cuda", dtype)
            lib.flatten_parameters()
            x = torch.randn(B, T, E, device="cuda", generator=gen).to(dtype)

            def port_fwd():
                with torch.no_grad():
                    layer(x)

            def port_fwd_bwd():
                layer(x).float().sum().backward()

            def lib_fwd():
                with torch.no_grad():
                    lib(x)

            def lib_fwd_bwd():
                lib(x)[0][:, -1].float().sum().backward()

            flops = 2.0 * B * T * (E + H) * n * H
            nbytes = (B * T * E + (E + H + 1) * n * H + B * H) * \
                (torch.finfo(dtype).bits // 8)
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            t_mem = nbytes / MEM_BYTES_PER_S * 1e3
            row = {"phase": "recurrent_yardstick", "label":
                   RNN_YARDSTICK_LABEL, "cell": cell,
                   "dtype": str(dtype)[6:], "shape": [B, T, E, H],
                   "port_fwd_ms": time_ms(port_fwd, 1, warm=1),
                   "port_fwd_bwd_ms": time_ms(port_fwd_bwd, 1, warm=1),
                   "port_fwd_bwd_device_ms": device_ms(port_fwd_bwd, 1,
                                                       warm=0)[0],
                   "library": f"torch.nn.{lib_cls.__name__}",
                   "library_on_cudnn": torch.backends.cudnn.is_acceptable(x),
                   "library_fwd_ms": time_ms(lib_fwd, 10),
                   "library_fwd_bwd_ms": time_ms(lib_fwd_bwd, 10),
                   "bound_fwd_ms": max(t_ops, t_mem),
                   "bound_fwd_bwd_ms": max(3 * t_ops, t_mem),
                   "bound_by": "operations" if t_ops >= t_mem else "bytes",
                   "card": card}
            emit(row)
            rows.append(row)
            del layer, lib, x
    torch.cuda.empty_cache()
    return rows


def anomaly_series(rs, n_points: int):
    """A seeded stand-in for the NYC-taxi series: a daily and a weekly
    cycle (half-hourly) with noise on 3 features, and AD_SPIKES spikes of
    +AD_SPIKE on the first, placed after the first window. Returns the
    series and the spikes' indices into `unroll`'s targets."""
    t = np.arange(n_points)
    day, week = 2 * np.pi * t / 48.0, 2 * np.pi * t / 336.0
    series = np.stack([np.sin(day) + 0.5 * np.sin(week), np.cos(day),
                       np.sin(week)], axis=1)
    series = series + 0.05 * rs.standard_normal(series.shape)
    at = np.sort(rs.choice(np.arange(AD_SHAPE[0], n_points),
                           AD_SPIKES, replace=False))
    series[at, 0] += AD_SPIKE
    return series.astype(np.float32), at - AD_SHAPE[0]


def phase_anomaly(card: str, seed: int):
    """AnomalyDetector at the JAX defaults trained through
    `Estimator.fit(fused_optimizer=True)` at batch 1024 on windows of a
    seeded series (`unroll`), served through `InferenceModel`, its
    predictions through `detect_anomalies`; the card against the CPU and
    the kernel path against the plain path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.default_rng(seed + 90)
    n = AD_BATCH * AD_TRAIN_STEPS
    series, targets = anomaly_series(rs, n + AD_SHAPE[0])
    x, y = unroll(series, AD_SHAPE[0])
    ad = AnomalyDetector(AD_SHAPE)
    model = ad.model
    model.ensure_built(seed=seed)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sweep = fad.sweep_launches(model.parameters())
    est = Estimator.from_keras(model, optimizer="adam", loss="mse")
    fit_kw = dict(epochs=1, batch_size=AD_BATCH, fused_optimizer=True)
    # the warm fit runs the timed fit's data (device-resident: its
    # programs gather from that data's buffers)
    est.fit({"x": x, "y": y}, **fit_kw)
    torch.cuda.synchronize()
    builds = _build.build_events()

    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    t0 = time.perf_counter()
    hist = est.fit({"x": x, "y": y}, **fit_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    builds_after = _build.build_events()
    step_ms = dt / AD_TRAIN_STEPS * 1e3
    drops = 2 * len(ad.dropouts)
    expected = {dr.KERNEL_NAME: drops, fad.KERNEL_NAME: sweep}
    per_step = {k: counts.get(k, 0) / AD_TRAIN_STEPS for k in expected}
    prof_n = AD_PROFILE_STEPS * AD_BATCH
    dev, ops, classes, top = profile_fit_by_class(
        est, {"x": x[:prof_n], "y": y[:prof_n]}, fit_kw, AD_PROFILE_STEPS)
    emit({"phase": "anomaly_train", "input": list(AD_SHAPE),
          "hidden": ad.hidden_layers, "dropouts": ad.dropouts,
          "batch": AD_BATCH, "steps": AD_TRAIN_STEPS, "step_ms": step_ms,
          "samples_per_s": n / dt, "loss": hist["loss"],
          "device_ms_per_step": dev, "device_ops_per_step": ops,
          "idle_share": (1.0 - dev / step_ms) if dev else None,
          "by_class": classes, "top": top[:6], "launches": counts,
          "launches_per_step": per_step, "expected_per_step": expected,
          "leaves": len(list(model.parameters())), "builds_before": builds,
          "builds_after": builds_after, "card": card})
    if per_step != {k: float(v) for k, v in expected.items()} or \
            builds_after != builds or \
            not all(math.isfinite(v) for v in hist["loss"]):
        raise SystemExit("chip_smoke: anomaly training check failed")

    im = InferenceModel(max_batch=AD_SERVE_MAX_BATCH).load_keras(model)
    im.warmup(np.zeros(AD_SHAPE, np.float32))
    builds = _build.build_events()
    request = x[:AD_BATCH]
    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    times = []
    for _ in range(AD_REQUESTS):
        t1 = time.perf_counter()
        out = im.predict(request)
        times.append((time.perf_counter() - t1) * 1e3)
    pred = im.predict(x)
    serve_counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    found = detect_anomalies(y, pred, AD_SPIKES)
    recall = len(set(found.tolist()) & set(targets.tolist())) / AD_SPIKES
    cpu = load_by_order(AnomalyDetector(AD_SHAPE, device="cpu").model,
                        model.state_dict())
    check = x[:AD_CHECK_ROWS]
    want = InferenceModel(max_batch=AD_CHECK_ROWS, device="cpu").load_keras(
        cpu).predict(check)
    got = pred[:AD_CHECK_ROWS]
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    ok = (out.shape == (AD_BATCH, 1) and pred.shape == (n, 1)
          and bool(np.isfinite(pred).all()) and rel <= AD_REL_TOL
          and recall == 1.0 and _build.build_events() == builds)
    emit({"phase": "anomaly_serving", "batch": AD_BATCH,
          "max_batch": AD_SERVE_MAX_BATCH, "requests": AD_REQUESTS,
          "p50_ms": float(np.percentile(times, 50)),
          "p99_ms": float(np.percentile(times, 99)),
          "launches": serve_counts, "card_vs_cpu_rel_err": rel,
          "rel_tol": AD_REL_TOL, "spikes": AD_SPIKES,
          "detected": found.tolist(), "injected": targets.tolist(),
          "recall": recall, "ok": ok, "card": card})
    if not ok:
        raise SystemExit("chip_smoke: anomaly serving or detection check "
                         "failed")
    del im, est, cpu
    rnn_path_checks("anomaly", lambda: AnomalyDetector(AD_SHAPE).model,
                    state, {"x": x[:AD_BATCH], "y": y[:AD_BATCH]}, AD_BATCH,
                    "mse", sweep, drops, (False,), card)
    errs = {str(list(s)): dropout_at(s, torch.float32, 0.2, seed + 91 + i)
            for i, s in enumerate(((AD_BATCH, AD_SHAPE[0], 8),
                                   (AD_BATCH, AD_SHAPE[0], 32),
                                   (AD_BATCH, 15)))}
    emit({"phase": "anomaly_dropout_shapes", "dtype": "float32",
          "max_abs_err_vs_plain": errs,
          "ok": all(e == 0.0 for e in errs.values())})
    if any(e != 0.0 for e in errs.values()):
        raise SystemExit("chip_smoke: dropout kernel at the anomaly shapes")
    del model, ad
    torch.cuda.empty_cache()
    return {"counts": counts, "step_ms": step_ms, "device_ms": dev}


def phase_session_check(card: str, seed: int):
    """SessionRecommender (a check, no timing): the card's f32 softmax
    over 5,000 items against the port's CPU run, through `InferenceModel`
    and `recommend_for_session`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    sr = SessionRecommender(**SR_CFG)
    sr.model.ensure_built(seed=seed)
    rs = np.random.default_rng(seed + 95)
    sessions = rs.integers(1, SR_CFG["item_count"] + 1,
                           (SR_ROWS, SR_CFG["session_length"])).astype(
        np.int32)
    im = InferenceModel(max_batch=SR_ROWS).load_keras(sr.model)
    im.warmup(np.zeros(SR_CFG["session_length"], np.int32),
              buckets=[SR_ROWS])
    got = im.predict(sessions)
    cpu = SessionRecommender(**SR_CFG, device="cpu")
    load_by_order(cpu.model, sr.model.state_dict())
    want = InferenceModel(max_batch=SR_ROWS, device="cpu").load_keras(
        cpu.model).predict(sessions)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    top = [[i for i, _ in r] for r in sr.recommend_for_session(sessions, 5)]
    top_cpu = [[i for i, _ in r]
               for r in cpu.recommend_for_session(sessions, 5)]
    ok = (got.shape == (SR_ROWS, SR_CFG["item_count"])
          and bool(np.isfinite(got).all()) and rel <= SR_REL_TOL
          and bool(np.allclose(got.sum(-1), 1.0, atol=1e-4)))
    emit({"phase": "session_check", **{k: list(v) if isinstance(v, tuple)
                                        else v for k, v in SR_CFG.items()},
          "rows": SR_ROWS, "card_vs_cpu_rel_err": rel, "rel_tol": SR_REL_TOL,
          "prob_max": float(want.max()), "top5_same_rows": sum(
              a == b for a, b in zip(top, top_cpu)), "ok": ok, "card": card})
    if not ok:
        raise SystemExit("chip_smoke: SessionRecommender check failed")
    del im, sr, cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# nested models, the autograd DSL and persistence: the ImageNet model of
# `examples/inception_imagenet.py`, WideAndDeep at MovieLens-1M widths,
# the history SessionRecommender and a CustomLoss
# ---------------------------------------------------------------------------
# `examples/inception_imagenet.py:105-111, 160-167` with real data: uint8
# 224×224×3 images, the normalisation `Lambda` (float32 inside), then
# `inception_v1(1000)` nested as a layer; batch 256, "adam", mixed
# precision. Random images and labels stand in for ImageNet.
INC_MEAN = (123.0, 117.0, 104.0)
INC_STD = (58.4, 57.1, 57.4)
INC_BATCH = 256
INC_TRAIN_STEPS = 8
INC_PROFILE_STEPS = 2
INC_SERVE_BATCHES = IMG_BATCHES
INC_CHECK_ROWS = 8
# the nested uint8 model against the flat trunk fed the normalised f32
# batch, on the card, f32: the same expression and the same kernels on the
# same values (0 expected)
INC_NESTED_TOL = 1e-5
# WideAndDeep: the column spec of the wide-n-deep app's notebook
# (`apps/recommendation-wide-n-deep/wide_n_deep.ipynb`, analytics-zoo) at
# MovieLens-1M: ratings as 5 classes, occupation (21) and gender (3) one-hot
# wide columns, age × gender hashed into 100 crossed buckets, genres (19)
# and gender (3) indicators, users (6,040) and movies (3,952) embedded at
# 64, age continuous, MLP 40-20-10; batch 8192 (the NCF path's), f32.
WND_CFG = dict(class_num=5, model_type="wide_n_deep", wide_base_dims=(21, 3),
               wide_cross_dims=(100,), indicator_dims=(19, 3),
               embed_in_dims=(6040, 3952), embed_out_dims=(64, 64),
               continuous_cols=("age",), hidden_layers=(40, 20, 10))
WND_SAMPLES = 65_536            # in place of MovieLens-1M's 1,000,209
WND_BATCH = 8192
WND_TRAIN_STEPS = WND_SAMPLES // WND_BATCH
WND_PROFILE_STEPS = 2
WND_SERVE_BATCHES = (1, 32, 1024, 8192)
WND_SERVE_MAX_BATCH = 512       # larger batches go out in chunks, in flight
WND_REQUESTS = 20
WND_CHECK_ROWS = 1024
# SessionRecommender with its history branch: the default widths, sessions
# of 10 and histories of 20 items (chosen here), 5,000 items
SRH_CFG = dict(SR_CFG, include_history=True, history_length=20)
# `examples/autograd_custom_loss.py:22-35`: Dense(8, relu) → Dense(1) on 4
# features, mean absolute error in the Variable DSL; 3 steps of batch 64,
# the card's losses against the CPU's
CL_BATCH = 64
CL_LOSS_TOL = 1e-5


def normalize_layer(device=None):
    """The example's on-device normalisation of uint8 images."""
    dev = resolve_device(device)
    mean = torch.tensor(INC_MEAN, device=dev)
    std = torch.tensor(INC_STD, device=dev)
    return Lambda(lambda x: (x.float() - mean) / std)


def imagenet_model(device=None):
    """`Input` of uint8 → the normalisation `Lambda` → `inception_v1(1000)`
    nested as a layer."""
    inp = Input(shape=IMG_SHAPE)
    trunk = inception_v1(IMG_CLASSES, IMG_SHAPE, device=device)
    return Model(inp, trunk(normalize_layer(device)(inp)))


def uint8_images(rs, n: int) -> np.ndarray:
    return rs.integers(0, 256, (n,) + IMG_SHAPE, dtype=np.uint8)


def phase_inception_imagenet(card: str, seed: int):
    """The ImageNet model of `examples/inception_imagenet.py` trained
    through `Estimator.fit(mixed_precision=True, fused_optimizer=True)` at
    batch 256 on uint8 batches and served through `InferenceModel` (f32,
    bf16); the nested model against the flat trunk, the kernel path
    against the plain path, the dropout kernel at the path's shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = imagenet_model()
    model.ensure_built(seed=seed)
    trunk = model.ordered_layers()[-1]
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sweep = fad.sweep_launches(model.parameters())
    fwd_flops = image_forward_flops(trunk)
    flops_step = 3.0 * fwd_flops * INC_BATCH
    rs = np.random.default_rng(seed + 100)
    n = INC_BATCH * INC_TRAIN_STEPS
    t0 = time.perf_counter()
    data = {"x": uint8_images(rs, n),
            "y": rs.integers(0, IMG_CLASSES, n).astype(np.int32)}
    data_s = time.perf_counter() - t0
    upload = (data["x"][:INC_BATCH].nbytes + data["y"][:INC_BATCH].nbytes)
    est = Estimator.from_keras(model, optimizer="adam", loss=IMG_LOSS)
    fit_kw = dict(epochs=1, batch_size=INC_BATCH, mixed_precision=True,
                  fused_optimizer=True)
    # the warm fit runs the timed fit's data: two batches alone would fit
    # the device cache (the timed fit's eight do not), and the timed fit
    # would then capture its host-batch program
    t0 = time.perf_counter()
    est.fit(data, **fit_kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    builds = _build.build_events()

    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    t1 = time.perf_counter()
    hist = est.fit(data, **fit_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    builds_after = _build.build_events()
    step_ms = dt / INC_TRAIN_STEPS * 1e3
    expected = {dr.KERNEL_NAME: 2, fad.KERNEL_NAME: sweep}
    per_step = {k: counts.get(k, 0) / INC_TRAIN_STEPS for k in expected}
    buffers_f32 = all(b.dtype == torch.float32 for b in model.buffers())
    drop = next(l for l in trunk.ordered_layers()
                if isinstance(l, KL.Dropout))
    drop_shape = (INC_BATCH, trunk.ordered_layers()[-1].kernel.shape[0])
    emit({"phase": "inception_imagenet_train", "model": "inception_v1",
          "input": list(IMG_SHAPE), "input_dtype": "uint8",
          "classes": IMG_CLASSES, "batch": INC_BATCH,
          "steps": INC_TRAIN_STEPS, "data_s": data_s, "warm_fit_s": warm_s,
          "step_ms": step_ms, "images_per_s": n / dt,
          "forward_flops_per_image": fwd_flops, "flops_per_step": flops_step,
          "mfu": flops_step * INC_TRAIN_STEPS / dt / PEAK_BF16,
          "upload_bytes_per_step": upload,
          "f32_upload_bytes_per_step": 4 * data["x"][:INC_BATCH].nbytes
          + data["y"][:INC_BATCH].nbytes,
          "max_memory_allocated_gb": peak / 1e9, "loss": hist["loss"],
          "launches": counts, "launches_per_step": per_step,
          "expected_per_step": expected,
          "leaves": len(list(model.parameters())),
          "dropout_shape": list(drop_shape), "builds_before": builds,
          "builds_after": builds_after, "moving_stats_f32": buffers_f32,
          "card": card})
    if per_step != {k: float(v) for k, v in expected.items()}:
        raise SystemExit(f"chip_smoke: Inception-v1 ImageNet launches per "
                         f"step {per_step}, expected {expected}")
    if builds_after != builds or not buffers_f32 or not all(
            math.isfinite(x) for x in hist["loss"]):
        raise SystemExit("chip_smoke: Inception-v1 ImageNet training check "
                         "failed")
    prof_n = INC_PROFILE_STEPS * INC_BATCH
    dev, ops, classes, top = profile_fit_by_class(
        est, {"x": data["x"][:prof_n], "y": data["y"][:prof_n]}, fit_kw,
        INC_PROFILE_STEPS)
    emit({"phase": "inception_imagenet_train_profile",
          "device_ms_per_step": dev, "device_ops_per_step": ops,
          "step_ms": step_ms, "idle_share": (1.0 - dev / step_ms)
          if dev else None, "by_class": classes, "top": top, "card": card})
    del est, model, trunk
    torch.cuda.empty_cache()

    # the kernel path (dropout kernel, fused Adam) against the plain path
    # (the Dropout layer on the plain version with the same keep masks,
    # plain Adam), 3 steps from the same weights, cuDNN deterministic
    batch = {"x": data["x"][:INC_BATCH], "y": data["y"][:INC_BATCH]}
    del data
    torch.backends.cudnn.deterministic = True
    try:
        rnn_path_checks("inception_imagenet", imagenet_model, state, batch,
                        INC_BATCH, IMG_LOSS, sweep, 2, (True,), card)
    finally:
        torch.backends.cudnn.deterministic = False
    errs = {str(dtype)[6:]: dropout_at(drop_shape, dtype, drop.rate,
                                       seed + 101)
            for dtype in (torch.bfloat16, torch.float32)}
    emit({"phase": "inception_imagenet_dropout_shape",
          "shape": list(drop_shape), "rate": drop.rate,
          "max_abs_err_vs_plain": errs,
          "ok": all(e == 0.0 for e in errs.values())})
    if any(e != 0.0 for e in errs.values()):
        raise SystemExit("chip_smoke: dropout kernel at Inception-v1's "
                         "shape")

    serve = inception_imagenet_serving(card, seed, state, rs)
    return {"counts": counts, "step_ms": step_ms, "device_ms": dev,
            "serving": serve}


def inception_imagenet_serving(card: str, seed: int, state, rs):
    """The trained weights' architecture served through `InferenceModel`
    in f32 and bf16 (BatchNorm statistics calibrated on one uint8 batch,
    the head N(0, 0.02)), and the nested model against the flat
    `inception_v1` fed the normalised batch."""
    model = load_by_order(imagenet_model(), state)
    trunk = model.ordered_layers()[-1]
    with torch.no_grad():
        trunk.ordered_layers()[-1].kernel.normal_(
            0.0, 0.02, generator=torch.Generator(device="cuda").manual_seed(
                seed + 102))
    calibrate_batchnorm(model, torch.from_numpy(
        uint8_images(rs, IMG_CALIBRATION)).cuda())
    model_bf16 = load_by_order(imagenet_model(), model.state_dict()).to(
        torch.bfloat16)
    servers = {}
    for dtype_name, m in (("float32", model), ("bfloat16", model_bf16)):
        im = InferenceModel(max_batch=INC_SERVE_BATCHES[-1]).load_keras(m)
        im.warmup(np.zeros(IMG_SHAPE, np.uint8))
        servers[dtype_name] = im
    requests = {b: [uint8_images(rs, b) for _ in range(IMG_DISTINCT)]
                for b in INC_SERVE_BATCHES}
    check_x = uint8_images(rs, INC_CHECK_ROWS)
    builds = _build.build_events()
    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    rows, outputs = [], {}
    for dtype_name, im in servers.items():
        for b in INC_SERVE_BATCHES:
            times = []
            for i in range(IMG_REQUESTS):
                t1 = time.perf_counter()
                out = im.predict(requests[b][i % IMG_DISTINCT])
                times.append((time.perf_counter() - t1) * 1e3)
                if out.shape != (b, IMG_CLASSES) or \
                        not np.isfinite(out).all():
                    raise SystemExit(f"chip_smoke: bad Inception-v1 output "
                                     f"{out.shape} at batch {b}")
            rows.append({"phase": "inception_imagenet_serving",
                         "dtype": dtype_name, "batch": b,
                         "requests": len(times),
                         "p50_ms": float(np.percentile(times, 50)),
                         "p99_ms": float(np.percentile(times, 99)),
                         "images_per_s_at_p50":
                             b / float(np.percentile(times, 50)) * 1e3,
                         "upload_bytes": requests[b][0].nbytes,
                         "card": card})
        outputs[dtype_name] = im.predict(check_x)
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    for row in rows:
        emit(row)
    flat = load_by_order(inception_v1(IMG_CLASSES, IMG_SHAPE),
                         trunk.state_dict()).eval()
    mean = torch.tensor(INC_MEAN, device="cuda")
    std = torch.tensor(INC_STD, device="cuda")
    xu8 = torch.from_numpy(check_x).cuda()
    with torch.inference_mode():
        nested = model.apply(xu8).float().cpu().numpy()
        flat_out = flat.apply((xu8.float() - mean) / std).cpu().numpy()
    nested_err = float(np.abs(nested - flat_out).max())
    bf16_err = float(np.abs(outputs["bfloat16"] - outputs["float32"]).max())
    served_err = float(np.abs(outputs["float32"] - flat_out).max())
    ok = (nested_err <= INC_NESTED_TOL and served_err <= INC_NESTED_TOL
          and bf16_err <= IMG_PROB_TOL["bfloat16"] and not counts
          and _build.build_events() == builds)
    emit({"phase": "inception_imagenet_checks",
          "nested_vs_flat_max_abs_err": nested_err,
          "served_vs_flat_max_abs_err": served_err,
          "nested_tol": INC_NESTED_TOL,
          "bf16_vs_f32_max_abs_err": bf16_err,
          "bf16_tol": IMG_PROB_TOL["bfloat16"], "prob_max": float(
              outputs["float32"].max()), "launches": counts, "ok": ok,
          "card": card})
    if not ok:
        raise SystemExit("chip_smoke: Inception-v1 ImageNet serving check "
                         "failed")
    # the nested model's weights through the artifact and back (the CRC32C
    # reads every byte of the npz on save and on load)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inception_imagenet")
        t1 = time.perf_counter()
        model.save_weights(path)
        save_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        reloaded = imagenet_model().load_weights(path)
        load_s = time.perf_counter() - t1
        npz_bytes = os.path.getsize(path + ".npz")
    same_state = all(torch.equal(a, b) for a, b in zip(
        reloaded.state_dict().values(), model.state_dict().values()))
    emit({"phase": "inception_imagenet_persistence",
          "save_weights_s": save_s, "load_weights_s": load_s,
          "npz_bytes": npz_bytes, "state_bitwise_equal": same_state,
          "ok": same_state, "card": card})
    if not same_state:
        raise SystemExit("chip_smoke: Inception-v1 ImageNet weights did "
                         "not reload bitwise")
    del servers, model, model_bf16, flat, reloaded
    torch.cuda.empty_cache()
    return {r["dtype"] + "_b" + str(r["batch"]): r["p50_ms"] for r in rows}


def wide_and_deep_data(rs, n: int):
    """MovieLens-1M-shaped rows for `WND_CFG`: the wide one-hots and the
    hashed age × gender cross, genre and gender indicators, user and movie
    ids (1-based), age, a rating class."""
    occupation = rs.integers(0, 21, n)
    gender = rs.integers(0, 3, n)
    age = rs.integers(0, 7, n)                  # MovieLens-1M's 7 age bands
    cross = (age * 3 + gender) * 2654435761 % 100
    rows = np.arange(n)
    wide = np.zeros((n, 124), np.float32)
    wide[rows, occupation] = 1.0
    wide[rows, 21 + gender] = 1.0
    wide[rows, 24 + cross] = 1.0
    ind = np.zeros((n, 22), np.float32)
    ind[:, :19] = rs.random((n, 19)) < 0.1
    ind[rows, 19 + gender] = 1.0
    ids = np.stack([rs.integers(1, 6041, n), rs.integers(1, 3953, n)],
                   axis=1).astype(np.int32)
    con = (age[:, None] / 6.0).astype(np.float32)
    y = rs.integers(0, 5, n).astype(np.int32)
    return [wide, ind, ids, con], y


def rows_of(x, sel):
    return [a[sel] for a in x]


def phase_wide_and_deep(card: str, seed: int):
    """WideAndDeep at MovieLens-1M widths trained through
    `Estimator.fit(fused_optimizer=True)` at batch 8192 and served through
    `InferenceModel`; saved, reloaded through `ZooModel.load_model` and
    `InferenceModel.load_zoo_model`, predictions bitwise equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    wnd = WideAndDeep(**WND_CFG)
    model = wnd.model
    model.ensure_built(seed=seed)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sweep = fad.sweep_launches(model.parameters())
    rs = np.random.default_rng(seed + 110)
    x, y = wide_and_deep_data(rs, WND_SAMPLES)
    est = Estimator.from_keras(model, optimizer="adam", loss=IMG_LOSS)
    fit_kw = dict(epochs=1, batch_size=WND_BATCH, fused_optimizer=True)
    # the warm fit runs the timed fit's data (device-resident: its
    # programs gather from that data's buffers)
    est.fit({"x": x, "y": y}, **fit_kw)
    torch.cuda.synchronize()
    builds = _build.build_events()

    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    t0 = time.perf_counter()
    hist = est.fit({"x": x, "y": y}, **fit_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    builds_after = _build.build_events()
    step_ms = dt / WND_TRAIN_STEPS * 1e3
    expected = {fad.KERNEL_NAME: sweep}
    per_step = {k: counts.get(k, 0) / WND_TRAIN_STEPS for k in expected}
    prof = slice(0, WND_PROFILE_STEPS * WND_BATCH)
    dev, ops, classes, top = profile_fit_by_class(
        est, {"x": rows_of(x, prof), "y": y[prof]}, fit_kw,
        WND_PROFILE_STEPS)
    summary = io.StringIO()
    with contextlib.redirect_stdout(summary):
        text = wnd.summary()
    total = int(text.rsplit("Total params: ", 1)[1])
    emit({"phase": "wide_and_deep_train", **{
        k: list(v) if isinstance(v, tuple) else v
        for k, v in WND_CFG.items()}, "samples": WND_SAMPLES,
        "batch": WND_BATCH, "steps": WND_TRAIN_STEPS, "step_ms": step_ms,
        "samples_per_s": WND_SAMPLES / dt, "loss": hist["loss"],
        "device_ms_per_step": dev, "device_ops_per_step": ops,
        "idle_share": (1.0 - dev / step_ms) if dev else None,
        "by_class": classes, "top": top[:6], "launches": counts,
        "launches_per_step": per_step, "expected_per_step": expected,
        "leaves": len(list(model.parameters())),
        "summary_total_params": total, "builds_before": builds,
        "builds_after": builds_after, "card": card})
    if per_step != {k: float(v) for k, v in expected.items()} or \
            builds_after != builds or \
            total != sum(v.numel() for v in model.state_dict().values()) or \
            not all(math.isfinite(v) for v in hist["loss"]):
        raise SystemExit("chip_smoke: WideAndDeep training check failed")
    # the kernel path (fused Adam) against the plain path (plain Adam), 3
    # f32 steps on one batch from the same weights, and the sweep bit-exact
    # at this path's leaves (the 6041 × 64 and 3953 × 64 tables, the
    # 124 × 5 wide kernel, the 5-element biases)
    rnn_path_checks("wide_and_deep", lambda: WideAndDeep(**WND_CFG).model,
                    state, {"x": rows_of(x, slice(0, WND_BATCH)),
                            "y": y[:WND_BATCH]},
                    WND_BATCH, IMG_LOSS, sweep, 0, (False,), card)
    del state

    im = InferenceModel(max_batch=WND_SERVE_MAX_BATCH).load_keras(wnd)
    im.warmup([a[0] for a in x])
    check = rows_of(x, slice(0, WND_CHECK_ROWS))
    requests = {b: rows_of(x, slice(0, b)) for b in WND_SERVE_BATCHES}
    builds = _build.build_events()
    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    latencies = {}
    for b in WND_SERVE_BATCHES:
        times = []
        for _ in range(WND_REQUESTS):
            t1 = time.perf_counter()
            out = im.predict(requests[b])
            times.append((time.perf_counter() - t1) * 1e3)
            if out.shape != (b, WND_CFG["class_num"]) or \
                    not np.isfinite(out).all():
                raise SystemExit(f"chip_smoke: bad WideAndDeep output at "
                                 f"batch {b}")
        latencies[b] = times
    before = im.predict(check)
    serve_counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    for b, times in latencies.items():
        emit({"phase": "wide_and_deep_serving", "batch": b,
              "max_batch": WND_SERVE_MAX_BATCH, "requests": len(times),
              "p50_ms": float(np.percentile(times, 50)),
              "p99_ms": float(np.percentile(times, 99)),
              "samples_per_s_at_p50": b / float(np.percentile(times, 50))
              * 1e3, "card": card})

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wide_and_deep")
        t1 = time.perf_counter()
        wnd.save_model(path)
        save_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        loaded = WideAndDeep.load_model(path)
        load_s = time.perf_counter() - t1
        same_state = all(torch.equal(a, b) for a, b in zip(
            loaded.model.state_dict().values(),
            model.state_dict().values()))
        t1 = time.perf_counter()
        im2 = InferenceModel(max_batch=WND_SERVE_MAX_BATCH).load_zoo_model(
            WideAndDeep, path)
        zoo_load_s = time.perf_counter() - t1
        artifact = {f: os.path.getsize(os.path.join(path, f))
                    for f in sorted(os.listdir(path))}
    after = im2.predict(check)
    ok = (same_state and np.array_equal(before, after)
          and after.shape == (WND_CHECK_ROWS, WND_CFG["class_num"])
          and not serve_counts and _build.build_events() == builds)
    emit({"phase": "wide_and_deep_persistence", "save_model_s": save_s,
          "load_model_s": load_s, "load_zoo_model_s": zoo_load_s,
          "artifact_bytes": artifact, "state_bitwise_equal": same_state,
          "predictions_bitwise_equal": bool(np.array_equal(before, after)),
          "rows": WND_CHECK_ROWS, "serving_launches": serve_counts,
          "ok": ok, "card": card})
    if not ok:
        raise SystemExit("chip_smoke: WideAndDeep serving or persistence "
                         "check failed")
    del im, im2, est, loaded, model, wnd
    torch.cuda.empty_cache()
    return {"counts": counts, "step_ms": step_ms, "device_ms": dev}


def phase_autograd_checks(card: str, seed: int):
    """Checks without timing: `SessionRecommender(include_history=True)`
    served and fitted one step on the card against the CPU, and the
    `CustomLoss` of `examples/autograd_custom_loss.py` fitted 3 steps on
    the card against the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.default_rng(seed + 120)
    items = SRH_CFG["item_count"]
    x = [rs.integers(1, items + 1, (SR_ROWS, SRH_CFG["session_length"])
                     ).astype(np.int32),
         rs.integers(1, items + 1, (SR_ROWS, SRH_CFG["history_length"])
                     ).astype(np.int32)]
    y = rs.integers(0, items, SR_ROWS).astype(np.int32)
    sr = SessionRecommender(**SRH_CFG)
    sr.model.ensure_built(seed=seed)
    cpu = SessionRecommender(**SRH_CFG, device="cpu")
    load_by_order(cpu.model, sr.model.state_dict())
    def served():
        got = InferenceModel(max_batch=SR_ROWS).load_keras(sr).predict(x)
        want = InferenceModel(max_batch=SR_ROWS, device="cpu").load_keras(
            cpu).predict(x)
        return got, float(np.abs(got - want).max() / np.abs(want).max())

    got, rel_before = served()
    losses = [Estimator.from_keras(m.model, optimizer="adam", loss=IMG_LOSS,
                                   device=device).fit(
        {"x": x, "y": y}, epochs=1, batch_size=SR_ROWS,
        fused_optimizer=True)["loss"][0]
        for m, device in ((sr, None), (cpu, "cpu"))]
    got_after, rel_after = served()
    ok_sr = (got.shape == got_after.shape == (SR_ROWS, items)
             and bool(np.isfinite(got_after).all())
             and max(rel_before, rel_after) <= SR_REL_TOL
             and abs(losses[0] - losses[1]) <= SR_REL_TOL * abs(losses[1]))
    emit({"phase": "session_history_check", **{
        k: list(v) if isinstance(v, tuple) else v
        for k, v in SRH_CFG.items()}, "rows": SR_ROWS,
        "card_vs_cpu_rel_err": rel_before,
        "card_vs_cpu_rel_err_after_step": rel_after, "rel_tol": SR_REL_TOL,
        "fit_loss_card": losses[0], "fit_loss_cpu": losses[1], "ok": ok_sr,
        "card": card})
    del sr, cpu

    feats = rs.random((CL_BATCH, 4), dtype=np.float32)
    target = (feats.sum(axis=1, keepdims=True) + 1.0).astype(np.float32)
    hists = []
    for device in (None, "cpu"):
        net = Sequential([KL.Dense(8, input_shape=(4,), activation="relu",
                                   device=device),
                          KL.Dense(1, device=device)])
        if device is None:
            net.ensure_built(seed=seed)
            state = {k: v.detach().clone()
                     for k, v in net.state_dict().items()}
        else:
            load_by_order(net, state)
        y_true = autograd.Variable(input_shape=(1,))
        y_pred = autograd.Variable(input_shape=(1,))
        mae = autograd.CustomLoss(
            autograd.mean(autograd.abs(y_true - y_pred), axis=1), y_true,
            y_pred)
        LAUNCHES.reset()
        hists.append(Estimator.from_keras(
            net, optimizer="adam", loss=mae, device=device).fit(
            {"x": feats, "y": target}, epochs=3, batch_size=CL_BATCH,
            fused_optimizer=True)["loss"])
        if device is None:
            cl_counts = LAUNCHES.snapshot()
    errs = [abs(a - b) for a, b in zip(*hists)]
    ok_cl = (all(e <= CL_LOSS_TOL for e in errs)
             and cl_counts.get(fad.KERNEL_NAME, 0) == 3)
    emit({"phase": "custom_loss_check", "loss_card": hists[0],
          "loss_cpu": hists[1], "loss_err_per_step": errs,
          "loss_tol": CL_LOSS_TOL, "launches_card": cl_counts, "ok": ok_cl,
          "card": card})
    # a Lambda whose CUDA tensor a `functools.partial` holds: its shape
    # inference fails on CPU zeros and runs again on the card's
    offset = torch.arange(4, dtype=torch.float32, device="cuda")
    inp = Input(shape=(4,))
    shifted = Model(inp, Lambda(functools.partial(torch.sub, other=offset))(
        inp))
    xs = torch.from_numpy(feats[:8]).cuda()
    with torch.no_grad():
        ok_lambda = torch.equal(shifted.apply(xs), xs - offset)
    emit({"phase": "lambda_partial_check", "ok": ok_lambda, "card": card})
    if not (ok_sr and ok_cl and ok_lambda):
        raise SystemExit("chip_smoke: history SessionRecommender, "
                         "CustomLoss or Lambda check failed")
    torch.cuda.empty_cache()


# Path A: the news20 TextClassifier with its own optimizer, the JAX
# registry's "adagrad" (`optax.adagrad(0.01)`), under a checkpointed
# Estimator: 2 epochs of 8 steps at batch 128, a validation split of 256
# rows evaluated after each epoch, bf16 with f32 masters
TXTA_EPOCHS = 2
TXTA_STEPS = 8
TXTA_VAL = 256
# the compiled "accuracy" and the loss as a validation metric (the metric
# string "loss" means the mean squared error, in the JAX package too)
TXTA_METRICS = ["accuracy", "loss_sparse_categorical_crossentropy"]
# Path B: WideAndDeep at MovieLens-1M widths (phase 22's data and
# batch, fused Adam) fitted 3 epochs, killed by a fault at `trainer.step`
# two steps into epoch 3, resumed by a fresh instance with auto_resume; the
# resumed epoch-3 loss and the final parameters and moments against an
# uninterrupted fit in the same call
RES_EPOCHS = 3
RES_KILL_AT = 2 * WND_TRAIN_STEPS + 2      # iteration the fault fires at
RES_REL_TOL = 1e-6


@contextlib.contextmanager
def timed_calls(targets):
    """Wrap each `(owner, attribute)` in `targets` to add its wall seconds
    and call count to the yielded dict, keyed by attribute; the
    originals come back on exit."""
    spent = {name: {"s": 0.0, "calls": 0} for _, name in targets}
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name]["s"] += time.perf_counter() - t0
                spent[name]["calls"] += 1
        return wrapper

    for owner, name, fn in saved:
        setattr(owner, name, timed(name, fn))
    try:
        yield spent
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def version_files(run_dir: str, version: int) -> dict:
    """{file: bytes} of one checkpoint version's set."""
    pat = re.compile(rf"(model|optimMethod-.+)\.{version}\.")
    return {f: os.path.getsize(os.path.join(run_dir, f))
            for f in sorted(os.listdir(run_dir)) if pat.match(f)}


def text_adagrad_path_check(matrix, state, data, seed: int) -> dict:
    """The kernel path (the dropout kernel) against the plain path (the
    plain dropout on the same Philox masks) of the Adagrad fit, 3 f32 steps
    on one batch from the same weights: losses within RNN_PATH_TOL, the
    update within RNN_UPDATE_TOL, and launches (2 dropout kernels a step
    on the kernel path, none on the plain one)."""
    runs = {}
    for name in ("kernel", "plain"):
        m = load_by_order(text_model("lstm", matrix).model, state)
        initial = [p.detach().clone() for p in m.parameters()]
        LAUNCHES.reset()
        with contextlib.nullcontext() if name == "kernel" \
                else plain_dropout_layers():
            h = Estimator.from_keras(m, optimizer="adagrad",
                                     loss=RNN_LOSS).fit(
                data, epochs=3, batch_size=TXT_BATCH, seed=seed)
        runs[name] = (h["loss"], LAUNCHES.snapshot(),
                      [p.detach().clone() for p in m.parameters()])
        del m
    (lk, ck, pk), (lp, cp, pp) = runs["kernel"], runs["plain"]
    errs = [abs(a - b) for a, b in zip(lk, lp)]
    upd = update_errors(initial, pk, pp)
    ok = (all(e <= RNN_PATH_TOL[False] for e in errs)
          and all(math.isfinite(v) for v in lk + lp)
          and upd["update_rel_l2_err"] is not None
          and upd["update_rel_l2_err"] <= RNN_UPDATE_TOL[False]
          and ck.get(dr.KERNEL_NAME, 0) == 6 and not cp.get(dr.KERNEL_NAME))
    torch.cuda.empty_cache()
    return {"dtype": "float32", "steps": 3, "loss_kernel": lk,
            "loss_plain": lp, "loss_err_per_step": errs,
            "loss_tol": RNN_PATH_TOL[False], **upd,
            "update_tol": RNN_UPDATE_TOL[False],
            "launches_kernel_path": ck, "launches_plain_path": cp, "ok": ok}


def optimizer_host_ms(model) -> dict:
    """Host ms of one optimizer step over the model's parameters on random
    gradients: the plain Adagrad (its update and the `p += u` pass, as the
    trainer runs them) beside the fused-Adam sweep (one launch)."""
    params = dict(model.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(0)
    grads = {n: torch.randn(p.shape, device="cuda", generator=gen)
             for n, p in params.items()}
    ada, fused = optimizers.get("adagrad"), optimizers.fused_adam(1e-3)
    state = {"adagrad": ada.init(params), "fused": fused.init(params)}

    @torch.no_grad()
    def adagrad_step():
        u, state["adagrad"] = ada.update(grads, state["adagrad"], params)
        for n, t in params.items():
            t.add_(u[n])

    @torch.no_grad()
    def fused_step():
        _, state["fused"] = fused.fused_apply(grads, state["fused"], params)
    return {"adagrad": host_ms(adagrad_step, 20),
            "fused_adam": host_ms(fused_step, 20), "leaves": len(params)}


def phase_text_adagrad(card: str, seed: int):
    """Path A: TextClassifier-lstm at news20's widths compiled with
    "adagrad", trained through `Estimator.from_keras(model,
    model_dir=...).fit(epochs=2, validation_data=..., mixed_precision=True)`
    (the default `EveryEpoch` checkpoint trigger): step ms, samples/s,
    validation per epoch, checkpoint save seconds and bytes, the run
    directory, which `find_resume_checkpoint` must accept; then the kernel
    path against the plain path in f32."""
    from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
    from analytics_zoo_tpu_torch.learn import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    matrix = text_matrix(seed + 130)
    clf = text_model("lstm", matrix)
    model = clf.model
    model.ensure_built(seed=seed)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    table = model.layers[0].embeddings.detach().clone()
    rs = np.random.default_rng(seed + 131)
    n = TXT_BATCH * TXTA_STEPS
    data = {"x": rs.integers(0, TXT_WORDS + 1, (n, TXT_SEQ)).astype(np.int32),
            "y": rs.integers(0, TXT_CLASSES, n).astype(np.int32)}
    val = {"x": rs.integers(0, TXT_WORDS + 1, (TXTA_VAL, TXT_SEQ)
                            ).astype(np.int32),
           "y": rs.integers(0, TXT_CLASSES, TXTA_VAL).astype(np.int32)}
    fit_kw = dict(batch_size=TXT_BATCH, validation_data=val,
                  mixed_precision=True, seed=seed)
    t0 = time.perf_counter()
    from analytics_zoo_tpu_torch.ops.metrics import Loss
    # the warm fit runs the timed fit's data (device-resident: its
    # programs gather from that data's buffers)
    Estimator.from_keras(model, optimizer="adagrad", loss=RNN_LOSS,
                         metrics=[TXTA_METRICS[0], Loss(RNN_LOSS)]).fit(
        data, epochs=1, **fit_kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    builds = _build.build_events()
    with tempfile.TemporaryDirectory() as tmp:
        est = Estimator.from_keras(model, model_dir=tmp)
        with timed_calls([(ckpt.CheckpointManager, "save"),
                          (ckpt, "write_publish_marker"),
                          (convert, "state_to_jax"),
                          (convert, "opt_layout_to_jax"),
                          (trainer, "evaluate_keras"),
                          (trainer, "_step_with_watchdog"),
                          (trainer, "_to_device")]) as spent:
            # -- the main path: every count is 0 just before, read just
            # after ----------------------------------------------------------
            LAUNCHES.reset()
            t1 = time.perf_counter()
            hist = est.fit(data, epochs=TXTA_EPOCHS, **fit_kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            counts = LAUNCHES.snapshot()
            # -----------------------------------------------------------------
        builds_after = _build.build_events()
        found = ckpt.find_resume_checkpoint(tmp)
        run_dir, version = (found[0], found[1]) if found else (None, None)
        listing = {f: os.path.getsize(os.path.join(run_dir, f))
                   for f in sorted(os.listdir(run_dir))} if found else {}
        ckpt_bytes = sum(version_files(run_dir, version).values()) \
            if found else 0
        published = bool(found) and ckpt.published_intact(run_dir, version)
    steps = TXTA_EPOCHS * TXTA_STEPS
    save_s = spent["save"]["s"] + spent["write_publish_marker"]["s"]
    host_copy_s = spent["state_to_jax"]["s"] + \
        spent["opt_layout_to_jax"]["s"]
    expected = {dr.KERNEL_NAME: 2}
    per_step = {k: counts.get(k, 0) / steps for k in expected}
    val_keys = sorted(k for k in hist if k.startswith("val_"))
    table_same = torch.equal(model.layers[0].embeddings.detach(), table)
    ok = (per_step == {k: float(v) for k, v in expected.items()}
          and not counts.get(fad.KERNEL_NAME)
          and builds_after == builds and table_same
          and found is not None and version == steps
          and found[2].get("epoch") == TXTA_EPOCHS and published
          and val_keys == ["val_loss", "val_sparse_categorical_accuracy"]
          and all(len(hist[k]) == TXTA_EPOCHS for k in val_keys)
          and all(math.isfinite(v) for k in hist for v in hist[k])
          and spent["save"]["calls"] == TXTA_EPOCHS)
    emit({"phase": "text_adagrad_train", "encoder": "lstm",
          "optimizer": "adagrad", "lr": 0.01, "batch": TXT_BATCH,
          "seq": TXT_SEQ, "hidden": TXT_HIDDEN, "embed": TXT_EMBED,
          "classes": TXT_CLASSES, "epochs": TXTA_EPOCHS,
          "steps_per_epoch": TXTA_STEPS, "val_rows": TXTA_VAL,
          "warm_fit_s": warm_s, "fit_s": dt,
          "step_ms": (dt - save_s - host_copy_s
                      - spent["evaluate_keras"]["s"]) / steps * 1e3,
          "fit_ms_per_step": dt / steps * 1e3,
          "validation_s": spent["evaluate_keras"]["s"] / TXTA_EPOCHS,
          "host_ms_per_step": {
              "step_call": spent["_step_with_watchdog"]["s"] / steps * 1e3,
              "uploads_validation_included":
              spent["_to_device"]["s"] / steps * 1e3},
          "samples_per_s": n * TXTA_EPOCHS / dt, "loss": hist["loss"],
          **{k: hist[k] for k in val_keys},
          "checkpoint_saves": spent["save"]["calls"],
          "checkpoint_save_s": save_s / max(spent["save"]["calls"], 1),
          "checkpoint_host_copy_s": host_copy_s
          / max(spent["state_to_jax"]["calls"], 1),
          "checkpoint_bytes": ckpt_bytes, "run_dir_listing": listing,
          "resume_checkpoint": {"version": version,
                                "meta_epoch": found[2].get("epoch")
                                if found else None,
                                "published": published},
          "launches": counts, "launches_per_step": per_step,
          "expected_per_step": expected, "frozen_table_unchanged": table_same,
          "builds_before": builds, "builds_after": builds_after, "ok": ok,
          "card": card})
    if not ok:
        raise SystemExit("chip_smoke: text Adagrad checkpointed fit failed")
    prof_n = TXT_PROFILE_STEPS * TXT_BATCH
    dev, ops, classes, top = profile_fit_by_class(
        Estimator.from_keras(model),
        {"x": data["x"][:prof_n], "y": data["y"][:prof_n]},
        dict(epochs=1, batch_size=TXT_BATCH, mixed_precision=True,
             seed=seed), TXT_PROFILE_STEPS)
    step_ms = (dt - save_s - host_copy_s
               - spent["evaluate_keras"]["s"]) / steps * 1e3
    emit({"phase": "text_adagrad_profile", "device_ms_per_step": dev,
          "device_ops_per_step": ops, "step_ms": step_ms,
          "idle_share": (1.0 - dev / step_ms) if dev else None,
          "by_class": classes, "top": top[:6],
          "optimizer_host_ms": optimizer_host_ms(model), "card": card})
    del est, model, clf
    torch.cuda.empty_cache()
    check = text_adagrad_path_check(
        matrix, state, {"x": data["x"][:TXT_BATCH],
                        "y": data["y"][:TXT_BATCH]}, seed)
    emit({"phase": "text_adagrad_kernel_vs_plain", **check, "card": card})
    if not check["ok"]:
        raise SystemExit("chip_smoke: text Adagrad kernel-vs-plain check "
                         "failed")
    return {"counts": counts, "step_ms": dt / steps * 1e3}


def sorted_leaves(tree) -> list:
    """A tree's leaves with dict keys in sorted order, so that trees built
    in another insertion order line up."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def max_rel_diff(a, b) -> float:
    """max |a − b| / max(|b|, tiny) over every element of two trees of
    arrays."""
    worst = 0.0
    for x, y in zip(sorted_leaves(a), sorted_leaves(b)):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if x.size:
            worst = max(worst, float(np.max(np.abs(x - y) / np.maximum(
                np.abs(y), np.finfo(np.float32).tiny))))
    return worst


def tree_bitwise(a, b) -> bool:
    la, lb = sorted_leaves(a), sorted_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def phase_resume(card: str, seed: int):
    """Path B: WideAndDeep at MovieLens-1M widths, fused Adam (one sweep
    launch a step), `set_checkpoint` then a 3-epoch fit killed by a fault
    at `trainer.step` in epoch 3 (an emergency checkpoint, then the
    raise); a fresh instance's `fit(auto_resume=True)` continues from the
    epoch-2 boundary. The state restored from disk against the saved one
    (bitwise), the resumed epoch-3 loss and the final parameters and
    moments against an uninterrupted fit in the same call (bitwise, else
    within RES_REL_TOL), the resume seconds."""
    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
    from analytics_zoo_tpu_torch.learn import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.default_rng(seed + 140)
    x, y = wide_and_deep_data(rs, WND_SAMPLES)
    kw = dict(batch_size=WND_BATCH, seed=seed, fused_optimizer=True)

    def new():
        m = WideAndDeep(**WND_CFG)
        m.model.ensure_built(seed=seed)
        m.compile("adam", IMG_LOSS)
        return m

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            full_dir = os.path.join(tmp, "uninterrupted")
            run_dir_root = os.path.join(tmp, "killed")
            full = new()
            full.set_checkpoint(full_dir)
            h_full = full.fit(x, y, nb_epoch=RES_EPOCHS, **kw)
            torch.cuda.synchronize()
            builds = _build.build_events()

            killed = new()
            killed.set_checkpoint(run_dir_root)
            faults.inject("trainer.step", faults.Fault(
                exc=RuntimeError("injected: the card fell over"),
                match=lambda c: c.get("iteration", 0) >= RES_KILL_AT))
            try:
                killed.fit(x, y, nb_epoch=RES_EPOCHS, **kw)
                raised = False
            except RuntimeError:
                raised = True
            finally:
                faults.clear("trainer.step")
            listed = ckpt.list_checkpoints(run_dir_root)
            newest_dir, newest = listed[0]
            newest_meta = ckpt.read_checkpoint_meta(newest_dir, newest)
            found = ckpt.find_resume_checkpoint(run_dir_root)

            # the state restored from disk against the state saved there
            probe = new()
            opt = optimizers.as_fused(probe.model.optimizer, "adam")
            gen = torch.Generator()
            fresh = opt.init(dict(probe.model.named_parameters()))
            restored, meta = trainer.restore_training_state(
                probe.model, opt, fresh, gen, run_dir_root)
            s_params, s_opt, s_meta = ckpt.load_checkpoint(found[0],
                                                           found[1])
            r_params = convert.state_to_jax(probe.model.state_dict(),
                                            probe.model)
            r_opt = convert.opt_layout_to_jax(opt, restored, probe.model)
            want_gen = torch.Generator().manual_seed(seed)
            torch.randint(0, 2 ** 62, (found[1],), generator=want_gen)
            restore_exact = {
                "params": tree_bitwise(
                    r_params, probe.model._remap_loaded(s_params)),
                "mu_nu_count": tree_bitwise(
                    r_opt, convert.remap_moment_trees(
                        s_opt, list(s_params), probe.model._remap_loaded)),
                "count": int(restored.count) == found[1],
                "generator": torch.equal(gen.get_state(),
                                         want_gen.get_state())}
            del probe, restored, fresh

            resumed = new()
            resumed.set_checkpoint(run_dir_root)
            with timed_calls([(trainer, "restore_training_state")]) as spent:
                # -- the main path: every count is 0 just before, read
                # just after -------------------------------------------------
                LAUNCHES.reset()
                t0 = time.perf_counter()
                h = resumed.fit(x, y, nb_epoch=RES_EPOCHS,
                                auto_resume=True, **kw)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = LAUNCHES.snapshot()
                # -------------------------------------------------------------
            builds_after = _build.build_events()
            remap = full.model._remap_loaded
            f_params, f_opt, _ = ckpt.load_checkpoint(full_dir)
            g_params, g_opt, g_meta = ckpt.load_checkpoint(run_dir_root)
            f_opt = convert.remap_moment_trees(f_opt, list(f_params), remap)
            g_opt = convert.remap_moment_trees(g_opt, list(g_params), remap)
            f_params, g_params = remap(f_params), remap(g_params)
            state_equal = all(torch.equal(a, b) for a, b in zip(
                resumed.model.state_dict().values(),
                full.model.state_dict().values()))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    loss_equal = h["loss"] == h_full["loss"][2:]
    params_bitwise = tree_bitwise(g_params, f_params)
    moments_bitwise = tree_bitwise(g_opt, f_opt)
    loss_rel = abs(h["loss"][0] - h_full["loss"][2]) / abs(
        h_full["loss"][2]) if len(h["loss"]) == 1 else float("inf")
    params_rel = max_rel_diff(g_params, f_params)
    moments_rel = max_rel_diff(g_opt, f_opt)
    sweep = fad.sweep_launches(resumed.model.parameters())
    expected = {fad.KERNEL_NAME: sweep}
    per_step = {k: counts.get(k, 0) / WND_TRAIN_STEPS for k in expected}
    ok = (raised and newest == RES_KILL_AT and newest_meta.get("emergency")
          and found is not None and found[1] == 2 * WND_TRAIN_STEPS
          and found[2].get("epoch") == 2 and all(restore_exact.values())
          and meta["iteration"] == found[1] and len(h["loss"]) == 1
          and max(loss_rel, params_rel, moments_rel) <= RES_REL_TOL
          and per_step == {k: float(v) for k, v in expected.items()}
          and builds_after == builds and g_meta.get("iteration") ==
          RES_EPOCHS * WND_TRAIN_STEPS)
    emit({"phase": "resume", "model": "WideAndDeep", "samples": WND_SAMPLES,
          "batch": WND_BATCH, "epochs": RES_EPOCHS,
          "steps_per_epoch": WND_TRAIN_STEPS, "killed_at_iteration":
          RES_KILL_AT, "raised": raised, "newest_checkpoint": newest,
          "newest_meta": {k: newest_meta.get(k) for k in (
              "epoch", "iteration", "epoch_finished", "emergency",
              "opt_state_layout")},
          "resumed_from": found[1] if found else None,
          "resume_s": spent["restore_training_state"]["s"],
          "resumed_fit_s": dt, "restored_equals_saved": restore_exact,
          "loss_uninterrupted": h_full["loss"], "loss_resumed": h["loss"],
          "loss_bitwise": loss_equal, "params_bitwise": params_bitwise,
          "moments_bitwise": moments_bitwise,
          "live_state_bitwise": state_equal,
          "max_rel_diff": {"loss": loss_rel, "params": params_rel,
                           "moments": moments_rel},
          "rel_tol": RES_REL_TOL, "launches": counts,
          "launches_per_step": per_step, "expected_per_step": expected,
          "builds_before": builds, "builds_after": builds_after, "ok": ok,
          "card": card})
    if not ok:
        raise SystemExit("chip_smoke: the killed WideAndDeep fit did not "
                         "resume to the uninterrupted run")
    del full, killed, resumed
    torch.cuda.empty_cache()
    return {"counts": counts}


# How an entry's `ms`, `plain_ms` and `library_ms` were taken: "events"
# (`time_ms`), "graph" (`graph_ms`) or "profiler" (`device_ms`, which takes
# "graph" when the profiler records nothing).
# ---------------------------------------------------------------------------
# BERT fine-tuning: SQuAD and NER
# ---------------------------------------------------------------------------
# Google BERT's SQuAD 1.1 recipe (`run_squad.py --max_seq_length=384
# --doc_stride=128 --learning_rate=3e-5 --num_train_epochs=2.0`, warmup
# 10%) at batch 32 (the BERT classifier phase's, so the two compare; the
# recipe's 12 fits a 12 GB card). Total steps for the schedule: 2 epochs
# of SQuAD 1.1's 87,599 training questions at batch 32.
SQUAD_SEQ = 384
SQUAD_QUESTION = 64
SQUAD_BATCH = 32
SQUAD_STEPS = 8
SQUAD_LR = 3e-5
SQUAD_TOTAL_STEPS = 2 * 87_599 // SQUAD_BATCH
SQUAD_FLOP_TOL = 0.10       # counted vs bench.py's formula (the JAX test's)
# CoNLL-2003's BIO tag set (O and B-/I- of PER, ORG, LOC, MISC) at seq 128,
# `default_compile`'s rate 5e-5 (AdamWeightDecay, no schedule: its fused
# twin is fused_adam(5e-5, eps=1e-6, weight_decay=0.01))
NER_TAGS = 9
NER_SEQ = 128
NER_BATCH = 32
NER_STEPS = 8
NER_LR = 5e-5
NER_SERVE_BATCHES = (1, 8, 32)
NER_REQUESTS = 20
# the prefetcher on the image step: ResNet-50 at batch 256, bf16
PF_STEPS = 6
PF_TURNS = 2                 # without, with: twice each, in turns (3
                             # until the graph phase came)
PF_PROFILE = (1, 3)          # profiled iterations [1, 3)
BERT_TRACE_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dkv_mma_kernel",
                      "flash_bwd_dq_mma_kernel", "dropout_kernel",
                      "fused_adam_multi_kernel")


def bert_task_state(cfg, head: str, width: int, seed: int):
    """A BERT task's weights: the encoder of `random_classifier_tree` and a
    `[hidden, width]` head N(0, 0.02), in the port's state-dict layout."""
    rs = np.random.default_rng(seed + 7)
    tree = {"bert": random_classifier_tree(cfg, 2, seed)["bert"],
            head + "_kernel": rs.standard_normal(
                (cfg["hidden_size"], width), dtype=np.float32) * 0.02,
            head + "_bias": np.zeros((width,), np.float32)}
    return convert.params_from_jax(tree)


def squad_data(rs, n: int, cfg):
    """SQuAD-shaped features: a 64-token question (segment 0), the
    context after it (segment 1), real lengths 128-384, the answer span
    inside the context."""
    T, Q = SQUAD_SEQ, SQUAD_QUESTION
    lengths = rs.integers(128, T + 1, n)
    pos = np.arange(T)[None, :]
    mask = pos < lengths[:, None]
    ids = np.where(mask, rs.integers(1000, cfg["vocab"], (n, T)), 0)
    segs = (pos >= Q) & mask
    start = rs.integers(Q, lengths - 1)
    end = np.minimum(start + rs.integers(0, 30, n), lengths - 2)
    return {"x": [ids.astype(np.int32), segs.astype(np.int32),
                  mask.astype(np.float32)],
            "y": [start.astype(np.int32), end.astype(np.int32)]}


def squad_loss():
    loss = objectives.get("sparse_categorical_crossentropy", from_logits=True)
    return [loss, loss]


def squad_optimizer():
    return optimizers.fused_adam(
        optimizers.warmup_linear_decay(SQUAD_LR, SQUAD_TOTAL_STEPS, 0.1),
        eps=1e-6, weight_decay=0.01)


def squad_model(state, remat: bool):
    model = BERTSQuAD(use_flash=True, remat=remat, device="cuda",
                      **BERT_BASE)
    model.load_state_dict(state)
    return model


def gauge(name: str, **labels):
    return get_registry().get(name).value(**labels)


def trace_kernel_counts(events, names) -> dict:
    """How many kernel events of the trace carry each name."""
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {n: sum(n in k for k in kernels) for n in names}


def phase_bert_squad(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BERT_BASE
    rs = np.random.default_rng(seed + 120)
    state = bert_task_state(cfg, "qa", 2, seed)
    models = {r: squad_model(state, r) for r in (False, True)}
    flops_step = train_flops_per_step(models[False], cfg, SQUAD_BATCH,
                                      SQUAD_SEQ)
    ests = {r: Estimator.from_keras(m, optimizer=squad_optimizer(),
                                    loss=squad_loss())
            for r, m in models.items()}
    fit_kw = dict(batch_size=SQUAD_BATCH, mixed_precision=True,
                  fused_optimizer=True, flops_per_step=flops_step)
    sweep = fad.sweep_launches(models[False].parameters())

    # warm fits (build, cuBLAS set-up, the cost harvest): 3 steps on one
    # batch, remat against plain from the same weights and seed
    batch = squad_data(rs, SQUAD_BATCH, cfg)
    warm = {}
    for r in (False, True):
        t0 = time.perf_counter()
        h = ests[r].fit(batch, epochs=3, **fit_kw)
        torch.cuda.synchronize()
        memo = models[r]._roofline_cost_memo[(True, False, True)]
        warm[r] = {"loss": h["loss"], "seconds": time.perf_counter() - t0,
                   "harvest_s": memo["__harvest_s__"]}
    sa, sb = models[False].state_dict(), models[True].state_dict()
    remat_loss_err = max(abs(a - b) for a, b in zip(warm[False]["loss"],
                                                    warm[True]["loss"]))
    remat_bitwise = (warm[False]["loss"] == warm[True]["loss"]
                     and all(torch.equal(sa[k], sb[k]) for k in sa))
    remat_param_err = max((sa[k].float() - sb[k].float()).abs().max().item()
                          for k in sa)
    emit({"phase": "squad_remat_check", "steps": 3, "dropout": 0.1,
          "loss_remat_off": warm[False]["loss"],
          "loss_remat_on": warm[True]["loss"],
          "loss_max_abs_err": remat_loss_err, "loss_tol": BF16_LOSS_TOL,
          "param_max_abs_err": remat_param_err, "bitwise": remat_bitwise,
          "warm_fit_s": {str(r): warm[r]["seconds"] for r in warm},
          "harvest_s": {str(r): warm[r]["harvest_s"] for r in warm},
          "card": card})
    if remat_loss_err > BF16_LOSS_TOL:
        raise SystemExit("chip_smoke: remat losses outside tolerance")

    # -- the main path, remat off and on in turns (ABAB): every count is 0
    # just before each fit, read just after --------------------------------
    data = squad_data(rs, SQUAD_BATCH * SQUAD_STEPS, cfg)
    tokens = SQUAD_BATCH * SQUAD_SEQ * SQUAD_STEPS
    expected = {False: {fa.KERNEL_NAME: cfg["n_block"]},
                True: {fa.KERNEL_NAME: 2 * cfg["n_block"]}}
    runs = []
    counts_by = {}
    for r in (False, True, False, True):
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.reset()
        t1 = time.perf_counter()
        hist = ests[r].fit(data, epochs=1, **fit_kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        counts = LAUNCHES.snapshot()
        # -------------------------------------------------------------------
        snap = get_accountant().snapshot("train")
        per_step = {k: v / SQUAD_STEPS for k, v in counts.items()}
        want = dict(expected[r], **{
            fa.BWD_DKV_NAME: cfg["n_block"], fa.BWD_DQ_NAME: cfg["n_block"],
            dr.KERNEL_NAME: 2 * (2 * cfg["n_block"] + 1)
            + (2 * cfg["n_block"] if r else 0),
            fad.KERNEL_NAME: sweep})
        row = {"phase": "squad_train", "remat": r, "seq_len": SQUAD_SEQ,
               "batch": SQUAD_BATCH, "steps": SQUAD_STEPS,
               "step_ms": dt / SQUAD_STEPS * 1e3, "tokens_per_s": tokens / dt,
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "loss": hist["loss"], "launches_per_step": per_step,
               "expected_per_step": want,
               "flops_per_step_formula": flops_step,
               "counted_flops_per_step": snap["flops"] / SQUAD_STEPS,
               "counted_bytes_per_step": snap["bytes"] / SQUAD_STEPS,
               "training_mfu": gauge("training_mfu"),
               "formula_mfu": flops_step * SQUAD_STEPS / dt / PEAK_BF16,
               "roofline_mfu": gauge("roofline_mfu", kind="train"),
               "roofline_hbm_utilization": gauge("roofline_hbm_utilization",
                                                 kind="train"),
               "training_input_bound": gauge("training_input_bound"),
               "card": card}
        emit(row)
        runs.append(row)
        counts_by.setdefault(r, counts)
        if per_step != {k: float(v) for k, v in want.items()} or not all(
                math.isfinite(x) for x in hist["loss"]):
            raise SystemExit(f"chip_smoke: SQuAD launches per step "
                             f"{per_step}, expected {want}")
    counted = {r: runs[i]["counted_flops_per_step"] for i, r in
               ((0, False), (1, True))}
    flop_err = counted[False] / flops_step - 1.0
    emit({"phase": "squad_flops", "formula": flops_step,
          "counted": counted[False], "rel_err": flop_err,
          "tol": SQUAD_FLOP_TOL, "remat_recompute": counted[True]
          - counted[False], "step_ms_remat_off": [runs[0]["step_ms"],
                                                  runs[2]["step_ms"]],
          "step_ms_remat_on": [runs[1]["step_ms"], runs[3]["step_ms"]],
          "card": card})
    if abs(flop_err) > SQUAD_FLOP_TOL:
        raise SystemExit("chip_smoke: counted FLOPs off the formula")
    # the prefetch thread's host cost on this host-heavy step: remat off,
    # without and with it, in turns
    turns = {False: [], True: []}
    for p in (False, True, False, True):
        t1 = time.perf_counter()
        ests[False].fit(data, epochs=1, prefetch=p, **fit_kw)
        torch.cuda.synchronize()
        turns[p].append((time.perf_counter() - t1) / SQUAD_STEPS * 1e3)
    emit({"phase": "squad_prefetch_turns", "step_ms_without": turns[False],
          "step_ms_with": turns[True], "card": card})
    for r in (False, True):
        steps = 2
        prof = make_data_subset(data, SQUAD_BATCH * steps)
        step_ms = float(np.mean([x["step_ms"] for x in runs
                                 if x["remat"] == r]))
        emit(dict(profile_fit(ests[r], prof, dict(fit_kw, epochs=1), steps,
                              step_ms), phase="squad_profile", remat=r,
                  card=card))

    # -- the fit's own profiler window: an artifact holding rows 1-6 ------
    with tempfile.TemporaryDirectory() as tmp:
        hist = ests[False].fit(make_data_subset(data, SQUAD_BATCH * 5),
                               epochs=1, profile_steps=(2, 4),
                               profile_dir=tmp, **fit_kw)
        arts = hist.get("profile_artifacts", [])
        events = load_trace_events(arts[0]) if arts else []
        found = trace_kernel_counts(events, BERT_TRACE_KERNELS)
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(arts[0]) for f in fs) if arts \
            else 0
    emit({"phase": "squad_profile_artifact", "artifacts": len(arts),
          "events": len(events), "gz_bytes": size,
          "kernel_events": found, "card": card})
    if len(arts) != 1 or not all(found.values()):
        raise SystemExit("chip_smoke: the fit's profiler artifact lacks "
                         "kernel events")
    del ests, models
    torch.cuda.empty_cache()

    # -- the fused AdamW against default_compile's plain optimizer --------
    plain = optimizers.adam_weight_decay(SQUAD_LR, warmup_portion=0.1,
                                         total_steps=SQUAD_TOTAL_STEPS,
                                         epsilon=1e-6, weight_decay=0.01)
    res = {}
    for name, opt in (("fused", squad_optimizer()), ("plain", plain)):
        m = squad_model(state, False)
        LAUNCHES.reset()
        h = Estimator.from_keras(m, optimizer=opt, loss=squad_loss()).fit(
            batch, epochs=3, batch_size=SQUAD_BATCH, mixed_precision=True,
            fused_optimizer=name == "fused")
        res[name] = (h["loss"], {k: v.detach().clone()
                                 for k, v in m.state_dict().items()},
                     LAUNCHES.get(fad.KERNEL_NAME))
        del m
        torch.cuda.empty_cache()
    (lf, pf, cf), (lp, pp, cp) = res["fused"], res["plain"]
    opt_err = max(abs(a - b) for a, b in zip(lf, lp))
    param_err = max((pf[k] - pp[k]).abs().max().item() for k in pf)
    opt_ok = opt_err <= BF16_LOSS_TOL and cf == 3 * sweep and cp == 0
    emit({"phase": "squad_fused_vs_plain_optimizer", "steps": 3,
          "loss_fused": lf, "loss_plain": lp, "loss_max_abs_err": opt_err,
          "loss_tol": BF16_LOSS_TOL, "param_max_abs_err": param_err,
          "fused_adam_launches": [cf, cp], "ok": opt_ok, "card": card})
    if not opt_ok:
        raise SystemExit("chip_smoke: fused AdamW against the plain "
                         "optimizer failed")
    return {"counts": counts_by[False], "counts_remat": counts_by[True]}


def make_data_subset(data, n: int):
    return {"x": [a[:n] for a in data["x"]],
            "y": [a[:n] for a in data["y"]] if isinstance(data["y"], list)
            else data["y"][:n]}


def ner_data(rs, n: int, cfg):
    T = NER_SEQ
    lengths = rs.integers(16, T + 1, n)
    mask = np.arange(T)[None, :] < lengths[:, None]
    ids = np.where(mask, rs.integers(1000, cfg["vocab"], (n, T)), 0)
    return {"x": [ids.astype(np.int32), np.zeros((n, T), np.int32),
                  mask.astype(np.float32)],
            "y": rs.integers(0, NER_TAGS, (n, T)).astype(np.int32)}


def phase_bert_ner(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BERT_BASE
    rs = np.random.default_rng(seed + 130)
    state = bert_task_state(cfg, "ner", NER_TAGS, seed)
    model = BERTNER(NER_TAGS, use_flash=True, device="cuda", **cfg)
    model.load_state_dict(state)
    est = Estimator.from_keras(
        model, optimizer=optimizers.fused_adam(NER_LR, eps=1e-6,
                                               weight_decay=0.01),
        loss=objectives.get("sparse_categorical_crossentropy",
                            from_logits=True))
    fit_kw = dict(epochs=1, batch_size=NER_BATCH, mixed_precision=True,
                  fused_optimizer=True)
    data = ner_data(rs, NER_BATCH * NER_STEPS, cfg)
    # the warm fit runs the timed fit's data (device-resident: its
    # programs gather from that data's buffers)
    t0 = time.perf_counter()
    est.fit(data, **fit_kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    # -- the main path (training): counts 0 just before, read just after --
    LAUNCHES.reset()
    t1 = time.perf_counter()
    hist = est.fit(data, **fit_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    n = cfg["n_block"]
    want = {fa.KERNEL_NAME: n, fa.BWD_DKV_NAME: n, fa.BWD_DQ_NAME: n,
            dr.KERNEL_NAME: 2 * (2 * n + 1),
            fad.KERNEL_NAME: fad.sweep_launches(model.parameters())}
    per_step = {k: v / NER_STEPS for k, v in counts.items()}
    emit({"phase": "ner_train", "seq_len": NER_SEQ, "batch": NER_BATCH,
          "tags": NER_TAGS, "steps": NER_STEPS, "warm_fit_s": warm_s,
          "step_ms": dt / NER_STEPS * 1e3,
          "tokens_per_s": NER_BATCH * NER_SEQ * NER_STEPS / dt,
          "loss": hist["loss"], "launches_per_step": per_step,
          "expected_per_step": want,
          "roofline_mfu": gauge("roofline_mfu", kind="train"),
          "card": card})
    if per_step != {k: float(v) for k, v in want.items()} or not all(
            math.isfinite(x) for x in hist["loss"]):
        raise SystemExit("chip_smoke: NER training check failed")

    im = InferenceModel(max_batch=max(NER_SERVE_BATCHES)).load_keras(model)
    T = NER_SEQ
    im.warmup([np.zeros(T, np.int32), np.zeros(T, np.int32),
               np.ones(T, np.float32)])
    requests = {b: [make_data_subset(ner_data(rs, b, cfg), b)["x"]
                    for _ in range(NER_REQUESTS)] for b in NER_SERVE_BATCHES}
    check = ner_data(rs, 3, cfg)["x"]

    # -- the main path (serving) ---------------------------------------------
    LAUNCHES.reset()
    forwards = 0
    latencies = {}
    for b in NER_SERVE_BATCHES:
        times = []
        for x in requests[b]:
            t2 = time.perf_counter()
            out = im.predict(x)
            times.append((time.perf_counter() - t2) * 1e3)
            forwards += 1
            if out.shape != (b, T, NER_TAGS) or not np.isfinite(out).all():
                raise SystemExit(f"chip_smoke: bad NER output {out.shape}")
        latencies[b] = times
    card_logits = im.predict(check)
    forwards += 1
    serve_counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    for b, times in latencies.items():
        emit({"phase": "ner_serving", "dtype": im.serving_dtype, "batch": b,
              "seq_len": T, "requests": len(times),
              "p50_ms": float(np.percentile(times, 50)),
              "p99_ms": float(np.percentile(times, 99)), "card": card})
    if serve_counts.get(fa.KERNEL_NAME, 0) != n * forwards:
        raise SystemExit(f"chip_smoke: NER serving launches {serve_counts}")
    cpu_model = BERTNER(NER_TAGS, use_flash=True, device="cpu", **cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    cpu_logits = InferenceModel(max_batch=4, device="cpu").load_keras(
        cpu_model).predict(check)
    check_logits("ner_card_f32_vs_cpu_f32", card_logits, cpu_logits,
                 LOGIT_TOL["float32"])
    del est, model, im
    torch.cuda.empty_cache()
    return {"counts": counts, "serve_counts": serve_counts}


def h2d_overlap(events, steps: int) -> dict:
    """The host-to-device copies of a trace window: device ms and bytes a
    step, their streams and the compute kernels' streams, and the share of
    copy time during which a kernel ran on another stream."""
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    kernels = sorted((e["ts"], e["ts"] + e.get("dur", 0),
                      e.get("args", {}).get("stream", e.get("tid")))
                     for e in events if e.get("cat") == "kernel")
    overlap = 0.0
    for c in copies:
        c0, c1 = c["ts"], c["ts"] + c.get("dur", 0)
        stream = c.get("args", {}).get("stream", c.get("tid"))
        spans = sorted((max(k0, c0), min(k1, c1)) for k0, k1, ks in kernels
                       if ks != stream and k1 > c0 and k0 < c1)
        end = c0
        for a, b in spans:                  # union of the kernel spans
            a = max(a, end)
            if b > a:
                overlap += b - a
                end = b
    copy_us = sum(c.get("dur", 0) for c in copies)
    return {"copies": len(copies),
            "copy_ms_per_step": copy_us / 1e3 / steps,
            "copy_bytes_per_step": sum(c.get("args", {}).get("bytes", 0)
                                       for c in copies) / steps,
            "overlapped_share": overlap / copy_us if copy_us else None,
            "copy_streams": sorted({str(c.get("args", {}).get(
                "stream", c.get("tid"))) for c in copies}),
            "kernel_streams": sorted({str(k[2]) for k in kernels}),
            "copy_kinds": sorted({c["name"] for c in copies})}


def phase_prefetch_ab(card: str, seed: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic convolutions: the two fits' losses must be bitwise
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        return _prefetch_ab(card, seed)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def _prefetch_ab(card: str, seed: int):
    first = resnet(50, IMG_CLASSES, IMG_SHAPE)
    first.ensure_built(seed=seed)
    state = {k: v.detach().clone() for k, v in first.state_dict().items()}
    models = {False: first,
              True: load_by_order(resnet(50, IMG_CLASSES, IMG_SHAPE), state)}
    rs = np.random.default_rng(seed + 140)
    B = IMG_TRAIN_BATCH
    n = B * PF_STEPS
    data = {"x": rs.random((n,) + IMG_SHAPE, dtype=np.float32),
            "y": rs.integers(0, IMG_CLASSES, n).astype(np.int32)}
    upload_bytes = data["x"][:B].nbytes + data["y"][:B].nbytes
    ests = {p: Estimator.from_keras(m, optimizer="adam", loss=IMG_LOSS)
            for p, m in models.items()}
    # the host batch path is the subject: never the device-resident data
    fit_kw = dict(epochs=1, batch_size=B, mixed_precision=True,
                  fused_optimizer=True, device_cache=False)
    warm = {"x": data["x"][:2 * B], "y": data["y"][:2 * B]}
    for p in (False, True):
        ests[p].fit(warm, prefetch=p, **fit_kw)
    torch.cuda.synchronize()

    # -- the main path, without and with the prefetcher in turns ----------
    runs = []
    for p in (False, True) * PF_TURNS:
        LAUNCHES.reset()
        t0 = time.perf_counter()
        hist = ests[p].fit(data, prefetch=p, **fit_kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = LAUNCHES.snapshot()
        # -------------------------------------------------------------------
        runs.append({"prefetch": p, "step_ms": dt / PF_STEPS * 1e3,
                     "loss": hist["loss"], "launches": counts,
                     "input_bound": gauge("training_input_bound")})
        emit(dict(runs[-1], phase="prefetch_ab", batch=B, steps=PF_STEPS,
                  card=card))
    profiles = {}
    with tempfile.TemporaryDirectory() as tmp:
        for p in (False, True):
            hist = ests[p].fit(
                {"x": data["x"][:4 * B], "y": data["y"][:4 * B]},
                prefetch=p, profile_steps=PF_PROFILE,
                profile_dir=os.path.join(tmp, str(p)), **fit_kw)
            events = load_trace_events(hist["profile_artifacts"][0])
            profiles[p] = h2d_overlap(events, PF_PROFILE[1] - PF_PROFILE[0])
            emit(dict(profiles[p], phase="prefetch_profile", prefetch=p,
                      upload_bytes_per_step=upload_bytes, card=card))
    # two instances: layer names differ, graph order does not
    bitwise = (all(a["loss"] == b["loss"] for a, b in zip(runs[::2],
                                                          runs[1::2]))
               and all(torch.equal(a, b) for a, b in zip(
                   models[False].state_dict().values(),
                   models[True].state_dict().values())))
    sweep = fad.sweep_launches(models[True].parameters())
    launches_ok = all(r["launches"] == {fad.KERNEL_NAME: PF_STEPS * sweep}
                      for r in runs)
    pageable = [r["step_ms"] for r in runs[::2]]
    pinned = [r["step_ms"] for r in runs[1::2]]
    emit({"phase": "prefetch_summary", "step_ms_pageable": pageable,
          "step_ms_prefetch": pinned,
          "median_step_ms_pageable": float(np.median(pageable)),
          "median_step_ms_prefetch": float(np.median(pinned)),
          "losses_bitwise": bitwise, "launches_ok": launches_ok,
          "upload_bytes_per_step": upload_bytes, "card": card})
    if not (bitwise and launches_ok):
        raise SystemExit("chip_smoke: prefetch A/B check failed")
    del ests, models, data
    torch.cuda.empty_cache()
    return {"counts": runs[1]["launches"]}


# the streamed path of `examples/inception_imagenet.py:147-199`: TFRecord
# shards in the ImageNet layout (`image/encoded`, `image/class/label`,
# `image/height` / `width` / `channels`, `image/filename`) holding raw
# 240×240×3 pixels, read through `TPUDataset.from_tfrecord` with 8 decode
# workers, each record cropped to 224×224 at random and mirrored at random
# (`ImageRandomCropper`, seeded from the record's file name, so the stream
# is the same at any worker count), batch 256: 5 full batches an epoch,
# the tail dropped. The JPEG legs need cv2 on the host.
TFR_SHARDS = 8
TFR_PER_SHARD = 160
TFR_STORED = (240, 240, 3)
TFR_SHUFFLE = 1024
TFR_WORKERS = 8
TFR_SPR = 4                       # the example's --steps-per-run default
TFR_STEPS = TFR_SHARDS * TFR_PER_SHARD // INC_BATCH
TFR_CHECK_BATCHES = 2
TFR_PROFILE_SHARDS = 4            # 640 records: a 2-step profiled window
TFR_PROFILE_STEPS = TFR_PROFILE_SHARDS * TFR_PER_SHARD // INC_BATCH
# the streamed fit against the in-memory fit of the same batches
TFR_LOSS_RTOL = 1e-5
TFR_JPEG_SHARDS = 2
TFR_JPEG_PER_SHARD = 64
TFR_JPEG_BATCH = 64
TFR_JPEG_STORED = (256, 320, 3)   # an aspect the scale step has to fix
TFR_JPEG_REQUESTS = 8
TFR_JPEG_TOL = 5e-4               # probabilities, f32, as IMG_PROB_TOL
TFR_THREADS = ("input-pipeline-", "train-prefetch")


def imagenet_record(encoded: bytes, shape, label: int, name: str,
                    fmt: str) -> bytes:
    """One `tf.train.Example` in the layout of TensorFlow's ImageNet
    converter (`build_imagenet_data.py`)."""
    h, w, c = shape
    return tfr.encode_example({
        "image/height": [h], "image/width": [w], "image/channels": [c],
        "image/colorspace": b"RGB", "image/format": fmt.encode(),
        "image/filename": name.encode(),
        "image/class/label": np.asarray([label], np.int64),
        "image/encoded": encoded})


def write_corpus(root: str, shards: int, per_shard: int, make_record,
                 seed: int) -> int:
    """`shards` files of `per_shard` records `make_record(rs, name)`, each
    file from its own generator of `seed`, written on the pipeline's
    workers; returns the bytes written."""
    def write(s):
        rs = np.random.default_rng([seed, s])
        path = os.path.join(root, f"train-{s:05d}-of-{shards:05d}")
        tfr.write_tfrecord(path, [make_record(rs, f"train_{s:05d}_{i:05d}")
                                  for i in range(per_shard)])
        return os.path.getsize(path)
    return sum(parallel_read(range(shards), write, workers=TFR_WORKERS))


def raw_record(rs, name: str) -> bytes:
    img = rs.integers(0, 256, TFR_STORED, dtype=np.uint8)
    return imagenet_record(img.tobytes(), TFR_STORED,
                           int(rs.integers(0, IMG_CLASSES)), name, "RAW")


def record_cropper(seed: int, ex):
    """The record's `ImageRandomCropper` at the model's size: its RNG is
    seeded from the record's file name, not shared by the workers."""
    key = zlib.crc32(ex["image/filename"][0])
    return zimage.ImageRandomCropper(IMG_SHAPE[1], IMG_SHAPE[0], mirror=True,
                                     seed=(seed * 1_000_003 + key) % 2 ** 32)


def raw_parse_fn(seed: int):
    def parse(ex):
        shape = tuple(int(ex[f"image/{k}"][0])
                      for k in ("height", "width", "channels"))
        img = np.frombuffer(ex["image/encoded"][0], np.uint8).reshape(shape)
        return (record_cropper(seed, ex)(img),
                np.int32(ex["image/class/label"][0]))
    return parse


def jpeg_parse_fn(seed: int):
    """The example's `make_parse_fn` chain (`examples/inception_imagenet.
    py:80-104`): JPEG decode, `ImageAspectScale` to a short side of
    224 + 28, the random crop and mirror."""
    import cv2
    size = IMG_SHAPE[0]
    scale = zimage.ImageAspectScale(size + size // 8)

    def parse(ex):
        raw = np.frombuffer(ex["image/encoded"][0], np.uint8)
        img = cv2.cvtColor(cv2.imdecode(raw, cv2.IMREAD_COLOR),
                           cv2.COLOR_BGR2RGB)
        img = scale(img)
        if min(img.shape[:2]) < size:
            img = cv2.resize(img, (size + size // 8, size + size // 8))
        label = int(ex["image/class/label"][0]) % IMG_CLASSES
        return (record_cropper(seed, ex)(img).astype(np.uint8),
                np.int32(label))
    return parse


def direct_batches(files, parse, seed: int, n: int):
    """The first `n` batches of `iter_train(1, seed)` built without the
    pipeline: the seeded file order, each record read by `read_records`
    and decoded by `decode_example` one at a time on this thread, the same
    shuffle window (`data/dataset.py` `_TFRecordDataset.iter_train`)."""
    rng = np.random.RandomState(seed)
    files = list(files)
    rng.shuffle(files)
    buf, pending, out = [], [], []

    def emit_one(sample):
        pending.append(sample)
        if len(pending) == INC_BATCH:
            out.append((np.stack([p[0] for p in pending]),
                        np.stack([p[1] for p in pending])))
            pending.clear()

    for path in files:
        for payload in tfr.read_records(path):
            buf.append(parse(tfr.decode_example(payload)))
            if len(buf) < TFR_SHUFFLE:
                continue
            i = rng.randint(len(buf))
            buf[i], sample = buf[-1], buf[i]
            buf.pop()
            emit_one(sample)
    rng.shuffle(buf)
    for sample in buf:
        emit_one(sample)
    return out[:n]


def batch_hashes(batches) -> list:
    return [hashlib.sha256(np.ascontiguousarray(x).tobytes()
                           + np.ascontiguousarray(y).tobytes()).hexdigest()
            for x, y, *_ in batches]


def stream_head(files, parse, seed: int, workers: int, n: int) -> list:
    ds = TPUDataset.from_tfrecord(files, parse, batch_size=INC_BATCH,
                                  shuffle_buffer=TFR_SHUFFLE,
                                  num_workers=workers)
    it = ds.iter_train(1, seed=seed)
    try:
        return list(itertools.islice(it, n))
    finally:
        it.close()


def captured_programs(model) -> dict:
    """The model's training programs: whether each is a captured graph."""
    cached = model.__dict__.get("_train_cache")
    programs = cached[1].programs if cached is not None else {}
    return {str(k): p.program.graph is not None for k, p in programs.items()}


def data_threads() -> list:
    import threading
    return [t.name for t in threading.enumerate()
            if t.name.startswith(TFR_THREADS)]


def no_data_threads(wait_s: float = 5.0) -> list:
    """The pipeline and prefetch threads still alive after `wait_s` (a
    prefetch thread exits right after its last put)."""
    deadline = time.monotonic() + wait_s
    while data_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    return data_threads()


class _StepLosses:
    """An `end_trigger` that keeps every step's loss (one step a run; the
    epoch-boundary call carries none) and never ends the fit."""

    def __init__(self):
        self.losses = []

    def __call__(self, state) -> bool:
        if not state.epoch_finished:
            self.losses.append(float(state.loss))
        return False


def streamed_vs_in_memory(state, ds, seed: int) -> dict:
    """The streamed fit against an in-memory fit (`shuffle=False`, the
    host-batch program: `device_cache=False`) of the batches the stream
    gives for the fit's seed, from the same weights with the same fit
    seed, one step a run, each step's loss kept; cuDNN deterministic."""
    batches = list(ds.iter_train(1, seed=seed))
    mem = TPUDataset.from_ndarrays(
        (np.concatenate([b[0] for b in batches]),
         np.concatenate([b[1] for b in batches])),
        batch_size=INC_BATCH, shuffle=False)
    legs = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, data, extra in (("streamed", ds, {}),
                                  ("in_memory", mem,
                                   {"device_cache": False})):
            model = load_by_order(imagenet_model(), state)
            rec = _StepLosses()
            est = Estimator.from_keras(model, optimizer="adam",
                                       loss=IMG_LOSS)
            est.fit(data, epochs=1, seed=seed, steps_per_run=1,
                    mixed_precision=True, fused_optimizer=True,
                    end_trigger=rec, **extra)
            legs[name] = (rec.losses, [p.detach().float().cpu()
                                       for p in model.parameters()])
            del est, model
    finally:
        torch.backends.cudnn.deterministic = saved
    (ls, ps), (lm, pm) = legs["streamed"], legs["in_memory"]
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(ls, lm)) \
        if len(ls) == len(lm) else float("inf")
    out = {"steps": len(ls), "losses_streamed": ls, "losses_in_memory": lm,
           "max_rel_loss_diff": rel, "losses_bitwise": ls == lm,
           "params_bitwise": all(torch.equal(a, b) for a, b in zip(ps, pm)),
           "max_rel_param_diff": max_rel_diff(ps, pm)}
    del legs, batches, mem
    torch.cuda.empty_cache()
    return out


def jpeg_legs(card: str, seed: int, est, model, fit_kw, root) -> dict:
    """Where cv2 imports: a JPEG corpus through the example's parse chain
    for 2 steps of batch 64, and `image=` JPEG requests through
    `ClusterServing` on the memory broker against the direct forward on
    `load_image`."""
    import cv2
    from analytics_zoo_tpu_torch.serving.server import ClusterServing

    def jpeg_record(rs, name):
        img = rs.integers(0, 256, TFR_JPEG_STORED, dtype=np.uint8)
        ok, enc = cv2.imencode(".jpg", img)
        assert ok
        return imagenet_record(enc.tobytes(), TFR_JPEG_STORED,
                               int(rs.integers(0, IMG_CLASSES)), name,
                               "JPEG")

    jroot = os.path.join(root, "jpeg")
    os.makedirs(jroot)
    write_corpus(jroot, TFR_JPEG_SHARDS, TFR_JPEG_PER_SHARD, jpeg_record,
                 seed + 121)
    ds = TPUDataset.from_tfrecord(os.path.join(jroot, "train-*"),
                                  jpeg_parse_fn(seed),
                                  batch_size=TFR_JPEG_BATCH,
                                  shuffle_buffer=TFR_SHUFFLE,
                                  num_workers=TFR_WORKERS)
    steps = TFR_JPEG_SHARDS * TFR_JPEG_PER_SHARD // TFR_JPEG_BATCH
    LAUNCHES.reset()
    t0 = time.perf_counter()
    hist = est.fit(ds, seed=seed, **fit_kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    train = {"steps": steps, "batch": TFR_JPEG_BATCH,
             "stored": list(TFR_JPEG_STORED), "loss": hist["loss"],
             "fit_s": fit_s, "launches": counts}
    train_ok = (all(math.isfinite(v) for v in hist["loss"])
                and counts.get(dr.KERNEL_NAME, 0) == 2 * steps
                and counts.get(fad.KERNEL_NAME, 0) == steps)

    rs = np.random.default_rng(seed + 122)
    jpegs = []
    for _ in range(TFR_JPEG_REQUESTS):
        img = rs.integers(0, 256, IMG_SHAPE, dtype=np.uint8)
        ok, enc = cv2.imencode(".jpg", img)
        assert ok
        jpegs.append(enc.tobytes())
    im = InferenceModel(max_batch=TFR_JPEG_REQUESTS).load_keras(model)
    im.warmup(np.zeros(IMG_SHAPE, np.float32))
    want = im.predict(np.stack([zimage.load_image(b).astype(np.float32)
                                for b in jpegs]))
    engine = ClusterServing(im, broker=MemoryBroker(),
                            batch_size=TFR_JPEG_REQUESTS)
    engine.start()
    try:
        q = InputQueue(engine.broker)
        uris = [q.enqueue(f"jpeg{i}", image=b) for i, b in enumerate(jpegs)]
        out, res = OutputQueue(engine.broker), {}
        deadline = time.monotonic() + 60
        while len(res) < len(uris) and time.monotonic() < deadline:
            res.update(out.query_many([u for u in uris if u not in res],
                                      delete=True))
            time.sleep(0.01)
    finally:
        _stop_timed(engine)
    err = _answers("jpeg serving", [res.get(u) for u in uris],
                   range(len(uris)), want, TFR_JPEG_TOL)
    serve = {"requests": len(uris), "max_abs_err": err,
             "tol": TFR_JPEG_TOL}
    del im
    torch.cuda.empty_cache()
    emit({"phase": "imagenet_tfrecord_jpeg", "train": train,
          "serving": serve, "ok": train_ok, "card": card})
    if not train_ok:
        raise SystemExit("chip_smoke: JPEG TFRecord fit check failed")
    return {"train": train, "serving": serve}


def phase_imagenet_tfrecord(card: str, seed: int, in_memory_step_ms: float):
    """The ImageNet model of `examples/inception_imagenet.py` trained at
    batch 256 (`mixed_precision=True`, `fused_optimizer=True`) from
    TFRecord shards streamed through `TPUDataset.from_tfrecord` and the
    parallel shard pipeline: the stream held against a serial read, a warm
    streamed epoch, then the timed streamed epoch (the main path), a
    profiled window, the streamed fit against an in-memory fit of the same
    batches, and the JPEG legs where cv2 imports."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if tfr._native_lib() is None:
        raise SystemExit("chip_smoke: the native TFRecord scanner did not "
                         "build (g++)")
    root = tempfile.mkdtemp(prefix="azt_imagenet_tfr_")
    try:
        return _imagenet_tfrecord(card, seed, in_memory_step_ms, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _imagenet_tfrecord(card: str, seed: int, in_memory_step_ms: float,
                       root: str):
    t0 = time.perf_counter()
    corpus_bytes = write_corpus(root, TFR_SHARDS, TFR_PER_SHARD, raw_record,
                                seed + 120)
    write_s = time.perf_counter() - t0
    files = tfr.expand_files(os.path.join(root, "train-*"))
    parse = raw_parse_fn(seed)

    # -- the stream at 1 and at 8 workers against a serial read -----------
    t0 = time.perf_counter()
    heads = {w: batch_hashes(stream_head(files, parse, seed, w,
                                         TFR_CHECK_BATCHES))
             for w in (1, TFR_WORKERS)}
    direct = batch_hashes(direct_batches(files, parse, seed,
                                         TFR_CHECK_BATCHES))
    stream_ok = (heads[1] == heads[TFR_WORKERS] == direct
                 and len(direct) == TFR_CHECK_BATCHES)
    emit({"phase": "imagenet_tfrecord_stream", "shards": TFR_SHARDS,
          "records": TFR_SHARDS * TFR_PER_SHARD,
          "stored": list(TFR_STORED), "corpus_bytes": corpus_bytes,
          "corpus_write_s": write_s, "native_scanner": True,
          "batch_sha256": {"workers_1": heads[1],
                           f"workers_{TFR_WORKERS}": heads[TFR_WORKERS],
                           "serial_read": direct},
          "check_s": time.perf_counter() - t0, "ok": stream_ok,
          "card": card})
    if not stream_ok:
        raise SystemExit("chip_smoke: the TFRecord stream differs across "
                         "worker counts or from the serial read")

    model = imagenet_model()
    model.ensure_built(seed=seed)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sweep = fad.sweep_launches(model.parameters())
    ds = TPUDataset.from_tfrecord(os.path.join(root, "train-*"), parse,
                                  batch_size=INC_BATCH,
                                  shuffle_buffer=TFR_SHUFFLE,
                                  num_workers=TFR_WORKERS)
    est = Estimator.from_keras(model, optimizer="adam", loss=IMG_LOSS)
    fit_kw = dict(epochs=1, steps_per_run=TFR_SPR, mixed_precision=True,
                  fused_optimizer=True)
    # the warm epoch runs on the stream itself: in-memory batches of this
    # size would fit the device cache and capture another program
    t0 = time.perf_counter()
    est.fit(ds, seed=seed, **fit_kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    builds = _build.build_events()
    programs = captured_programs(model)

    # the example's producer shim (`examples/inception_imagenet.py:186-199`):
    # the seconds the prefetch thread waits on each batch of the stream
    stats = {"stall_s": 0.0, "batches": 0}
    orig_iter = ds.iter_train

    def timed_iter(dp, seed=0):
        it = orig_iter(dp, seed)
        try:
            while True:
                t1 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                stats["stall_s"] += time.perf_counter() - t1
                stats["batches"] += 1
                yield item
        finally:
            it.close()

    ds.iter_train = timed_iter
    # -- the main path: every count is 0 just before, read just after -----
    LAUNCHES.reset()
    t1 = time.perf_counter()
    hist = est.fit(ds, seed=seed, **fit_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    ds.iter_train = orig_iter
    from analytics_zoo_tpu_torch.learn import trainer
    input_bound = gauge("training_input_bound")
    builds_after = _build.build_events()
    programs_after = captured_programs(model)
    new_sources = trainer.program_sources(model)
    steps = stats["batches"]
    step_ms = dt / max(1, steps) * 1e3
    producer_ms = stats["stall_s"] / max(1, steps) * 1e3
    expected = {dr.KERNEL_NAME: 2, fad.KERNEL_NAME: sweep}
    per_step = {k: counts.get(k, 0) / max(1, steps) for k in expected}
    threads_left = no_data_threads()
    out = {"phase": "imagenet_tfrecord_train", "model": "inception_v1",
           "input": list(IMG_SHAPE), "input_dtype": "uint8",
           "classes": IMG_CLASSES, "batch": INC_BATCH, "steps": steps,
           "steps_per_run": TFR_SPR, "workers": TFR_WORKERS,
           "shuffle_buffer": TFR_SHUFFLE, "warm_fit_s": warm_s,
           "epoch_s": dt, "step_ms": step_ms,
           "images_per_s": steps * INC_BATCH / dt,
           "producer_ms_per_batch": producer_ms,
           "input_pipeline_share": producer_ms / step_ms,
           "training_input_bound": input_bound,
           "in_memory_step_ms": in_memory_step_ms, "loss": hist["loss"],
           "launches": counts, "launches_per_step": per_step,
           "expected_per_step": expected, "builds_before": builds,
           "builds_after": builds_after, "programs": programs,
           "programs_after": programs_after,
           "new_program_sources": new_sources,
           "threads_left": threads_left, "card": card}
    emit(out)
    if steps != TFR_STEPS or per_step != {k: float(v)
                                          for k, v in expected.items()}:
        raise SystemExit(f"chip_smoke: streamed ImageNet steps {steps}, "
                         f"launches per step {per_step}, expected "
                         f"{TFR_STEPS} and {expected}")
    if builds_after != builds or programs_after != programs \
            or not all(programs.values()) or new_sources:
        raise SystemExit("chip_smoke: the timed streamed epoch built a "
                         "kernel or captured a program")
    if threads_left or not all(math.isfinite(v) for v in hist["loss"]):
        raise SystemExit(f"chip_smoke: streamed ImageNet fit: threads "
                         f"{threads_left}, loss {hist['loss']}")

    # the card's idle share over a streamed 2-step window (its program
    # captured by the profiler's untraced warm-up fit)
    ds_prof = TPUDataset.from_tfrecord(files[:TFR_PROFILE_SHARDS], parse,
                                       batch_size=INC_BATCH,
                                       shuffle_buffer=TFR_SHUFFLE,
                                       num_workers=TFR_WORKERS)
    dev, classes, top = profile_classes(
        lambda: est.fit(ds_prof, seed=seed, **fit_kw), 1)
    dev /= TFR_PROFILE_STEPS
    emit({"phase": "imagenet_tfrecord_profile", "steps": TFR_PROFILE_STEPS,
          "device_ms_per_step": dev, "step_ms": step_ms,
          "idle_share": (1.0 - dev / step_ms) if dev else None,
          "by_class": {k: {"ms": v["ms"] / TFR_PROFILE_STEPS,
                           "calls": v["calls"] / TFR_PROFILE_STEPS}
                       for k, v in classes.items()},
          "top": top[:6], "card": card})

    cmp = streamed_vs_in_memory(state, ds, seed)
    cmp_ok = (cmp["steps"] == TFR_STEPS
              and cmp["max_rel_loss_diff"] <= TFR_LOSS_RTOL
              and all(math.isfinite(v) for v in cmp["losses_streamed"]))
    emit(dict(cmp, phase="imagenet_tfrecord_vs_in_memory",
              tol=TFR_LOSS_RTOL, ok=cmp_ok, card=card))
    if not cmp_ok:
        raise SystemExit("chip_smoke: the streamed fit's losses differ from "
                         "the in-memory fit's")

    try:
        import cv2  # noqa: F401
    except ImportError:
        jpeg = None
        emit({"phase": "imagenet_tfrecord_jpeg", "ran": False,
              "reason": "cv2 does not import on this host: the JPEG "
              "legs did not run here (the CPU tests cover them)",
              "card": card})
    else:
        jpeg = jpeg_legs(card, seed, est, model, fit_kw, root)
    left = no_data_threads()
    if left:
        raise SystemExit(f"chip_smoke: data threads left: {left}")
    del est, model, ds, ds_prof
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "step_ms": step_ms, "jpeg": jpeg,
            "idle_share": (1.0 - dev / step_ms) if dev else None}


# ---------------------------------------------------------------------------
# the distributed slice (`phase_distributed`): 2 gloo ranks on the card,
# NCCL at world size 1
# ---------------------------------------------------------------------------
DIST_RANKS = 2
DIST_BATCH = 32             # the global batch: 16 rows a rank
DIST_STEPS = 4
DIST_RING = (4, 12, 2048, 64)   # B, H, T, D: T split over the 2 ranks
DIST_PIPE = (2, 4, 8)       # stages, microbatches, rows (2 a microbatch)
DIST_NCCL_STEPS = 4
# the sharded bf16 fit against the one-process fit, 4 steps, dropout 0:
# the same kernels and weights, but each rank's GEMMs run over 16 rows
# (cuBLAS may tile them otherwise) and its bf16 weight gradients are
# rounded per half batch before the f32 mean; the same rounding argument
# and bound as the kernel-vs-plain check (`BF16_LOSS_TOL`)
DIST_LOSS_TOL = BF16_LOSS_TOL
# the ring's blocks against the one-process flash kernels at full length,
# each error relative to the largest magnitude of the compared tensor:
# f32 SIMT blocks merged in f32 by lse (a few ulps); bf16 blocks return O
# rounded to bf16 (2^-9 relative) before the f32 merge, which is rounded
# again, and the backward adds the blocks' bf16 dQ / dK / dV in f32: a
# few bf16 ulps of the largest value
DIST_RING_TOL = {torch.float32: {"o": 1e-5, "grad": 1e-4},
                 torch.bfloat16: {"o": 2e-2, "grad": 3e-2}}
# the pipeline against the sequential stack: the same blocks on the same
# microbatches (f32, exact copies between the stages)
DIST_PIPE_TOL = 1e-5


def _dist_global_data(seed: int):
    rs = np.random.default_rng(seed + 70)
    return make_training_data(rs, DIST_BATCH * DIST_STEPS, BERT_BASE)


def _dist_rows(index: int, n: int):
    """The rows of the global data rank `index` of `n` feeds: its half of
    every global batch."""
    share = DIST_BATCH // n
    return np.concatenate([np.arange(b * DIST_BATCH + index * share,
                                     b * DIST_BATCH + (index + 1) * share)
                           for b in range(DIST_STEPS)])


def _dist_fit(model, data, steps: int, warm: bool = False, **kw):
    """A bf16 fused-AdamW fit of `model` on `data`: `steps` steps, one an
    epoch, step e on the e-th block of `len(y) / steps` rows (this rank's
    share of the e-th global batch), so the history holds every step's
    loss: (losses, host seconds a step, every kernel count of the fit,
    counted from 0 just before it). With `warm`, a second fit of the same
    data follows, and the seconds a step are its (the first step of a fit
    harvests its counted cost and, on NCCL or without a process group,
    captures its program)."""
    model.compile(optimizer=optimizers.fused_adam(
        learning_rate=ADAM_HP["lr"], b1=ADAM_HP["b1"], b2=ADAM_HP["b2"],
        eps=ADAM_HP["eps"], weight_decay=ADAM_HP["weight_decay"]),
        loss=objectives.get("sparse_categorical_crossentropy",
                            from_logits=True))
    from analytics_zoo_tpu_torch.learn import trainer
    rows = len(data["y"]) // steps

    def batches(epoch):
        at = slice(epoch * rows, (epoch + 1) * rows)
        return iter([([a[at] for a in data["x"]], data["y"][at], rows)])
    # each rank reads its own rows
    batches.shards_per_host = True

    def fit():
        t0 = time.perf_counter()
        h = trainer.fit_keras(model, None, None, batch_size=DIST_BATCH,
                              epochs=steps, batch_iter_factory=batches,
                              mixed_precision=True, prefetch=False, **kw)
        torch.cuda.synchronize()
        return h["loss"], (time.perf_counter() - t0) / steps
    LAUNCHES.reset()
    losses, step_s = fit()
    counts = LAUNCHES.snapshot()
    if warm:
        step_s = fit()[1]
    return losses, step_s, counts


def _ring_leg(mesh, dtype, seed: int) -> dict:
    """The ring on this rank's block of a seq-2048 input against the
    one-process flash kernels at full length (its gradients too) and
    against the ring's plain path on the card."""
    from analytics_zoo_tpu_torch.parallel import ring_attention as ra
    B, H, T, D = DIST_RING
    g = torch.Generator().manual_seed(seed + 80)
    q, k, v, do = (torch.randn(B, H, T, D, generator=g).to("cuda", dtype)
                   for _ in range(4))
    lengths = torch.tensor([T, T * 7 // 8, T * 5 // 8, T // 3])[:B]
    mask = padding_mask(lengths, T).view(B, T).cuda()
    n, i = mesh.size("sequence"), mesh.coordinate("sequence")
    sl = slice(i * (T // n), (i + 1) * (T // n))
    ql, kl, vl = (t[:, :, sl].contiguous().requires_grad_()
                  for t in (q, k, v))
    ml = mask[:, sl].contiguous()
    LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = ra.ring_attention(ql, kl, vl, ml, mesh=mesh)
    o.backward(do[:, :, sl])
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    # the one-process flash kernels at full length
    qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
    of = fa.flash_attention(qf, kf, vf, mask[:, None, None].contiguous())
    of.backward(do)
    # the ring's plain path (the JAX body's einsum online softmax)
    qp, kp, vp = (t[:, :, sl].contiguous().requires_grad_()
                  for t in (q, k, v))
    op = ra._ring_plain(qp, kp, vp, ml, mesh, "sequence")
    op.backward(do[:, :, sl])
    tol = DIST_RING_TOL[dtype]

    def err(a, b):
        """max |a - b| over max |b|"""
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()
    row = {"dtype": str(dtype).replace("torch.", ""), "shape": DIST_RING,
           "block": [B, H, T // n, D], "launches": counts,
           "ring_fwd_bwd_s": ring_s,
           "o_err": err(o, of[:, :, sl]),
           "dq_err": err(ql.grad, qf.grad[:, :, sl]),
           "dk_err": err(kl.grad, kf.grad[:, :, sl]),
           "dv_err": err(vl.grad, vf.grad[:, :, sl]),
           "plain_o_err": err(o, op),
           "plain_grad_err": max(err(a.grad, b.grad) for a, b in
                                 ((ql, qp), (kl, kp), (vl, vp))),
           "tol": tol}
    row["ok"] = (row["o_err"] <= tol["o"] and row["plain_o_err"] <= tol["o"]
                 and max(row["dq_err"], row["dk_err"], row["dv_err"],
                         row["plain_grad_err"]) <= tol["grad"]
                 and counts.get(fa.KERNEL_NAME, 0) == n
                 and counts.get(fa.BWD_DKV_NAME, 0) == n
                 and counts.get(fa.BWD_DQ_NAME, 0) == n)
    return row


def _pipeline_leg(mesh, seed: int) -> dict:
    """12 BERT-base blocks as 2 stages of 6 over 4 microbatches, f32,
    against the sequential stack on the same microbatches: outputs and the
    blocks' gradients."""
    from torch.func import functional_call
    from analytics_zoo_tpu_torch.keras.transformer import \
        TransformerEncoderBlock
    from analytics_zoo_tpu_torch.parallel.pipeline import (
        from_microbatches, pipeline_apply, to_microbatches)
    S, M, rows = DIST_PIPE
    cfg = BERT_BASE
    per = cfg["n_block"] // S
    torch.manual_seed(seed + 90)
    blocks = [TransformerEncoderBlock(
        cfg["hidden_size"], cfg["n_head"], cfg["intermediate_size"],
        hidden_dropout=0.0, attn_dropout=0.0, use_flash=True, device="cuda",
        name=f"pipe_block{j}").build(torch.Generator().manual_seed(seed + j))
        for j in range(cfg["n_block"])]
    names = [n for n, _ in blocks[0].named_parameters()]
    template = blocks[0]
    stacked = {f"b{j}.{n}": torch.stack([
        dict(blocks[s * per + j].named_parameters())[n].detach()
        for s in range(S)]).requires_grad_()
        for j in range(per) for n in names}

    def stage_fn(p, x):
        for j in range(per):
            x = functional_call(template, {n: p[f"b{j}.{n}"] for n in names},
                                (x,))
        return x

    g = torch.Generator().manual_seed(seed + 91)
    x = torch.randn(rows, 256, cfg["hidden_size"], generator=g).cuda()
    mbs = to_microbatches(x, M)
    LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = pipeline_apply(stage_fn, stacked, mbs, mesh)
    (y ** 2).mean().backward()
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    grads = {k: mesh.all_reduce(v.grad.clone(), ("pipeline",))
             for k, v in stacked.items()}
    # the sequential stack on the same microbatches
    ref_params = {k: v.detach().clone().requires_grad_()
                  for k, v in stacked.items()}
    outs = []
    for mb in mbs:
        h = mb
        for s in range(S):
            h = stage_fn({k: v[s] for k, v in ref_params.items()}, h)
        outs.append(h)
    y_ref = torch.stack(outs)
    (y_ref ** 2).mean().backward()
    y_err = (from_microbatches(y.detach()) - from_microbatches(
        y_ref.detach())).abs().max().item()
    g_err = max(((grads[k] - ref_params[k].grad).abs().max()
                 / ref_params[k].grad.abs().max().clamp_min(1e-30)).item()
                for k in stacked)
    return {"stages": S, "microbatches": M, "rows": rows, "seq": 256,
            "blocks_per_stage": per, "launches": counts, "fwd_bwd_s": pipe_s,
            "y_err": y_err, "grad_rel_err": g_err, "tol": DIST_PIPE_TOL,
            "ok": y_err <= DIST_PIPE_TOL and g_err <= DIST_PIPE_TOL}


def dist_worker(out: str, seed: str):
    """One rank of `phase_distributed`'s gloo group on the card: the
    sharded BERT-base fit (leg A), the ring (leg B) and the pipeline (leg
    C); its results into `<out>/rank<r>.json`."""
    from analytics_zoo_tpu_torch.common import mesh as mesh_mod
    from analytics_zoo_tpu_torch.common.context import init_orca_context
    from analytics_zoo_tpu_torch.common.mesh import DeviceMesh
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.observability.registry import get_registry
    seed = int(seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = init_orca_context(data=1, fsdp=DIST_RANKS)
    mesh = ctx.mesh
    r = mesh.rank
    res = {"rank": r, "backend": mesh.backend, "device": str(mesh.device),
           "mesh": repr(mesh), "routes": mesh.routes()}
    # leg A: the sharded fit, this rank's half of every global batch
    data = _dist_global_data(seed)
    rows = _dist_rows(mesh.batch_index, mesh.data_parallel_size)
    local = {"x": [a[rows] for a in data["x"]], "y": data["y"][rows]}
    state = convert.params_from_jax(random_classifier_tree(
        BERT_BASE, NUM_CLASSES, seed))
    mesh_mod.reset_collective_stats()
    model = new_model(state, hidden_drop=0.0, attn_drop=0.0, dropout=0.0)
    losses, step_s, counts = _dist_fit(model, local, DIST_STEPS, warm=True,
                                       sharding_rules=True)
    reg = get_registry()
    res["fit"] = {"losses": losses, "step_ms": step_s * 1e3,
                  "launches": counts,
                  "state_bytes": reg.gauge(
                      "training_state_bytes_per_rank").value(),
                  "graphs": reg.gauge("training_step_graphs").value(),
                  "collective_ms_per_step": reg.gauge(
                      "training_collective_ms").value(),
                  "collectives": mesh_mod.collective_stats()}
    del model
    model = new_model(state, hidden_drop=0.1, attn_drop=0.1, dropout=0.1)
    one = {"x": [a[:DIST_BATCH // DIST_RANKS] for a in local["x"]],
           "y": local["y"][:DIST_BATCH // DIST_RANKS]}
    d_losses, _, d_counts = _dist_fit(model, one, 1, sharding_rules=True)
    res["dropout_step"] = {"loss": d_losses, "launches": d_counts}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # leg B: the ring on a sequence axis of 2 over the same ranks
    mesh_mod.reset_collective_stats()
    ring_mesh = DeviceMesh(MeshConfig(data=1, sequence=DIST_RANKS),
                           device=mesh.device)
    res["ring"] = [_ring_leg(ring_mesh, dt, seed)
                   for dt in (torch.float32, torch.bfloat16)]
    res["ring_collectives"] = mesh_mod.collective_stats()
    # leg C: the pipeline on a pipeline axis of 2
    mesh_mod.reset_collective_stats()
    pipe_mesh = DeviceMesh(MeshConfig(data=1, pipeline=DIST_RANKS),
                           device=mesh.device)
    res["pipeline"] = _pipeline_leg(pipe_mesh, seed)
    res["pipeline_collectives"] = mesh_mod.collective_stats()
    with open(os.path.join(out, f"rank{r}.json"), "w") as fh:
        json.dump(res, fh, default=str)


def nccl_leg(out: str, seed: int) -> None:
    """Leg D, run by `zoo-launch --nproc 1` as its script: the graphed
    BERT-base step with its gradient all-reduce over NCCL at world size 1
    against the non-distributed graphed fit, bitwise, under deterministic
    algorithms."""
    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.common import mesh as mesh_mod
    from analytics_zoo_tpu_torch.learn import trainer
    from analytics_zoo_tpu_torch.observability.registry import get_registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    rs = np.random.default_rng(seed + 71)
    data = make_training_data(rs, DIST_BATCH * DIST_NCCL_STEPS, BERT_BASE)
    state = convert.params_from_jax(random_classifier_tree(
        BERT_BASE, NUM_CLASSES, seed))
    res = {}
    model = new_model(state, hidden_drop=0.1, attn_drop=0.1, dropout=0.1)
    res["plain_losses"], _, _ = _dist_fit(model, data, DIST_NCCL_STEPS)
    res["plain_sources"] = trainer.program_sources(model)
    want = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    ctx = zoo.init_orca_context(cluster_mode="multi-host")
    mesh_mod.reset_collective_stats()
    model = new_model(state, hidden_drop=0.1, attn_drop=0.1, dropout=0.1)
    res["losses"], step_s, res["launches"] = _dist_fit(model, data,
                                                       DIST_NCCL_STEPS)
    res["step_ms"] = step_s * 1e3
    res["sources"] = trainer.program_sources(model)
    res["backend"] = ctx.mesh.backend
    res["mesh"] = repr(ctx.mesh)
    res["collectives"] = mesh_mod.collective_stats()
    res["graphs"] = get_registry().gauge("training_step_graphs").value()
    res["bitwise"] = res["losses"] == res["plain_losses"] and all(
        torch.equal(v, want[k]) for k, v in model.state_dict().items())
    zoo.stop_orca_context()
    with open(out, "w") as fh:
        json.dump(res, fh, default=str)


def phase_distributed(card: str, seed: int) -> dict:
    """The distributed slice on the one card: a 2-rank gloo group (NCCL
    refuses two ranks on one device) runs the sharded BERT-base fit, the
    ring and the pipeline; the one-process replicated fit of the same
    weights and global batches runs here; then `zoo-launch --nproc 1` runs
    the NCCL leg at world size 1."""
    from analytics_zoo_tpu_torch.common import launch as zlaunch
    from analytics_zoo_tpu_torch.common import mesh as mesh_mod
    from analytics_zoo_tpu_torch.common.cluster import (launch_local_cluster,
                                                        wait_all)
    from analytics_zoo_tpu_torch.observability.registry import get_registry
    torch.backends.cuda.matmul.allow_tf32 = False
    repo = os.path.dirname(os.path.abspath(__file__))
    emit({"phase": "distributed_routes", "card": card,
          "routes": mesh_mod.route_table()})
    # the one-process replicated fit of the same weights and global batches
    data = _dist_global_data(seed)
    state = convert.params_from_jax(random_classifier_tree(
        BERT_BASE, NUM_CLASSES, seed))
    model = new_model(state, hidden_drop=0.0, attn_drop=0.0, dropout=0.0)
    ref_losses, ref_step_s, _ = _dist_fit(model, data, DIST_STEPS,
                                          warm=True)
    ref_bytes = get_registry().gauge("training_state_bytes_per_rank").value()
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="chip-dist-")
    env = {"PYTHONPATH": os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    wait_all(launch_local_cluster("chip_smoke:dist_worker", DIST_RANKS,
                                  worker_args=[out, str(seed)], env=env,
                                  platform="cuda"), timeout=600)
    group_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json")))
             for r in range(DIST_RANKS)]
    # leg D: NCCL at world size 1, through the launcher a user runs
    nccl_out = os.path.join(out, "nccl.json")
    t0 = time.perf_counter()
    rc = zlaunch.main(["--nproc", "1", "--timeout", "300",
                       os.path.join(repo, "chip_smoke.py"),
                       "--nccl-leg", nccl_out, "--seed", str(seed)])
    nccl_s = time.perf_counter() - t0
    nccl = json.load(open(nccl_out)) if rc == 0 else {"rc": rc}
    shutil.rmtree(out, ignore_errors=True)

    fails = []
    for res in ranks:
        fit = res["fit"]
        err = max(abs(a - b) for a, b in zip(fit["losses"], ref_losses))
        per_step = {k: v / DIST_STEPS for k, v in fit["launches"].items()}
        fit.update(loss_err=err, loss_tol=DIST_LOSS_TOL,
                   replicated_state_bytes=ref_bytes,
                   state_share=fit["state_bytes"] / ref_bytes,
                   replicated_step_ms=ref_step_s * 1e3,
                   launches_per_step=per_step)
        emit({"phase": "distributed_fit", "card": card, "rank": res["rank"],
              "backend": res["backend"], "mesh": res["mesh"],
              "ref_losses": ref_losses, **fit,
              "dropout_step": res["dropout_step"]})
        for row in res["ring"]:
            emit({"phase": "distributed_ring", "card": card,
                  "rank": res["rank"], **row})
        emit({"phase": "distributed_pipeline", "card": card,
              "rank": res["rank"], **res["pipeline"],
              "collectives": res["pipeline_collectives"]})
        if err > DIST_LOSS_TOL:
            fails.append(f"rank {res['rank']} loss {err}")
        if not 0.4 < fit["state_share"] < 0.6:
            fails.append(f"rank {res['rank']} state share "
                         f"{fit['state_share']}")
        if per_step.get(fa.KERNEL_NAME) != BERT_BASE["n_block"] \
                or per_step.get(fa.BWD_DKV_NAME) != BERT_BASE["n_block"] \
                or per_step.get(fa.BWD_DQ_NAME) != BERT_BASE["n_block"] \
                or per_step.get(fad.KERNEL_NAME) != 1:
            fails.append(f"rank {res['rank']} launches {per_step}")
        if not res["dropout_step"]["launches"].get(dr.KERNEL_NAME):
            fails.append(f"rank {res['rank']} no dropout launch")
        fails += [f"rank {res['rank']} ring {row['dtype']}"
                  for row in res["ring"] if not row["ok"]]
        if not res["pipeline"]["ok"]:
            fails.append(f"rank {res['rank']} pipeline")
    emit({"phase": "distributed_collectives", "card": card,
          "fit": {r["rank"]: r["fit"]["collectives"] for r in ranks},
          "ring": {r["rank"]: r["ring_collectives"] for r in ranks},
          "host_staged": {r["rank"]: {
              leg: {k: v["host_staged"] for k, v in stats.items()
                    if v["host_staged"]}
              for leg, stats in (("fit", r["fit"]["collectives"]),
                                 ("ring", r["ring_collectives"]),
                                 ("pipeline", r["pipeline_collectives"]))}
              for r in ranks},
          "group_s": group_s})
    emit({"phase": "distributed_nccl", "card": card, "seconds": nccl_s,
          **nccl})
    if not nccl.get("bitwise") or nccl.get("backend") != "nccl" \
            or not nccl.get("graphs"):
        fails.append("nccl leg")
    if fails:
        raise SystemExit(f"chip_smoke: distributed checks failed: {fails}")
    counts = {}
    for name in (fa.KERNEL_NAME, fa.BWD_DKV_NAME, fa.BWD_DQ_NAME,
                 dr.KERNEL_NAME, fad.KERNEL_NAME):
        counts[name] = {
            "sharded_fit_rank0": ranks[0]["fit"]["launches"].get(name, 0),
            "dropout_step_rank0":
                ranks[0]["dropout_step"]["launches"].get(name, 0),
            "ring_rank0": sum(row["launches"].get(name, 0)
                              for row in ranks[0]["ring"]),
            "nccl_fit": nccl.get("launches", {}).get(name, 0)}
    return {"counts": counts}


BY_EVENTS = {"ms": "events", "plain_ms": "events", "library_ms": "events"}
BY_GRAPH = {"ms": "graph", "plain_ms": "graph", "library_ms": "graph"}
# the backward kernels: SDPA's backward (fwd+bwd minus fwd) by CUDA graph,
# beside the pair's graph time (`pair_graph_ms`)
BWD_TIMED_BY = dict(BY_EVENTS, library_ms="graph")


def timed_by(row, ms_key: str) -> dict:
    """An entry's `timed_by` from a row timed by `device_ms`."""
    t = row["timed_by"]
    return {"ms": t[ms_key], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"]}


def kernel_entries(attn, bwd, drop, adam, serve_counts, train_counts,
                   adrop, segs, ncf_counts):
    """The `kernels` line: every kernel with its numbers at the main
    path's shape and dtype and its verdict."""
    main_fwd = attn[(MAIN_SHAPE, True, torch.float32)]
    fwd16 = attn[(MAIN_SHAPE, True, torch.bfloat16)]
    main_bwd = bwd[BWD_MAIN]
    bwd_ok = all(r["ok"] for r in bwd.values())
    drop_main = drop[torch.bfloat16]
    adam_main = adam[torch.float32]
    shape, dtype = BWD_MAIN[0], BWD_MAIN[2]
    dkv_bound, dq_bound = main_bwd["dkv_bound"], main_bwd["dq_bound"]
    entries = {
        fa.KERNEL_NAME: dict(
            launches=serve_counts.get(fa.KERNEL_NAME, 0),
            launches_training=train_counts.get(fa.KERNEL_NAME, 0),
            max_abs_err=main_fwd["max_abs_err_o"], ms=main_fwd["kernel_ms"],
            plain_ms=main_fwd["plain_ms"], bound_ms=main_fwd["bound_ms"],
            bound_by=main_fwd["bound_by"],
            library_ms=main_fwd["library_ms"], timed_by=BY_EVENTS,
            ms_dropout=main_fwd["kernel_ms_dropout"],
            shape=main_fwd["shape"], dtype=main_fwd["dtype"],
            bf16={key: fwd16[key] for key in (
                "max_abs_err_o", "max_abs_err_lse", "kernel_ms",
                "kernel_ms_dropout", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "kernel_graph_ms", "kernel_graph_ms_dropout",
                "library_graph_ms")},
            verdict="ok" if all(r["ok"] for r in attn.values()) and all(
                r["ok"] for r in adrop) else "fail"),
        fa.BWD_DKV_NAME: dict(
            launches=train_counts.get(fa.BWD_DKV_NAME, 0),
            max_abs_err=max(main_bwd["rel_err"]["dk"],
                            main_bwd["rel_err"]["dv"]),
            ms=main_bwd["dkv_ms"], ms_dropout=main_bwd["dkv_ms_dropout"],
            plain_ms=main_bwd["plain_ms"],
            bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
            library_ms=main_bwd["library_ms"], timed_by=BWD_TIMED_BY,
            pair_graph_ms=main_bwd["kernel_graph_ms"],
            shape=list(shape), dtype=str(dtype)[6:],
            verdict="ok" if bwd_ok else "fail"),
        fa.BWD_DQ_NAME: dict(
            launches=train_counts.get(fa.BWD_DQ_NAME, 0),
            max_abs_err=main_bwd["rel_err"]["dq"], ms=main_bwd["dq_ms"],
            ms_dropout=main_bwd["dq_ms_dropout"],
            plain_ms=main_bwd["plain_ms"], bound_ms=dq_bound[0],
            bound_by=dq_bound[1], library_ms=main_bwd["library_ms"],
            timed_by=BWD_TIMED_BY, pair_graph_ms=main_bwd["kernel_graph_ms"],
            shape=list(shape), dtype=str(dtype)[6:],
            verdict="ok" if bwd_ok else "fail"),
        dr.KERNEL_NAME: dict(
            launches=train_counts.get(dr.KERNEL_NAME, 0),
            max_abs_err=drop_main["max_abs_err"], ms=drop_main["kernel_ms"],
            wall_ms=drop_main["wall_ms"],
            plain_ms=drop_main["plain_ms"], bound_ms=drop_main["bound_ms"],
            bound_by="bytes", library_ms=drop_main["library_ms"],
            timed_by=timed_by(drop_main, "kernel_ms"),
            shape=drop_main["shape"], dtype=drop_main["dtype"],
            verdict="ok" if all(r["ok"] for r in drop.values()) else "fail"),
        fad.KERNEL_NAME: dict(
            launches=train_counts.get(fad.KERNEL_NAME, 0),
            max_abs_err=adam_main["max_abs_err"],
            ms=adam_main["kernel_ms_per_sweep"], wall_ms=adam_main["wall_ms"],
            plain_ms=adam_main["plain_ms"], bound_ms=adam_main["bound_ms"],
            bound_by=adam_main["bound_by"],
            library_ms=adam_main["library_ms"],
            timed_by=timed_by(adam_main, "kernel_ms_per_sweep"),
            shape=(f"{adam_main['leaves']} BERT-base leaves, one sweep: "
                   f"{adam_main['launches_per_sweep']} launch(es) of up to "
                   f"{fad.MAX_LEAVES} leaves, chunks of {fad.CHUNK} "
                   f"elements"),
            dtype=adam_main["param_dtype"],
            host_ms=adam_main["host_ms"],
            one_leaf_a_launch=adam_main["one_leaf_a_launch"],
            launch_config=adam["edges"]["config"],
            launches_ncf=ncf_counts.get(fad.KERNEL_NAME, 0),
            verdict="ok" if all(r["ok"] for r in adam.values()) else "fail"),
    }
    seg_main = segs[SEG_MAIN]
    seg_ok = "ok" if all(r["ok"] for r in segs.values()) else "fail"
    common = dict(shape=[SEG_BATCH] + seg_main["table"],
                  dtype=seg_main["dtype"], verdict=seg_ok)
    entries[seg.KERNEL_NAME] = dict(
        launches=ncf_counts.get(seg.KERNEL_NAME, 0),
        max_abs_err=max(r["max_abs_err_vs_plain"] for r in segs.values()),
        ms=seg_main["kernel_ms"], wall_ms=seg_main["wall_ms"],
        plain_ms=seg_main["plain_ms"], bound_ms=seg_main["bound_ms"],
        bound_by=seg_main["bound_by"], library_ms=seg_main["library_ms"],
        timed_by=timed_by(seg_main, "kernel_ms"), **common)
    entries[seg.SUM_NAME] = dict(
        launches=ncf_counts.get(seg.SUM_NAME, 0),
        max_abs_err=seg_main["segment_sum_rel_err_vs_cpu"],
        ms=seg_main["sum_kernel_ms"], plain_ms=seg_main["sum_plain_ms"],
        bound_ms=seg_main["sum_bound_ms"], bound_by=seg_main["sum_bound_by"],
        library_ms=seg_main["sum_library_ms"],
        timed_by={k: seg_main["timed_by"]["sum_" + v] for k, v in (
            ("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
            ("library_ms", "library_ms"))}, **common)
    return entries


def decode_entries(decs, gen):
    """The two decode-attention rows of the `kernels` line, at the long
    context bucket in f32 (the serving dtype), launches from the serving
    runs."""
    main = decs[DEC_MAIN]
    bf16 = decs[(DEC_MAIN[0], torch.bfloat16)]
    ok = "ok" if all(r["ok"] for r in decs.values()) else "fail"
    common = dict(shape=main["shape"], kv_bucket=main["kv_bucket"],
                  dtype=main["dtype"], timed_by=BY_GRAPH, verdict=ok)
    return {
        da.KERNEL_NAME: dict(
            launches=gen["contiguous"]["launches"].get(da.KERNEL_NAME, 0),
            n_split=main["n_split"],
            pct_of_bound=main["pct_of_bound"],
            max_abs_err=main["max_abs_err"],
            max_abs_err_bf16=bf16["max_abs_err"],
            ms=main["kernel_ms"], wall_ms=main["kernel_wall_ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
            profiler_calls_per_step=gen["profile"]["contiguous"][
                "decode_attention_calls"], **common),
        da.PAGED_NAME: dict(
            launches=gen["paged"]["launches"].get(da.PAGED_NAME, 0),
            n_split=main["n_split"],
            pct_of_bound=main["paged_pct_of_bound"],
            max_abs_err=main["max_abs_err_paged"],
            max_abs_err_bf16=bf16["max_abs_err_paged"],
            ms=main["paged_kernel_ms"], wall_ms=main["paged_kernel_wall_ms"],
            plain_ms=main["paged_plain_ms"],
            bound_ms=main["paged_bound_ms"],
            bound_by=main["paged_bound_by"],
            library_ms=main["paged_library_ms"],
            bitwise_contiguous=all(r["paged_bitwise_contiguous"]
                                   for r in decs.values()),
            profiler_calls_per_step=gen["profile"]["paged"][
                "decode_attention_calls"], **common),
    }


def keep_scale_entry(seed: int):
    """The mask-export test aid at the attention-dropout phase's main shape:
    its time, the plain Philox's time and the bound of writing the f32
    matrix once. It is on no main path (0 launches there)."""
    shape = ATTN_DROP_SHAPES[0]
    B, H, T, _ = shape
    t = dr._byte_threshold(ATTN_DROP_RATE)
    got = fa.keep_scale_matrix(shape, ATTN_DROP_RATE, seed, "cuda")
    want = attention_keep_scale(B * H, T, seed, t, "cuda").view(B, H, T, T)
    err = (got - want).abs().max().item()
    ms = time_ms(lambda: fa.keep_scale_matrix(shape, ATTN_DROP_RATE, seed,
                                              "cuda"), 10)
    plain_ms = time_ms(lambda: attention_keep_scale(B * H, T, seed, t,
                                                    "cuda"), 3)
    bound_ms = B * H * T * T * 4 / MEM_BYTES_PER_S * 1e3
    return dict(launches=0, on_main_path=False, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None, timed_by=dict(BY_EVENTS, library_ms=None),
                shape=list(shape),
                dtype="float32",
                verdict="ok" if err == 0.0 else "fail")


# ---------------------------------------------------------------------------
# The text zoo: NER with its CRF head, KNRM, TransformerLayer and
# Seq2seq on the layers under them
# ---------------------------------------------------------------------------
# NER at the JAX `NER` defaults (`models/textmodels.py:47-50`, the
# reference's `ner.py:21`): CoNLL-2003's 9 BIO tags over four entity types,
# a 20,000-word and a 100-char vocabulary, 40-word sentences
TZ_NER = dict(num_entities=9, word_vocab_size=20_000, char_vocab_size=100,
              word_length=12, word_emb_dim=100, char_emb_dim=30,
              tagger_lstm_dim=100, dropout=0.5, crf_mode="reg")
TZ_SEQ = 40
TZ_BATCH = 128
# the `ner_drop` Dropout's input: word vectors and the char BiLSTM's two
# directions (its width is char_emb_dim)
TZ_NER_FEATS = TZ_NER["word_emb_dim"] + 2 * TZ_NER["char_emb_dim"]
TZ_STEPS = 32               # steps of each timed fit (one epoch)
TZ_TIMED_FITS = 3           # the main path's fit, then two timed repeats
TZ_CHECK_STEPS = 2          # steps (one a epoch) of the card-vs-CPU fit
TZ_LR = 1e-3
TZ_WEIGHT_DECAY = 0.01
TZ_SERVE = {1: 300, 128: 300}  # predict batch: requests
TZ_TOL = 5e-4               # card f32 against the CPU f32
# a fit's losses, card against CPU from the same weights and batches: 2.4e-7
# at most on an H100 80GB HBM3 (700 W), for NER, KNRM and Seq2seq
TZ_FIT_LOSS_TOL = 1e-5
# every weight after a card fit against the CPU's fit from the same start:
# Adam's m/sqrt(v) turns rounding noise in a near-zero gradient into a step
# of up to lr either way, so an element may differ by up to 2*lr a step;
# at most TZ_PARAM_FRAC of the elements by more than 1e-6 (5.5e-6 at most
# on the same card), and the update (final - initial) in relative L2 over
# all leaves within TZ_UPDATE_TOL (3.8e-6 at most there)
TZ_PARAM_FRAC = 1e-4
TZ_UPDATE_TOL = 1e-4
# KNRM at the reference's WikiQA ranker widths
TZ_KNRM = dict(text1_length=10, text2_length=40, vocab_size=20_000,
               embed_size=300, kernel_num=21, sigma=0.1, exact_sigma=0.001)
TZ_KNRM_BATCH = 256         # 128 (positive, negative) pairs, rank_hinge
TZ_KNRM_STEPS = 3
TZ_QUERIES, TZ_CANDIDATES = 32, 8
# TransformerLayer at GPT-1's widths
TZ_GPT = dict(vocab=40_990, seq_len=512, n_block=12, hidden_size=768,
              n_head=12)
TZ_GPT_BATCH = 8
TZ_GPT_TOL = 5e-4           # f32: the flash forward against the plain one
TZ_GPT_TURNS = 6            # flash and plain timed in alternating turns
TZ_GPT_REPS = 5             # forwards a turn (CUDA events)
# Seq2seq: an LSTM encoder and decoder, the dense bridge and a generator
TZ_S2S = dict(rnn_type="lstm", encoder_hidden=(256,), decoder_hidden=(256,),
              bridge="dense", generator_units=300)
TZ_S2S_SHAPE = (64, 20, 300)    # batch, steps, features (word vectors)
TZ_S2S_STEPS = 3
TZ_S2S_INFER = 10


def _on_card(cpu_zoo):
    """A ZooModel built on the CPU, moved to the card."""
    card = copy.deepcopy(cpu_zoo)
    card.model.to("cuda")
    return card


def _from_jax_tree(cpu_zoo, sample, seed: int):
    """Build `cpu_zoo` from `seed`, carry its weights to the JAX package's
    tree and back through `convert` (the path a JAX-trained model takes),
    and return the tree."""
    net = cpu_zoo.model
    net.ensure_built(sample, seed=seed)
    names = convert.layer_names(net)
    tree = convert.model_params_to_jax(net.state_dict(), names, net)
    net.load_state_dict(convert.model_params_from_jax(tree, names, net))
    return tree


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _tz_check(name: str, err: float, tol: float, **extra) -> None:
    ok = bool(np.isfinite(err)) and err <= tol
    emit(dict({"phase": "text_zoo_check", "check": name, "max_abs_err": err,
               "tol": tol, "ok": ok}, **extra))
    if not ok:
        raise SystemExit(f"chip_smoke: {name} outside tolerance")


def _tz_weights(name: str, initial, got, want, steps: int) -> dict:
    """The weights of the card's fit (`got`) against the CPU's (`want`),
    both from `initial` (lists in parameter order), by TZ_PARAM_FRAC and
    TZ_UPDATE_TOL, each element within 2 * TZ_LR * `steps`."""
    got = [t.detach().cpu() for t in got]
    want = [t.detach().cpu() for t in want]
    upd = update_errors(initial, got, want)
    over = sum(int(((g - w).abs() > 1e-6).sum()) for g, w in zip(got, want))
    frac = over / sum(t.numel() for t in want)
    bound = 2 * TZ_LR * steps
    ok = (upd["update_rel_l2_err"] is not None
          and upd["update_rel_l2_err"] <= TZ_UPDATE_TOL
          and upd["param_max_abs_err"] <= bound and frac <= TZ_PARAM_FRAC)
    emit(dict({"phase": "text_zoo_check", "check": name, "leaves": len(got),
               "elements": sum(t.numel() for t in want), "steps": steps,
               "param_tol": bound, "param_frac_over_1e-6": frac,
               "param_frac_tol": TZ_PARAM_FRAC,
               "update_tol": TZ_UPDATE_TOL, "ok": ok}, **upd))
    if not ok:
        raise SystemExit(f"chip_smoke: {name} outside tolerance")
    return upd


def _ner_data(rs, n: int):
    cfg = TZ_NER
    return ([rs.integers(0, cfg["word_vocab_size"], (n, TZ_SEQ)).astype(
        np.int32), rs.integers(0, cfg["char_vocab_size"],
                               (n, TZ_SEQ, cfg["word_length"])).astype(
        np.int32)], rs.integers(0, cfg["num_entities"],
                                (n, TZ_SEQ)).astype(np.int32))


def _ner_loss():
    return objectives.get("sparse_categorical_crossentropy",
                          from_logits=True)


def _ner_estimator(zoo):
    return Estimator.from_keras(
        zoo.model, optimizer=optimizers.fused_adam(
            TZ_LR, weight_decay=TZ_WEIGHT_DECAY),
        loss=_ner_loss(), device=next(zoo.model.parameters()).device)


def _text_zoo_ner(card: str, seed: int) -> dict:
    rs = np.random.default_rng(seed + 220)
    x, y = _ner_data(rs, TZ_BATCH * TZ_STEPS)
    cpu = NER(device="cpu", **TZ_NER)
    _from_jax_tree(cpu, [a[:1] for a in x], seed)
    state = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    initial = [p.detach().clone() for p in cpu.model.parameters()]
    ner = _on_card(cpu)
    fit_kw = dict(epochs=1, batch_size=TZ_BATCH, fused_optimizer=True)
    # the card's fit and the CPU's from the same weights on the same batch
    # and step seeds (the dropout masks are the same Philox bits), one step
    # an epoch so each step's loss is kept; also the card's warm fit
    sub = ([a[:TZ_BATCH] for a in x], y[:TZ_BATCH])
    check_kw = dict(fit_kw, epochs=TZ_CHECK_STEPS)
    cpu_hist = _ner_estimator(cpu).fit(sub, **check_kw)
    est = _ner_estimator(ner)
    card_hist = est.fit(sub, **check_kw)
    _tz_check("ner_fit_loss_card_vs_cpu",
              _err(card_hist["loss"], cpu_hist["loss"]), TZ_FIT_LOSS_TOL,
              card_loss=card_hist["loss"], cpu_loss=cpu_hist["loss"])
    _tz_weights("ner_fit_weights_card_vs_cpu", initial,
                list(ner.model.parameters()), list(cpu.model.parameters()),
                TZ_CHECK_STEPS)
    est.fit((x, y), **fit_kw)                 # the timed fit's programs
    torch.cuda.synchronize()

    # -- the main path (training): counts 0 just before, read just after --
    LAUNCHES.reset()
    t0 = time.perf_counter()
    hist = est.fit((x, y), **fit_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    fit_ms = [dt / TZ_STEPS * 1e3]
    for _ in range(TZ_TIMED_FITS - 1):
        t0 = time.perf_counter()
        est.fit((x, y), **fit_kw)
        torch.cuda.synchronize()
        fit_ms.append((time.perf_counter() - t0) / TZ_STEPS * 1e3)
    step_ms = float(np.median(fit_ms))
    # the `ner_drop` Dropout: one launch forward, one backward; one fused
    # sweep over every leaf
    sweep = fad.sweep_launches(ner.model.parameters())
    want = {dr.KERNEL_NAME: 2, fad.KERNEL_NAME: sweep}
    per_step = {k: v / TZ_STEPS for k, v in counts.items()}
    emit({"phase": "text_zoo_ner_train", "config": TZ_NER, "seq_len": TZ_SEQ,
          "batch": TZ_BATCH, "steps": TZ_STEPS, "fits": TZ_TIMED_FITS,
          "step_ms": step_ms, "step_ms_per_fit": fit_ms,
          "words_per_s": TZ_BATCH * TZ_SEQ / step_ms * 1e3,
          "loss": hist["loss"], "launches_per_step": per_step,
          "expected_per_step": want, "card": card})
    if per_step != {k: float(v) for k, v in want.items()} or not all(
            math.isfinite(v) for v in hist["loss"]):
        raise SystemExit("chip_smoke: NER training check failed")

    im = InferenceModel(max_batch=TZ_BATCH).load_keras(ner.model)
    im.warmup([np.zeros(TZ_SEQ, np.int32),
               np.zeros((TZ_SEQ, TZ_NER["word_length"]), np.int32)],
              buckets=sorted(TZ_SERVE))
    requests = {b: [_ner_data(rs, b)[0] for _ in range(k)]
                for b, k in TZ_SERVE.items()}
    # -- the main path (serving) ---------------------------------------------
    LAUNCHES.reset()
    latencies = {}
    for b, reqs in requests.items():
        times = []
        for req in reqs:
            t1 = time.perf_counter()
            out = im.predict(req)
            times.append((time.perf_counter() - t1) * 1e3)
            if out.shape != (b, TZ_SEQ, TZ_NER["num_entities"]) or \
                    not np.isfinite(out).all():
                raise SystemExit(f"chip_smoke: bad NER output {out.shape}")
        latencies[b] = times
    serve_counts = LAUNCHES.snapshot()
    # -------------------------------------------------------------------------
    for b, times in latencies.items():
        emit({"phase": "text_zoo_ner_serving", "batch": b,
              "requests": len(times),
              "p50_ms": float(np.percentile(times, 50)),
              "p99_ms": float(np.percentile(times, 99)),
              "launches": serve_counts, "card": card})
    if serve_counts:            # inference runs no dropout, no optimizer
        raise SystemExit(f"chip_smoke: NER serving launched {serve_counts}")

    # the CRF head on the card's emissions against the CPU's, with the
    # card's weights on both
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               ner.model.state_dict().items()})
    tr = rs.standard_normal((TZ_NER["num_entities"],) * 2).astype(
        np.float32)
    ner.transitions = cpu.transitions = tr
    xc, tags = _ner_data(rs, TZ_BATCH)
    em = {"card": ner.emissions(xc), "cpu": cpu.emissions(xc)}
    _tz_check("ner_emissions_card_vs_cpu",
              _err(em["card"].cpu(), em["cpu"]), TZ_TOL)
    ll = {k: crf.crf_log_likelihood(e, tags, tr) for k, e in em.items()}
    _tz_check("ner_crf_log_likelihood_card_vs_cpu",
              _err(ll["card"].cpu(), ll["cpu"]), TZ_TOL,
              device=str(ll["card"].device))
    loss = {"card": ner.crf_loss(xc, tags), "cpu": cpu.crf_loss(xc, tags)}
    _tz_check("ner_crf_loss_card_vs_cpu", abs(loss["card"] - loss["cpu"]),
              TZ_TOL, card_loss=loss["card"], cpu_loss=loss["cpu"])
    paths = {"card": ner.decode(xc), "cpu": cpu.decode(xc)}
    same = bool(np.array_equal(paths["card"], paths["cpu"]))
    emit({"phase": "text_zoo_ner_viterbi", "paths_equal": same,
          "shape": list(paths["card"].shape), "card": card})
    if not same:
        raise SystemExit("chip_smoke: NER Viterbi paths differ card vs CPU")
    del est, im, ner
    torch.cuda.empty_cache()

    # each kernel at the path's own shapes against its plain version: the
    # fit with the dropout kernel and fused AdamW against the plain
    # dropout (the same Philox masks) and plain AdamW, every weight
    # compared, and the sweep bit-exact at NER's leaves; the dropout kernel
    # at the `ner_drop` input
    rnn_path_checks("text_zoo_ner", lambda: NER(device="cuda",
                                                **TZ_NER).model,
                    state, sub, TZ_BATCH, _ner_loss(), sweep, 2, (False,),
                    card, lr=TZ_LR, weight_decay=TZ_WEIGHT_DECAY)
    shape = (TZ_BATCH, TZ_SEQ, TZ_NER_FEATS)
    drop_err = dropout_at(shape, torch.float32, TZ_NER["dropout"], seed + 225)
    emit({"phase": "text_zoo_ner_dropout_shape", "shape": list(shape),
          "dtype": "float32", "rate": TZ_NER["dropout"],
          "max_abs_err_vs_plain": drop_err, "ok": drop_err == 0.0,
          "card": card})
    if drop_err != 0.0:
        raise SystemExit("chip_smoke: dropout kernel at the NER shape")
    return {"counts": counts, "serve_counts": serve_counts,
            "step_ms": step_ms}


def _knrm_queries(rs, n: int):
    cfg = TZ_KNRM
    width = cfg["text1_length"] + cfg["text2_length"]
    return [(rs.integers(1, cfg["vocab_size"], (TZ_CANDIDATES, width)).astype(
        np.int32), rs.integers(0, 3, TZ_CANDIDATES).astype(np.float32))
        for _ in range(n)]


def _text_zoo_knrm(card: str, seed: int) -> dict:
    rs = np.random.default_rng(seed + 221)
    width = TZ_KNRM["text1_length"] + TZ_KNRM["text2_length"]
    cpu = KNRM(device="cpu", **TZ_KNRM)
    x = rs.integers(1, TZ_KNRM["vocab_size"], (TZ_KNRM_BATCH,
                                               width)).astype(np.int32)
    _from_jax_tree(cpu, x[:1], seed + 1)
    state = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    initial = [p.detach().clone() for p in cpu.model.parameters()]
    knrm = _on_card(cpu)
    y = np.zeros((len(x), 1), np.float32)   # rank_hinge reads the order
    # the pairs stay in order (no shuffle); one step an epoch
    fit_kw = dict(nb_epoch=TZ_KNRM_STEPS, batch_size=TZ_KNRM_BATCH,
                  shuffle=False, fused_optimizer=True)
    hists = {}
    for name, zoo in (("cpu", cpu), ("card", knrm)):
        zoo.compile(optimizers.fused_adam(TZ_LR), "rank_hinge")
        LAUNCHES.reset()
        t0 = time.perf_counter()
        hists[name] = zoo.fit(x, y, **fit_kw)
        hists[name + "_s"] = time.perf_counter() - t0
        hists[name + "_counts"] = LAUNCHES.snapshot()
    _tz_check("knrm_fit_loss_card_vs_cpu",
              _err(hists["card"]["loss"], hists["cpu"]["loss"]),
              TZ_FIT_LOSS_TOL,
              card_loss=hists["card"]["loss"])
    _tz_weights("knrm_fit_weights_card_vs_cpu", initial,
                list(knrm.model.parameters()), list(cpu.model.parameters()),
                TZ_KNRM_STEPS)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               knrm.model.state_dict().items()})
    queries = _knrm_queries(rs, TZ_QUERIES)
    scores = {}
    for name, zoo in (("card", knrm), ("cpu", cpu)):
        t0 = time.perf_counter()
        scores[name] = {"ndcg@3": zoo.evaluate_ndcg(queries, k=3),
                        "ndcg@5": zoo.evaluate_ndcg(queries, k=5),
                        "map": zoo.evaluate_map(queries)}
        scores[name + "_s"] = time.perf_counter() - t0
    emit({"phase": "text_zoo_knrm", "config": TZ_KNRM,
          "batch": TZ_KNRM_BATCH, "steps": TZ_KNRM_STEPS,
          "fit_s": hists["card_s"], "loss": hists["card"]["loss"],
          "launches": hists["card_counts"], "queries": TZ_QUERIES,
          "candidates": TZ_CANDIDATES, "card_metrics": scores["card"],
          "cpu_metrics": scores["cpu"], "eval_s": scores["card_s"],
          "card": card})
    _tz_check("knrm_ndcg_map_card_vs_cpu",
              max(abs(scores["card"][k] - scores["cpu"][k])
                  for k in scores["card"]), 1e-6)
    sweep = fad.sweep_launches(knrm.model.parameters())
    del knrm
    torch.cuda.empty_cache()
    # fused Adam against plain Adam on the card (KNRM has no dropout); the
    # pairs stay in order
    pairs = TPUDataset.from_ndarrays((x, y), batch_size=TZ_KNRM_BATCH,
                                     shuffle=False)
    rnn_path_checks("text_zoo_knrm", lambda: KNRM(device="cuda",
                                                  **TZ_KNRM).model,
                    state, pairs, TZ_KNRM_BATCH, "rank_hinge", sweep, 0,
                    (False,), card, lr=TZ_LR)
    return {"counts": hists["card_counts"], "metrics": scores["card"]}


def _text_zoo_transformer(card: str, seed: int) -> dict:
    cfg = TZ_GPT
    gen = torch.Generator().manual_seed(seed + 222)
    ids = torch.randint(0, cfg["vocab"], (TZ_GPT_BATCH, cfg["seq_len"]),
                        generator=gen)
    inp = Input(shape=(cfg["seq_len"],))
    layer = TransformerLayer(device="cpu", **cfg)
    cpu = Model(inp, layer(inp))
    cpu.ensure_built(seed=seed)
    tree = convert.model_params_to_jax(cpu.state_dict(), [layer.name], cpu)
    cpu.load_state_dict(convert.model_params_from_jax(tree, [layer.name],
                                                      cpu))
    out = {"launches_per_forward": {}}
    ref = None              # the f32 flash forward, the bf16 paths' yardstick
    for dtype in (torch.float32, torch.bfloat16):
        net = copy.deepcopy(cpu).to("cuda", dtype)
        blocks = net.get_submodule(layer.name).blocks
        x = ids.to("cuda")
        outs, counts = {}, {}

        def use_flash(flash):
            for blk in blocks:
                blk.attn.use_flash = flash

        def fwd():
            with torch.inference_mode():
                return net.apply(x)
        for flash in (True, False):
            use_flash(flash)
            fwd()
            torch.cuda.synchronize()
            LAUNCHES.reset()
            outs[flash] = fwd().float().cpu()
            torch.cuda.synchronize()
            counts[flash] = LAUNCHES.snapshot()
        # flash and plain in alternating turns, each turn's order reversed
        turns = {True: [], False: []}
        for t in range(TZ_GPT_TURNS):
            for flash in (True, False) if t % 2 == 0 else (False, True):
                use_flash(flash)
                turns[flash].append(time_ms(fwd, TZ_GPT_REPS, warm=1))
        ms = {k: float(np.median(v)) for k, v in turns.items()}
        name = str(dtype)[6:]
        err = _err(outs[True], outs[False])
        row = {"phase": "text_zoo_transformer_layer", "dtype": name,
               "config": cfg, "batch": TZ_GPT_BATCH, "flash_ms": ms[True],
               "plain_ms": ms[False], "flash_ms_turns": turns[True],
               "plain_ms_turns": turns[False], "launches_flash": counts[True],
               "launches_plain": counts[False],
               "flash_vs_plain_max_abs_err": err,
               "output_abs_max": float(outs[False].abs().max()),
               "card": card}
        if dtype == torch.float32:
            ref = outs[True]
            emit(row)
            _tz_check("transformer_layer_flash_vs_plain_float32", err,
                      TZ_GPT_TOL)
        else:
            # two bf16 computations differ by bf16 roundings (an ulp is
            # 1/16 at |x| = 8); the kernel path must be as close to the f32
            # forward as the plain path is
            row.update(flash_vs_f32=_err(outs[True], ref),
                       plain_vs_f32=_err(outs[False], ref))
            emit(row)
            _tz_check("transformer_layer_bf16_flash_vs_f32",
                      row["flash_vs_f32"], 1.25 * row["plain_vs_f32"],
                      plain_vs_f32=row["plain_vs_f32"])
        if counts[True] != {fa.KERNEL_NAME: cfg["n_block"]} or counts[False]:
            raise SystemExit(f"chip_smoke: TransformerLayer launches "
                             f"{counts}")
        out["launches_per_forward"][name] = counts[True].get(fa.KERNEL_NAME)
        del net, outs
    return out


def _s2s_data(rs, n: int):
    b, t, f = TZ_S2S_SHAPE
    return [rs.standard_normal((n, t, f)).astype(np.float32),
            rs.standard_normal((n, t, f)).astype(np.float32)]


def _text_zoo_seq2seq(card: str, seed: int) -> dict:
    rs = np.random.default_rng(seed + 223)
    b = TZ_S2S_SHAPE[0]
    x = _s2s_data(rs, b)
    y = rs.standard_normal(x[1].shape).astype(np.float32)
    cpu = Seq2seq(device="cpu", **TZ_S2S)
    cpu.model.ensure_built([a[:1] for a in x], seed=seed)
    tree = convert.seq2seq_params_to_jax(cpu.model.state_dict())
    cpu.model.load_state_dict(convert.seq2seq_params_from_jax(tree))
    state = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    initial = [p.detach().clone() for p in cpu.model.parameters()]
    s2s = _on_card(cpu)
    fwd = {"card": s2s.predict(x, batch_per_thread=b),
           "cpu": cpu.predict(x, batch_per_thread=b)}
    _tz_check("seq2seq_forward_card_vs_cpu", _err(fwd["card"], fwd["cpu"]),
              TZ_TOL)
    hists = {}
    for name, zoo in (("cpu", cpu), ("card", s2s)):
        zoo.compile(optimizers.fused_adam(TZ_LR), "mse")
        t0 = time.perf_counter()
        hists[name] = zoo.fit(x, y, batch_size=b, nb_epoch=TZ_S2S_STEPS,
                              fused_optimizer=True)
        hists[name + "_s"] = time.perf_counter() - t0
    _tz_check("seq2seq_fit_loss_card_vs_cpu",
              _err(hists["card"]["loss"], hists["cpu"]["loss"]),
              TZ_FIT_LOSS_TOL,
              card_loss=hists["card"]["loss"])
    _tz_weights("seq2seq_fit_weights_card_vs_cpu", initial,
                list(s2s.model.parameters()), list(cpu.model.parameters()),
                TZ_S2S_STEPS)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               s2s.model.state_dict().items()})
    start = x[1][:, 0]
    t0 = time.perf_counter()
    card_inf = s2s.infer(x[0], start, max_seq_len=TZ_S2S_INFER)
    infer_ms = (time.perf_counter() - t0) * 1e3
    _tz_check("seq2seq_infer_card_vs_cpu", _err(
        card_inf, cpu.infer(x[0], start, max_seq_len=TZ_S2S_INFER)),
        TZ_TOL)
    emit({"phase": "text_zoo_seq2seq", "config": TZ_S2S,
          "shape": list(TZ_S2S_SHAPE), "steps": TZ_S2S_STEPS,
          "fit_s": hists["card_s"], "loss": hists["card"]["loss"],
          "infer_steps": TZ_S2S_INFER, "infer_ms": infer_ms, "card": card})
    sweep = fad.sweep_launches(s2s.model.parameters())
    del s2s
    torch.cuda.empty_cache()

    def new_net():
        net = Seq2seq(device="cuda", **TZ_S2S).model
        net.ensure_built([a[:1] for a in x], seed=seed)
        return net
    # fused Adam against plain Adam on the card (no dropout in Seq2seq)
    rnn_path_checks("text_zoo_seq2seq", new_net, state, (x, y), b, "mse",
                    sweep, 0, (False,), card, lr=TZ_LR)
    return {"loss": hists["card"]["loss"]}


def _text_zoo_freed(card: str, seed: int) -> dict:
    """A model fitted on the card (its step programs captured as CUDA
    graphs), then deleted: with the collector off, the card's allocated
    bytes return to what they were before the model was built."""
    from analytics_zoo_tpu_torch.learn import trainer
    rs = np.random.default_rng(seed + 224)
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    before = torch.cuda.memory_allocated()
    gc.disable()
    try:
        zoo = KNRM(device="cuda", **TZ_KNRM)
        width = TZ_KNRM["text1_length"] + TZ_KNRM["text2_length"]
        x = rs.integers(1, TZ_KNRM["vocab_size"], (2 * TZ_KNRM_BATCH,
                                                   width)).astype(np.int32)
        zoo.model.ensure_built(x[:1], seed=seed)
        zoo.compile(optimizers.fused_adam(TZ_LR), "rank_hinge")
        zoo.fit(x, np.zeros((len(x), 1), np.float32), nb_epoch=2,
                batch_size=TZ_KNRM_BATCH, shuffle=False,
                fused_optimizer=True)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        graphs = trainer.program_sources(zoo.model)
        del zoo
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        after = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    emit({"phase": "text_zoo_freed_without_collection",
          "allocated_before": before, "allocated_fitted": held,
          "allocated_after_del": after, "programs": graphs, "card": card})
    if after != before or held <= before:
        raise SystemExit("chip_smoke: a deleted fitted model kept card "
                         f"memory ({after - before} bytes)")
    return {"before": before, "held": held, "after": after}


def phase_text_zoo(card: str, seed: int) -> dict:
    """The text zoo on the card: NER at the JAX defaults trained
    through `Estimator.fit` (fused AdamW, the `ner_drop` Dropout on the
    dropout kernel) against the CPU's fit, served through `InferenceModel`
    at batches 1 and 128, its CRF log-likelihood, loss and Viterbi paths on
    the card's emissions against the CPU's; KNRM at WikiQA's ranker widths
    fitted with `rank_hinge`, ranked by NDCG@3/5 and MAP, card against CPU;
    TransformerLayer at GPT-1's widths, the flash forward (12 launches a
    forward) against the plain path in f32 and bf16; Seq2seq (LSTM, dense
    bridge, generator) forward, fit and `infer` against the CPU; and a
    fitted model freed on `del` without a collection. Each model is built
    on the CPU, its weights carried to the JAX package's tree and back by
    `convert`, then moved to the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, seconds = {}, {}
    for name, part in (("ner", _text_zoo_ner), ("knrm", _text_zoo_knrm),
                       ("transformer_layer", _text_zoo_transformer),
                       ("seq2seq", _text_zoo_seq2seq),
                       ("freed", _text_zoo_freed)):
        t0 = time.perf_counter()
        out[name] = part(card, seed)
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "text_zoo_seconds", "seconds": seconds})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--nccl-leg", default=None,
                        help="run phase_distributed's NCCL leg as the "
                             "script `zoo-launch` starts, writing its "
                             "results to this file")
    args = parser.parse_args(argv)
    if args.nccl_leg:
        nccl_leg(args.nccl_leg, args.seed)
        return 0
    t0 = time.perf_counter()
    seconds = {}
    memory_gb = {}

    def timed(fn, *a):
        """`fn(*a)`, its seconds kept under its name (and a string
        argument's, for a phase run twice). A dead model frees its
        training programs and their CUDA graph pools by reference count
        (the trainer's cached entry holds the model weakly,
        `phase_text_zoo` checks it); each phase still ends with a
        collection, for whatever other cycles it leaves (frames an
        exception holds, its own closures), so the next starts on a card
        its predecessors have let go of; the card's allocated and
        reserved GB after it are kept beside its seconds."""
        t1 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            name = "_".join([fn.__name__] + [x for x in a[2:]
                                             if isinstance(x, str)])
            gc.collect()
            torch.cuda.empty_cache()
            seconds[name] = time.perf_counter() - t1
            memory_gb[name] = [torch.cuda.memory_allocated() / 1e9,
                               torch.cuda.memory_reserved() / 1e9]

    card = timed(phase_device_and_build)
    attn = timed(phase_kernels, card, args.seed)
    bwd = timed(phase_backward, card, args.seed)
    adrop = timed(phase_attention_dropout, card, args.seed)
    drop = timed(phase_dropout, card, args.seed)
    adam = timed(phase_fused_adam, card, args.seed)
    serve_counts = timed(phase_serving, card, args.seed)
    int8 = timed(phase_int8_serving_lifecycle, card, args.seed)
    cluster = timed(phase_cluster_serving, card, args.seed)
    graphs = timed(phase_graphs, card, args.seed)
    fleet = timed(phase_fleet_serving, card, args.seed, graphs)
    train_counts = timed(phase_training, card, args.seed)
    segs = timed(phase_segment_adam, card, args.seed)
    ncf_counts = timed(phase_ncf, card, args.seed)
    decs = timed(phase_decode_kernels, card, args.seed)
    gen = timed(phase_generative, card, args.seed)
    timed(phase_image_serving, card, args.seed)
    img_counts = timed(phase_image_training, card, args.seed)
    inception_counts = timed(phase_image_dropout, card, args.seed)
    text = {enc: timed(phase_text_training, card, args.seed, enc)
            for enc in ("lstm", "gru")}
    timed(phase_text_serving, card, args.seed)
    timed(recurrent_yardstick, card, args.seed)
    anomaly = timed(phase_anomaly, card, args.seed)
    timed(phase_session_check, card, args.seed)
    inception = timed(phase_inception_imagenet, card, args.seed)
    wide = timed(phase_wide_and_deep, card, args.seed)
    timed(phase_autograd_checks, card, args.seed)
    text_adagrad = timed(phase_text_adagrad, card, args.seed)
    resume = timed(phase_resume, card, args.seed)
    squad = timed(phase_bert_squad, card, args.seed)
    ner = timed(phase_bert_ner, card, args.seed)
    prefetch = timed(phase_prefetch_ab, card, args.seed)
    streamed = timed(phase_imagenet_tfrecord, card, args.seed,
                     inception["step_ms"])
    distributed = timed(phase_distributed, card, args.seed)
    text_zoo = timed(phase_text_zoo, card, args.seed)
    entries = kernel_entries(attn, bwd, drop, adam, serve_counts,
                             train_counts, adrop, segs, ncf_counts)
    entries.update(decode_entries(decs, gen))
    r50 = adam["resnet50"]
    entries[fad.KERNEL_NAME].update(
        launches_resnet50=img_counts.get(fad.KERNEL_NAME, 0),
        launches_inception_step=inception_counts.get(fad.KERNEL_NAME, 0),
        resnet50_sweep={k: r50[k] for k in (
            "leaves", "elements", "param_dtype", "max_abs_err",
            "launches_per_sweep", "kernel_ms_per_sweep", "wall_ms",
            "host_ms", "one_leaf_a_launch", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "pct_of_bound", "timed_by")})
    entries[dr.KERNEL_NAME].update(
        launches_inception_step=inception_counts.get(dr.KERNEL_NAME, 0),
        launches_text_adagrad=text_adagrad["counts"].get(dr.KERNEL_NAME, 0))
    entries[fad.KERNEL_NAME].update(
        launches_resume=resume["counts"].get(fad.KERNEL_NAME, 0))
    for name in (dr.KERNEL_NAME, fad.KERNEL_NAME):
        entries[name].update(
            launches_text_lstm=text["lstm"]["counts"].get(name, 0),
            launches_text_gru=text["gru"]["counts"].get(name, 0),
            launches_anomaly=anomaly["counts"].get(name, 0),
            launches_inception_imagenet=inception["counts"].get(name, 0),
            launches_imagenet_tfrecord=streamed["counts"].get(name, 0),
            launches_wide_and_deep=wide["counts"].get(name, 0))
    for name in (fa.KERNEL_NAME, fa.BWD_DKV_NAME, fa.BWD_DQ_NAME,
                 dr.KERNEL_NAME, fad.KERNEL_NAME):
        entries[name].update(
            launches_squad=squad["counts"].get(name, 0),
            launches_squad_remat=squad["counts_remat"].get(name, 0),
            launches_ner=ner["counts"].get(name, 0))
    entries[fa.KERNEL_NAME].update(
        launches_ner_serving=ner["serve_counts"].get(fa.KERNEL_NAME, 0),
        launches_int8_serving=int8["counts"].get(fa.KERNEL_NAME, 0),
        launches_cluster_serving=cluster["counts"].get(fa.KERNEL_NAME, 0),
        launches_graph_serving={
            dtype: leg["launches"].get(fa.KERNEL_NAME, 0)
            for dtype, leg in graphs["legs"].items()},
        # the profiler's count of the kernels replays ran, beside
        # `launches` (which replays add from their graphs' kernel nodes)
        profiler_graph_serving={
            dtype: {"kernels": leg["profiler_flash_kernels"][-1],
                    "forwards": leg["profiler_replays"]}
            for dtype, leg in graphs["legs"].items()},
        profiler_cluster_closed_loop=cluster["profiler"],
        launches_fleet_serving=fleet["counts"].get(fa.KERNEL_NAME, 0))
    entries[da.KERNEL_NAME].update(
        launches_fleet_generative=fleet["gen_counts"].get(da.KERNEL_NAME,
                                                          0))
    entries[fad.KERNEL_NAME].update(
        launches_prefetch_ab=prefetch["counts"].get(fad.KERNEL_NAME, 0))
    for name, by_leg in distributed["counts"].items():
        entries[name].update(launches_distributed=by_leg)
    for name in (dr.KERNEL_NAME, fad.KERNEL_NAME):
        entries[name].update(
            launches_text_ner=text_zoo["ner"]["counts"].get(name, 0))
    entries[fa.KERNEL_NAME].update(
        launches_transformer_layer=text_zoo["transformer_layer"][
            "launches_per_forward"])
    entries[fa.KEEP_SCALE_NAME] = keep_scale_entry(args.seed)
    kernels = [dict(spec, **entries[spec["name"]], card=card)
               for spec in KERNELS]
    bad = [k["name"] for k in kernels if k["verdict"] != "ok"]
    if bad:
        raise SystemExit(f"chip_smoke: kernels failed their checks: {bad}")
    emit({"phase": "phase_seconds", "seconds": seconds})
    emit({"phase": "phase_memory_gb", "allocated_reserved": memory_gb})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
