"""The training loop behind `KerasNet.fit` and `Estimator.fit`.

Port of the single-device path of `analytics_zoo_tpu/learn/trainer.py`:
`_TrainingMetrics` (L38-141), `_tree_len` / `_tree_take` /
`_num_batches` (L143-155), `iter_batches` (L158), `_step_with_watchdog`
(L236-300), `_StepCostTracker` (L310-467), `_Prefetcher` (L470-549),
`_chunk_batches` (L552), `_cast_tree` (L647), `_make_one_step` (L737,
without sharding) as `build_train_step` (L805), `build_train_run` (L826)
and `build_device_epoch_run` (L856) as the programs below,
`_device_cache_eligible` (L905), `_data_fingerprint` (L931),
`_device_cached_data` (L954), `_pick_one_step` (L968), `build_eval_step`
(L985), `fit_keras` (L996) with its input pipeline (`batch_iter_factory`,
`prefetch`, `prefetch_depth`: L1160-1260, L1720-1740), its lazy-embedding
branch (L1327-1330, L1356-1369, L1385-1388), auto-resume (L1270-1316),
the step cache and `compile_cache_dir` (L1426-1490), the checkpoint
manager and its default `EveryEpoch` trigger (L1496-1501),
the TensorBoard writer (L1504) and `metrics_report_s` (L1511), the
roofline cost harvest (L1518-1545), the profiler window (`profile_steps`,
`_profile_tick`, L1574-1618), `_ckpt_extra` / `_ckpt_save`
(L1638-1700), the mid-epoch trigger and `end_trigger` (L1748-1760), the
epoch telemetry (L1766-1816), per-epoch validation (L1818-1828), the
epoch-boundary trigger (L1830-1840) and the emergency checkpoint
(L1842-1866), `evaluate_keras` (L1906) and `predict_keras` (L1974).

- Batching: `iter_batches` with the same `np.random.RandomState(seed +
  epoch)` shuffle and the same dropped remainder, so a port fit and a JAX
  fit (with `device_cache=False`, which the JAX package would otherwise
  pick on one device and shuffle on the device) see the same batches in
  the same order.
- Mixed precision as the JAX package does it (L748-775): f32 master
  parameters; each step runs the forward on bf16 casts of them through
  `torch.func.functional_call`, so autograd returns f32 gradients to the
  masters through the cast; the predictions are cast to f32 before the
  loss; inputs are never cast. Not `torch.autocast`, whose per-op dtype
  policy is not what the JAX package computes.
- Stateful layers (BatchNorm): the state path of the JAX step (L755-787,
  `_merge_state` L634) is the training forward itself. `Model.apply`
  writes each stateful layer's updates into its buffers
  (`keras.engine.merge_state`); under mixed precision they are computed
  from the bf16 casts of the parameters and statistics, as the JAX step
  computes them, and land in the float32 buffers. The optimizer steps
  `named_parameters()` only, so the moving statistics have no moments
  (the JAX sweep carries them as leaves whose update `_merge_state` then
  overwrites: 267 leaves against 161 for ResNet-50). `evaluate` and
  `predict` read the moving statistics.
- One optimizer step per batch: `fused_apply` (the fused-Adam kernel, in
  place) when the optimizer has it, else `update` and `p += u`.
  `fused_optimizer=True` swaps the compiled optimizer for its fused twin
  (`ops.optimizers.as_fused`), or keeps the plain one with a warning when
  it has none. There is no availability probe: a kernel that fails to
  build or launch raises.
- `lazy_embeddings=True` trains the tables the model declares
  (`lazy_embedding_specs`) row-sparse: with `fused_optimizer=True` through
  the segment kernels (`kernels/segment_update.make_fused_one_step`, which
  keeps them even when the rest has no fused twin), else through the plain
  row Adam of `learn/lazy_embedding.make_lazy_one_step`.
- `evaluate` and `predict` run the forward under `torch.inference_mode`
  in batches of `batch_per_thread` (one device), the last batch padded to
  the full size by repeating its last row and the padding's outputs
  dropped, as the JAX package does.
- Seeds: one integer per step from a `torch.Generator` seeded with `seed`,
  handed to the model's dropout sites.
- History: `history["loss"]` holds one mean per epoch; the step losses
  stay on the device and are read once per epoch (the only host sync
  besides validation and the triggers that read the loss).
- Fault tolerance, as in the JAX package. With `model.set_checkpoint(dir)`
  a `CheckpointManager` writes checkpoints (`learn/checkpoint.py`) at
  every firing of `checkpoint_trigger` (default `EveryEpoch`): the model
  tree, the optimizer state in optax's layout (`convert.opt_layout_to_jax`)
  and the meta (`epoch`, `iteration`, `epoch_finished`,
  `opt_state_layout`), then the publish marker. A fit that fails leaves an
  emergency checkpoint and raises. `auto_resume=True` continues from the
  newest intact epoch-boundary checkpoint: parameters, buffers, optimizer
  state, iteration and the step-seed generator, so the continued losses
  are bitwise those of an uninterrupted fit (the shuffle is `seed +
  epoch`). The port's generator is saved under its own meta key
  (`torch_generator`, its state in base64); the JAX package's `rng` key
  is a jax key the port cannot use, so a checkpoint written by the JAX
  package resumes with a fresh generator and a warning, as the JAX
  package does for a checkpoint without `rng`. `step_retries` retries a
  failed step; `step_timeout_s` runs each step on a watchdog thread, on
  the caller's device and stream. The `trainer.step` fault point fires
  before the step touches anything: the step updates the parameters in
  place, so a failure inside it leaves them half-updated, and the last
  checkpoint is then the resume point. `int8_sidecar=True` (L1013,
  L1096-1102, L1651-1680) runs the post-training quantization pass
  (`serving/quantization.write_int8_sidecar`) on the tree of every
  checkpoint it saves, the emergency one included, before the publish
  marker; a failed pass logs and leaves that version resumable but
  unpublished.

- The input pipeline. `batch_iter_factory(epoch)` yields `(xb, yb, real)`
  of numpy arrays in place of the in-memory batching. With `prefetch`
  (the default) a `_Prefetcher` thread prepares the next batches while
  the card runs the current step, at most `prefetch_depth` (default 2)
  ahead. On the card each batch is copied into pinned staging buffers and
  uploaded by a non-blocking copy on a side stream (`_PinnedUploader`);
  the step's stream waits on the copy's event, so the upload overlaps
  the previous step's compute. `prefetch=False` uploads each batch in the
  step loop from pageable memory. The batches and their order are the
  same either way, and so are the losses. A host-bound step loop (BERT
  fine-tuning) pays for the thread's wake-ups, which take the interpreter
  lock from it (`PERF.md` §6); an image step gains from the overlap.
- Telemetry, published into the process-wide registry under the JAX
  package's names: per epoch the step time, steps, samples, epochs, loss
  and throughput, `training_mfu` when `flops_per_step` is given (over the
  card's bf16 peak, `utils/roofline.py`), the input-wait histogram and
  the input-bound share; and `roofline_*{kind="train"}` from the step's
  counted cost (`_StepCostTracker`: the first step of each input
  signature runs under `observability.roofline.CostMeter`, memoized on
  the model, so later fits count nothing). Epoch time comes from CUDA
  events on the card and the host clock on the CPU. `metrics_report_s`
  logs a digest of the registry at that interval (`MetricsReporter`), and
  `model.set_tensorboard(dir, app)` mirrors the epoch scalars (and the
  reporter's digests) into TensorBoard under `dir/app/train`.
  `profile_steps=(start, stop)` captures iterations [start, stop) with
  `torch.profiler` into a rotated artifact under `profile_dir` (default
  `zoo_profiles`), listed in `history["profile_artifacts"]`; a failed
  capture logs and does not stop the fit. The port has no environment
  switches: the harvest is always on and the prefetch depth defaults to
  2, as the JAX package's defaults are.

- Programs, the counterpart of the JAX fit's jitted step. A fit runs its
  steps as programs of `steps_per_run=k` steps (`build_train_run`; 1: the
  single step): on the card each is captured once as a CUDA graph and
  replayed (`compile_cache/graphs.TrainProgram`), on the CPU the same
  buffer protocol runs eagerly. A program's first run is eager (the
  roofline's counted step); it is captured right after, and every later
  run replays it. Its buffers: a static batch (`[k, B, ...]`, which the
  uploaded batches are copied into on the step's stream) or the
  device-resident data, the model's own parameters and buffers, the
  optimizer state (its tensors kept on the model across fits: a new fit's
  fresh or restored state is written into them, and an update that
  returns new tensors has them copied back), a loss buffer of k (read
  back once an epoch with the others) and the step's scalar table.
  Programs are kept on the model under the JAX cache key (the compiled
  optimizer and loss, mixed precision, lazy tables, fused) and by kind,
  length and batch signature; the short tail group of an epoch is a
  program of its own length. A storage change of a parameter, buffer or
  state tensor drops them. A capture that fails raises `CaptureError`:
  nothing falls back to eager.
- The scalar table. What a step reads that changes from step to step is
  a row of a small device table (`_StepTable`): the step seed (int64),
  drawn by `torch.randint` on the fit's generator as before, and the
  one-step's f32 values (`one_step.scalars(opt_state)`: the optimizer's
  scheduled rate and bias corrections or its folded `(a, b, lr·wd)`,
  each lazy table's values), computed on the host by the functions that
  computed them before and copied to the card before the run. The step
  seed reaches the model as a `kernels.philox.DeviceSeed`, the kernels
  read it and the optimizer scalars by pointer, and the eager run reads
  the same rows, so eager and replayed steps compute the same bits. The
  host advances the state's step counts itself for a replay (an update
  advances each by one a step, checked on every eager run).
- `device_cache` (JAX L905-965, L1701-1712): `None` keeps the epoch's data
  on the device when the JAX rule allows (in-memory arrays of at most 256
  MB, one device, no trigger that needs mid-epoch granularity), `True`
  always, `False` never; streaming input (`batch_iter_factory`) never.
  The data is uploaded once per distinct content and cached on the
  model. Each epoch uploads the host path's own `np.random.RandomState(
  seed + epoch)` order, and each step gathers its batch on the device
  through a cursor its program increments, so the numbers are those of
  the host batches (the JAX package draws its on-device permutation with
  `jax.random` instead, ROADMAP queue 3). An epoch is ⌈steps/k⌉ runs with
  no batch copied from the host; triggers are checked at the epoch
  boundary only. With host batches they are checked every k iterations.
- `compile_cache_dir` (JAX L1426-1490): the kernel libraries go through
  the `CompileCache` store, and each program writes a capture record
  keyed by `compile_cache/key.make_key` with the JAX discriminators (the
  model, loss, optimizer, mixed precision, lazy, multi, device cache,
  `dc_steps`, shuffle, fused). `program_sources(model)` says where each
  program of the last fit came from: a fit in a fresh process on a warm
  cache runs nvcc 0 times and reports its programs "cached".

- The distributed fit (JAX `_resolve_sharding_rules` L581,
  `check_global_batch` L183, the checks of L1126-1200 and the sharded
  placement of L1316-1398). With `distributed=True` (the default) a fit
  under a context (`common/context.py`) runs over its mesh of ranks: each
  process is one rank, feeds its own share of the global `batch_size`
  (`batch_size / ranks` rows a step, from its own data, as each JAX
  process feeds its local shard), and every reduction the JAX package
  gets from GSPMD is an explicit collective of the mesh: the whole
  batch's mean gradient (one all-reduce of the replicated leaves'
  gradients over the batch axes, with the step's loss riding in it as
  the last element, so the loss of every step and the epoch's mean are
  the global batch's; one reduce-scatter of the sharded leaves'
  gradients over fsdp, then an all-reduce over data). The optimizers have
  no global-norm clipping to reduce (nor does the JAX package's).
  `sharding_rules` (True: `TRANSFORMER_RULES`; a `ShardingRules`; None:
  the config's `sharded_fit`) shards parameters and optimizer state over
  the fsdp axis (`parallel/sharding.ShardLayout`): each rank keeps its
  blocks of the sharded leaves as the f32 masters and their moments, the
  module's own tensors of those leaves are emptied during the fit, and
  each step gathers the whole parameters for its forward. The optimizer
  steps the local blocks and replicated leaves (the fused-Adam kernel:
  one launch a sweep per rank). After the fit the module holds the whole
  parameters again. A checkpoint gathers the blocks into the JAX layout
  and rank 0 alone writes and publishes it; auto-resume reads it on every
  rank and shards it again. The JAX refusals are kept: `sharding_rules`
  with `distributed=False`, with `lazy_embeddings`, the fsdp=1 warning,
  the global batch against data x fsdp and the process count, a mesh whose
  batch axes do not span every rank, unequal local sample counts, a
  streaming factory without `shards_per_host`, `device_cache=True` over
  more than one process. The port runs `sharding_rules` across
  processes, which the JAX fit refuses (L1183-1191): there a process
  spans several devices. Departures: a spec that names `tensor` (size >
  1) raises NotImplementedError (ROADMAP item 7b); a multi-rank fit of a
  model with buffers (BatchNorm's moving statistics, which the JAX
  forward reduces over the global batch) and a fit with
  `lazy_embeddings` over a process group raise NotImplementedError; each
  rank folds its batch index into its step seeds, so the ranks draw
  other dropout masks for their rows, as the rows of a JAX global batch
  do; a fit that fails across ranks leaves no emergency checkpoint (it
  would need every rank). Validation: each rank evaluates the validation
  data it holds on the whole parameters, as each JAX process evaluates
  its own (L1906-1913). Programs: a fit whose
  collectives run over NCCL captures its steps, collectives included; a
  fit over gloo (ranks on the CPU, or sharing a card) runs them eagerly,
  a rule decided before any capture, logged and exposed as the
  `training_step_graphs` gauge.

The optimizer state starts fresh at each call unless it resumes, as in the
JAX package.
"""

from __future__ import annotations

import base64
import contextlib
import itertools
import logging
import queue
import threading
import time
import weakref
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.common import triggers as tg
from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_map
from analytics_zoo_tpu_torch.kernels import _build
from analytics_zoo_tpu_torch.observability.registry import get_registry
from analytics_zoo_tpu_torch.kernels.philox import DeviceSeed
from analytics_zoo_tpu_torch.ops.optimizers import (as_fused, step_scalars,
                                                    takes_scalars)

log = logging.getLogger("analytics_zoo_tpu_torch.learn")

# The meta key of the step-seed generator's state (the JAX package keeps
# its jax key under "rng").
GENERATOR_KEY = "torch_generator"


class _TrainingMetrics:
    """Training telemetry published into the process-wide registry — the
    same spine the serving side feeds (JAX L38-141). Registration is
    get-or-create: repeated fits converge on the same families and
    counters accumulate across fits."""

    def __init__(self, registry=None):
        reg = registry if registry is not None else get_registry()
        self.step_ms = reg.histogram(
            "training_step_ms",
            "per-step wall time, averaged over each epoch's device sync")
        self.steps = reg.counter("training_steps_total",
                                 "optimizer steps run")
        self.samples = reg.counter("training_samples_total",
                                   "training samples consumed")
        self.epochs = reg.counter("training_epochs_total",
                                  "epochs completed")
        self.loss = reg.gauge("training_loss", "mean loss of the last epoch")
        self.throughput = reg.gauge("training_samples_per_sec",
                                    "last epoch's training throughput")
        self.mfu = reg.gauge(
            "training_mfu",
            "model FLOPs utilization vs the card's bf16 peak (needs "
            "flops_per_step)")
        self.val = reg.gauge("training_validation_metric",
                             "last validation metrics, labeled by name")
        self.resumes = reg.counter(
            "training_resumes_total",
            "training runs continued from a checkpoint by auto_resume")
        self.step_retries = reg.counter(
            "training_step_retries_total",
            "failed/hung training steps retried by the step watchdog")
        self.input_wait_ms = reg.histogram(
            "training_input_wait_ms",
            "per-step wall time the training loop sat blocked on the "
            "prefetch queue before dispatching (the input-stall "
            "histogram)")
        self.input_bound = reg.gauge(
            "training_input_bound",
            "fraction of the last epoch's time the step loop spent "
            "blocked on the prefetch queue (0 = device-bound, 1 = fully "
            "input-bound)")
        self.graphs = reg.gauge(
            "training_step_graphs",
            "1 when the fit's steps replay CUDA graphs, 0 when they run "
            "eagerly (the CPU, or collectives over gloo)")
        self.state_bytes = reg.gauge(
            "training_state_bytes_per_rank",
            "bytes of this rank's f32 master parameters and optimizer "
            "state in the last fit (1/fsdp of a replicated fit's for the "
            "sharded leaves)")
        self.collective_ms = reg.gauge(
            "training_collective_ms",
            "host milliseconds a step spent in the mesh's collectives "
            "over the last epoch's eager steps (a replayed graph's are "
            "not seen)")
        self.host_staged = reg.counter(
            "training_collectives_host_staged_total",
            "collectives that copied a CUDA tensor to the host and back "
            "(gloo)")

    def epoch(self, steps: int, n_seen: int, dt: float, mean_loss: float,
              flops_per_step: Optional[float] = None,
              device=None) -> float:
        step_ms = dt / max(steps, 1) * 1e3
        self.step_ms.observe(step_ms)
        self.steps.inc(steps)
        self.samples.inc(n_seen)
        self.epochs.inc()
        self.loss.set(mean_loss)
        self.throughput.set(n_seen / max(dt, 1e-9))
        if flops_per_step:
            from analytics_zoo_tpu_torch.utils.roofline import peak_flops
            self.mfu.set(flops_per_step * steps / max(dt, 1e-9)
                         / peak_flops(device))
        return step_ms

    @staticmethod
    def roofline(flops: float, bytes_: float, dt: float, device=None):
        """`roofline_mfu{kind="train"}` and the other roofline gauges from
        one epoch's counted FLOPs and bytes over its device time."""
        from analytics_zoo_tpu_torch.observability.roofline import \
            get_accountant
        get_accountant().account("train", flops, bytes_, dt, device=device)


# ---------------------------------------------------------------------------
# Data plumbing: numpy structures -> batches
# ---------------------------------------------------------------------------
def _tree_len(x) -> int:
    leaves = tree_leaves(x)
    if not leaves:
        raise ValueError("Empty input data")
    return int(np.shape(leaves[0])[0])


def _tree_take(x, idx):
    return tree_map(lambda a: np.asarray(a)[idx], x)


def _num_batches(n: int, batch: int, drop_remainder: bool) -> int:
    return n // batch if drop_remainder else -(-n // batch)


def iter_batches(x, y=None, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 0, drop_remainder: bool = True,
                 pad_to_batch: bool = False):
    """Yield (x_batch, y_batch, real_count) of numpy arrays."""
    n = _tree_len(x)
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    nb = _num_batches(n, batch_size, drop_remainder and not pad_to_batch)
    for b in range(nb):
        sel = idx[b * batch_size:(b + 1) * batch_size]
        real = len(sel)
        if real < batch_size:
            if pad_to_batch:
                sel = np.concatenate([sel, np.repeat(sel[-1:],
                                                     batch_size - real)])
            else:
                continue
        xb = _tree_take(x, sel)
        yb = _tree_take(y, sel) if y is not None else None
        yield xb, yb, real


def _step_with_watchdog(step_fn, args, retries: int,
                        timeout_s: Optional[float], retry_counter,
                        iteration: int, device: torch.device):
    """One training step under the fault-tolerance contract: a failed step
    is retried up to `retries` times; with `timeout_s` the step runs on a
    watchdog thread (on `device` and the caller's current stream) so a hung
    step surfaces as TimeoutError instead of a silent stall. The
    `trainer.step` fault point fires before the step starts, so an
    injected failure retries on untouched parameters. A real failure
    inside the step may leave them half-updated (the step writes in
    place); the caller's emergency checkpoint then records them as they
    are and the last periodic checkpoint stays the resume point."""
    stream = torch.cuda.current_stream(device) \
        if device.type == "cuda" else None
    attempts = 0
    while True:
        try:
            if timeout_s is None:
                faults.fire("trainer.step", iteration=iteration,
                            attempt=attempts)
                return step_fn(*args)
            box: Dict[str, Any] = {}
            cancelled = threading.Event()
            done = threading.Event()

            def run():
                try:
                    faults.fire("trainer.step", iteration=iteration,
                                attempt=attempts)
                    if cancelled.is_set():
                        return          # timed out during the stall
                    if stream is None:
                        box["out"] = step_fn(*args)
                    else:
                        with torch.cuda.device(device), \
                                torch.cuda.stream(stream):
                            box["out"] = step_fn(*args)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    box["exc"] = e
                finally:
                    done.set()

            t = threading.Thread(target=run, daemon=True,
                                 name="train-step-watchdog")
            t.start()
            if not done.wait(timeout_s):
                cancelled.set()
                # grace window: a step that is merely slow completes here
                # and its result is valid; retrying instead would race it
                # on the parameters it is writing in place (its kernels
                # keep running on the stream after the timeout)
                if done.wait(timeout_s) and "out" in box:
                    log.warning(
                        "training step %d exceeded the %ss watchdog but "
                        "completed in the grace window; using its result "
                        "(raise step_timeout_s if this recurs)",
                        iteration, timeout_s)
                    return box["out"]
                raise TimeoutError(
                    f"training step {iteration} exceeded the "
                    f"{timeout_s}s watchdog")
            if "exc" in box:
                raise box["exc"]
            if "out" not in box:
                raise RuntimeError(
                    f"training step {iteration} was cancelled by an "
                    "earlier watchdog timeout")
            return box["out"]
        except Exception as e:  # noqa: BLE001 — retry policy owns this
            attempts += 1
            if attempts > retries:
                raise
            retry_counter.inc()
            log.warning(
                "training step %d failed (%s: %s); retry %d/%d",
                iteration, type(e).__name__, e, attempts, retries)


class _StepCostTracker:
    """Per-fit accumulation of the train step's counted FLOPs and bytes
    for the roofline gauges (JAX L310-467). Per input signature (the
    shapes and dtypes of the batch), the first step runs for real under a
    `CostMeter` (`observability.roofline.count_cost`): the meter only
    looks at the operators, so the step computes what it computes
    without it. Its cost is memoized in `memo`, a dict on the model keyed
    like the step, and every later step of that signature, in this fit or
    a later one, adds the memoized cost without counting. The counted
    step's host seconds go to `memo[HARVEST_KEY]`. The JAX package lowers
    the step instead; its per-step cost is the same kind of number, the
    logical work of one step (the kernels' declared costs included)."""

    HARVEST_KEY = "__harvest_s__"

    def __init__(self, memo: Dict):
        self._memo = memo
        self.flops = 0.0
        self.bytes = 0.0
        self.calls = 0

    def reset_epoch(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0
        self.calls = 0

    def _accumulate(self, cost) -> None:
        self.flops += cost.flops
        self.bytes += cost.bytes
        self.calls += 1

    @staticmethod
    def _sig(batch) -> Tuple:
        return tuple((tuple(t.shape), str(t.dtype))
                     for t in tree_leaves(batch) if t is not None)

    def step_fn(self, one_step: Callable, batch) -> Callable:
        """`one_step` itself when the signature's cost is known (after
        adding it), else `one_step` run under a meter."""
        key = self._sig(batch)
        cost = self._memo.get(key)
        if cost is not None:
            self._accumulate(cost)
            return one_step

        def counted(*args):
            from analytics_zoo_tpu_torch.observability.roofline import \
                count_cost
            t0 = time.perf_counter()
            out, cost = count_cost(one_step, *args)
            self._memo.setdefault(self.HARVEST_KEY, []).append(
                time.perf_counter() - t0)
            self._memo[key] = cost
            self._accumulate(cost)
            return out

        return counted

    def add(self, sig: Tuple, steps: int) -> None:
        """`steps` replayed steps of input signature `sig`, at its
        memoized cost."""
        cost = self._memo.get(sig)
        if cost is None:
            return
        self.flops += cost.flops * steps
        self.bytes += cost.bytes * steps
        self.calls += steps


class _PinnedUploader:
    """The card's side of the prefetcher: a batch of numpy arrays copied
    into pinned staging buffers (torch's copy, on its intra-op threads),
    then to the card by non-blocking copies on a side stream, after which
    an event is recorded. A staging buffer is reused (by shape and dtype)
    only once its copy's event has completed. The device tensors are
    allocated on the side stream; the consumer makes its stream wait on
    the event and records them to that stream (`_await_upload`). Runs on
    the prefetch thread only."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._pool: Dict[Tuple, List[Tuple[torch.Tensor, Any]]] = {}

    def _staging(self, shape: Tuple, dtype: torch.dtype) -> torch.Tensor:
        pool = self._pool.setdefault((shape, dtype), [])
        for i, (buf, done) in enumerate(pool):
            if done.query():
                del pool[i]
                return buf
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def __call__(self, item):
        xb, yb, real = item
        used: List[torch.Tensor] = []

        def upload(a):
            src = torch.from_numpy(np.ascontiguousarray(a))
            buf = self._staging(tuple(src.shape), src.dtype)
            buf.copy_(src)
            used.append(buf)
            return buf.to(self.device, non_blocking=True)

        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            xd = tree_map(upload, xb)
            yd = tree_map(upload, yb) if yb is not None else None
            done = torch.cuda.Event()
            done.record(self.stream)
        for buf in used:
            self._pool[(tuple(buf.shape), buf.dtype)].append((buf, done))
        return xd, yd, real, done


def _host_transfer(item):
    """The CPU's side of the prefetcher: tensors over the batch's arrays
    (no pinning, no copy to make)."""
    xb, yb, real = item
    as_tensor = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a))
    return (tree_map(as_tensor, xb),
            tree_map(as_tensor, yb) if yb is not None else None, real, None)


def _await_upload(done, batch, device: torch.device) -> None:
    """Make the step's stream (the caller's current stream, which the
    step watchdog runs the step on too) wait for an upload, and record
    the uploaded tensors to it so the allocator does not hand their
    memory back to the side stream while the step reads them."""
    if done is None:
        return
    stream = torch.cuda.current_stream(device)
    stream.wait_event(done)
    for t in tree_leaves(batch):
        if t is not None:
            t.record_stream(stream)


class _Prefetcher:
    """Background-thread batch prefetch (JAX L470-549): prepares and
    uploads the next item while the device runs the current one,
    depth-bounded so host memory stays flat. An error in the worker is
    raised in the consumer; `close()` retires the worker. Every consumer
    `__next__` times how long it sat blocked on the queue — the device's
    input stall: `wait_s` accumulates the epoch total and `on_wait`
    receives each wait."""

    _END = object()

    def __init__(self, source_iter, transfer, depth: int = 2,
                 on_wait=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = False
        self._on_wait = on_wait
        self.wait_s = 0.0

        def worker():
            try:
                for item in source_iter:
                    out = transfer(item)
                    while not self._stop:
                        try:
                            self._q.put(out, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop:
                        return
            except BaseException as e:  # noqa: BLE001 — raised in consumer
                self._err = e
            finally:
                # blocking put with stop checks: a full queue must not
                # swallow the END sentinel (the consumer would hang)
                while not self._stop:
                    try:
                        self._q.put(self._END, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._t = threading.Thread(target=worker, daemon=True,
                                   name="train-prefetch")
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        waited = time.perf_counter() - t0
        self.wait_s += waited
        if self._on_wait is not None:
            try:
                self._on_wait(waited)
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        if item is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Unblock and retire the worker (an early exit: end_trigger, a
        failure, the emergency checkpoint)."""
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class _EpochClock:
    """An epoch's seconds: CUDA events on the step's stream on the card
    (read after the epoch's loss sync), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._device = device

    def start(self) -> None:
        if self._cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record(torch.cuda.current_stream(self._device))
        else:
            self._t0 = time.perf_counter()

    def seconds(self) -> float:
        if not self._cuda:
            return time.perf_counter() - self._t0
        t1 = torch.cuda.Event(enable_timing=True)
        t1.record(torch.cuda.current_stream(self._device))
        t1.synchronize()
        return self._t0.elapsed_time(t1) / 1e3


def _to_device(tree, device: torch.device):
    return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        device, non_blocking=True), tree)


def _cast_tree(tree: Dict[str, torch.Tensor], dtype: torch.dtype,
               only: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    return {k: v.to(dtype) if v.dtype == only else v
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# One step
# ---------------------------------------------------------------------------
def build_train_step(model, loss_fn: Callable, optimizer,
                     mixed_precision: bool = False,
                     layout=None) -> Callable:
    """One iteration as a function, `one_step(params, opt_state, xb, yb,
    seed, scalars) -> (params, opt_state, loss)`: forward, backward and
    the optimizer step. `params` are the model's own parameters (the f32
    masters), updated in place. `seed` is the step seed (an int, or a
    `DeviceSeed` in the scalar table); `scalars`, the optimizer's part of
    the step's row on the device (`one_step.scalars(opt_state)` gives its
    host values; None: the optimizer computes and uploads them).

    With a `layout` (`parallel/sharding.ShardLayout`, a fit over a process
    group) `params` holds this rank's blocks of the sharded leaves: the
    step gathers the whole parameters for the forward, reduces the
    gradients to the global batch's mean (`layout.reduce_grads`), steps
    the blocks and returns the global batch's mean loss.

    The step holds `model` weakly, as the lazy and fused one-steps do: the
    trainer caches it on the model (`_train_cache`), and a strong
    reference would make a cycle that keeps a dead model's programs and
    graph pools until a garbage collection. The caller keeps the model."""
    model = weakref.ref(model)
    fused_apply = getattr(optimizer, "fused_apply", None)
    with_row = takes_scalars(optimizer)

    def one_step(params, opt_state, xb, yb, seed, scalars=None):
        leaves = params
        if layout is not None:
            leaves = layout.gather_dict(params)
            for name in layout.sharded:
                leaves[name].requires_grad_()
        with torch.enable_grad():
            p = _cast_tree(leaves, torch.bfloat16) if mixed_precision \
                else leaves
            pred = functional_call(model(), p, (xb,),
                                   {"training": True, "seed": seed})
            if mixed_precision:
                pred = tree_map(lambda a: a.float(), pred)
            loss = loss_fn(yb, pred)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {n: torch.zeros_like(t) if g is None else g
                 for (n, t), g in zip(leaves.items(), grads)}
        if layout is not None:
            grads, loss = layout.reduce_grads(grads, loss)
        kw = {"scalars": scalars} if with_row and scalars is not None \
            else {}
        with torch.no_grad():
            if fused_apply is not None:
                params, opt_state = fused_apply(grads, opt_state, params,
                                                **kw)
            else:
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params, **kw)
                for name, t in params.items():
                    t.add_(updates[name])
        return params, opt_state, loss.detach()

    one_step.scalars = lambda opt_state: step_scalars(optimizer, opt_state)
    return one_step


def _resolve_fused(model, optimizer, fused_optimizer: Optional[bool],
                   lazy_specs=None):
    """The optimizer a fit steps with: the fused twin when asked for and
    one exists (JAX L1343-1369, minus the availability probe). Without a
    twin, a fit with lazy tables still takes the segment kernels for the
    tables (`_pick_one_step`); the rest keeps the plain optimizer."""
    if not fused_optimizer:
        return optimizer
    spec = getattr(model, "_optimizer_spec", None)
    twin = as_fused(optimizer, spec)
    if twin is not None:
        return twin
    if lazy_specs:
        log.warning("fused_optimizer: compiled optimizer %r has no exact "
                    "fused twin; embedding tables take the fused segment "
                    "path, the rest stays on the plain optimizer", spec)
    else:
        log.warning("fused_optimizer requested but the compiled optimizer "
                    "(%r) has no exact fused twin (only default-"
                    "hyperparameter adam/adamw specs map); keeping the "
                    "plain path", spec)
    return optimizer


def _pick_one_step(model, loss_fn, optimizer, mixed_precision: bool,
                   lazy_specs, fused: bool, layout=None) -> Callable:
    if layout is not None:
        return build_train_step(model, loss_fn, optimizer, mixed_precision,
                                layout)
    if lazy_specs:
        if fused:
            from analytics_zoo_tpu_torch.kernels.segment_update import \
                make_fused_one_step
            return make_fused_one_step(model, loss_fn, optimizer, lazy_specs,
                                       mixed_precision)
        from analytics_zoo_tpu_torch.learn.lazy_embedding import \
            make_lazy_one_step
        return make_lazy_one_step(model, loss_fn, optimizer, lazy_specs,
                                  mixed_precision)
    return build_train_step(model, loss_fn, optimizer, mixed_precision)


def _opt_layout(optimizer) -> str:
    """The layout marker auto-resume checks: a fused fit's state
    (FusedAdamState) differs from the stock optax chain's."""
    return "fused" if getattr(optimizer, "fused_apply", None) is not None \
        else "tree"


# ---------------------------------------------------------------------------
# The distributed fit (JAX L183, L581-594, L1126-1200, L1316-1398)
# ---------------------------------------------------------------------------
def check_global_batch(batch_size: int, dp: int, fsdp: int = 1) -> None:
    """`dp` is the full batch-splitting extent (data × fsdp — BOTH are
    batch axes, `common/mesh.BATCH_AXES`); `fsdp` names the fsdp part so
    the error can say which axis the caller actually configured."""
    if batch_size % dp != 0:
        if fsdp > 1:
            raise ValueError(
                f"global batch_size ({batch_size}) must be a multiple of "
                f"the batch-splitting extent {dp} = data ({dp // fsdp}) × "
                f"fsdp ({fsdp}) — the fsdp axis splits the batch too "
                f"(ZeRO-style sharding rides the data path). Use a "
                f"batch_size that is a multiple of {dp}, or shrink the "
                f"fsdp axis to a divisor of your batch.")
        raise ValueError(
            f"global batch_size ({batch_size}) must be a multiple of the "
            f"data-parallel size ({dp}) — the reference's total-core-number "
            f"contract (tf_dataset.py:142-147)")


def _resolve_sharding_rules(sharding_rules, ctx):
    """Normalize the fit's `sharding_rules` knob: None consults the
    config passthrough (`ZooConfig.sharded_fit` / env ZOO_SHARDED_FIT),
    True means the default transformer table, a `ShardingRules` passes
    through. Returns a ShardingRules or None (replicated fit)."""
    if sharding_rules is None and ctx is not None \
            and getattr(ctx.config, "sharded_fit", False):
        sharding_rules = True
    if sharding_rules is True:
        from analytics_zoo_tpu_torch.parallel.sharding import \
            TRANSFORMER_RULES
        return TRANSFORMER_RULES
    if sharding_rules is False:
        return None
    return sharding_rules


# an odd 64-bit constant: a rank's step seed is the drawn seed plus its
# batch index times this (mod 2^62), so the ranks' dropout masks differ
_RANK_SEED_STRIDE = 0x9E3779B97F4A7C15


class _Distributed:
    """A fit over a process group: the mesh, the parameters' layout
    (`ShardLayout`: every leaf replicated without sharding rules), whether
    its steps may be captured (NCCL only) and its key."""

    def __init__(self, mesh, rules, params: Dict[str, torch.Tensor]):
        from analytics_zoo_tpu_torch.parallel.sharding import (
            ShardingRules, ShardLayout, sharding_descriptor)
        if rules is None:      # every leaf replicated
            rules = ShardingRules([], fsdp_fallback=False)
        self.mesh = mesh
        self.layout = ShardLayout(params, mesh, rules)
        self.graphs = mesh.backend == "nccl"
        self.key = sharding_descriptor(mesh, rules)

    def seeds(self, seeds: List[int]) -> List[int]:
        i = self.mesh.batch_index
        return [(s + i * _RANK_SEED_STRIDE) % 2 ** 62 for s in seeds]

    def shard(self, model, params, opt_state):
        """(masters, state): this rank's blocks of the sharded leaves (the
        replicated leaves are the module's own parameters) and of their
        moments; the module's tensors of the sharded leaves are emptied."""
        masters = self.layout.shard(params)
        opt_state = self.layout.shard(opt_state)
        self.release(model)
        return masters, opt_state

    def release(self, model) -> None:
        for name in self.layout.sharded:
            p = model.get_parameter(name)
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def restore(self, model, masters: Dict[str, torch.Tensor]) -> None:
        """The whole parameters back into the module (a collective: every
        rank calls it)."""
        if not self.layout.sharded:
            return
        full = self.layout.gather_dict(masters)
        for name in self.layout.sharded:
            model.get_parameter(name).data = full[name].detach()


def restore_training_state(model, optimizer, opt_state, gen: torch.Generator,
                           path: str, lazy: bool = False):
    """Auto-resume's restore: the newest intact epoch-boundary checkpoint
    under `path` (`find_resume_checkpoint`) into the model's parameters and
    buffers (remapped onto its layer names), into `opt_state` (a fresh
    `init` of `optimizer`, filled in place; a checkpoint without optimizer
    state leaves it fresh) and into `gen`'s state. Returns
    `(opt_state, meta)` with `meta["iteration"]` set, or None when there
    is no checkpoint. Raises ValueError when the checkpoint's
    `opt_state_layout` is not the one `optimizer` builds."""
    from analytics_zoo_tpu_torch import convert
    from analytics_zoo_tpu_torch.learn.checkpoint import (
        find_resume_checkpoint, load_checkpoint)
    found = find_resume_checkpoint(path)
    if found is None:
        return None
    run_dir, version, _ = found
    # verify=False: find_resume_checkpoint CRC-verified exactly this
    # version moments ago
    saved_params, saved_opt, meta = load_checkpoint(run_dir, version,
                                                    verify=False)
    if saved_opt is not None:
        saved_layout = meta.get("opt_state_layout", "tree")
        if saved_layout != _opt_layout(optimizer):
            raise ValueError(
                f"auto_resume: checkpoint optimizer state is "
                f"{saved_layout!r} but this fit would build "
                f"{_opt_layout(optimizer)!r} (fused_optimizer toggled "
                "between runs?); re-run with the original setting")
    # a fresh process's auto-generated layer names differ from the
    # checkpointing process's: remap onto this instance
    model.load_state_dict(convert.state_from_jax(
        model._remap_loaded(saved_params), model))
    if saved_opt is not None:
        opt_state = convert.opt_layout_from_jax(
            optimizer, convert.remap_moment_trees(
                saved_opt, list(saved_params), model._remap_loaded),
            opt_state, model, lazy=lazy)
    if GENERATOR_KEY in meta:
        gen.set_state(torch.frombuffer(bytearray(base64.b64decode(
            meta[GENERATOR_KEY])), dtype=torch.uint8))
    else:
        log.warning(
            "auto-resume: checkpoint has no %s state (written by the JAX "
            "package?); continuing with a fresh generator — dropout seeds "
            "will differ from the uninterrupted run", GENERATOR_KEY)
    meta = dict(meta, iteration=int(meta.get("iteration", version)))
    log.info("auto-resume: continuing from %s/model.%d (epoch %d, "
             "iteration %d)", run_dir, version, int(meta.get("epoch", 0)),
             meta["iteration"])
    return opt_state, meta


# ---------------------------------------------------------------------------
# The device-resident dataset (JAX L905-965)
# ---------------------------------------------------------------------------
# The auto device cache's limit (JAX `ZOO_DEVICE_CACHE_MB`, default 256):
# the port has no environment switches.
DEVICE_CACHE_MB = 256.0


def _epoch_safe_trigger(trigger) -> bool:
    """Triggers that only need epoch-boundary state keep their exact
    semantics when the epoch's steps run without a host check between
    them (JAX L898-902)."""
    return trigger is None or isinstance(trigger, (tg.EveryEpoch,
                                                   tg.MaxEpoch))


def _device_cache_eligible(x, y, mesh, n_proc: int, device_cache,
                           checkpoint_trigger=None,
                           end_trigger=None) -> bool:
    """Auto device residency (JAX L905-928): one process, one device,
    in-memory arrays of at most `DEVICE_CACHE_MB` in all, and no trigger
    that needs mid-epoch granularity; `device_cache=True` always, `False`
    never. `mesh` (None, or an object with `n_devices`) and `n_proc` are
    the JAX signature's; the port runs one process on one device."""
    if device_cache is False or n_proc > 1:
        return False
    if device_cache is True:
        return True
    if mesh is not None and mesh.n_devices > 1:
        return False
    if not (_epoch_safe_trigger(checkpoint_trigger)
            and _epoch_safe_trigger(end_trigger)):
        return False
    nbytes = sum(np.asarray(a).nbytes for a in tree_leaves((x, y))
                 if a is not None)
    return nbytes <= DEVICE_CACHE_MB * 1e6


def _data_fingerprint(tree) -> tuple:
    """Cheap content key of the device data cache (JAX L931-951): the
    identity, shape and dtype of every leaf and the CRC of its head,
    middle and tail 4 KB, so an array refreshed in place is uploaded
    again."""
    parts = []
    for leaf in tree_leaves(tree):
        if leaf is None:
            continue
        a = np.ascontiguousarray(np.asarray(leaf))
        raw = a.reshape(-1).view(np.uint8)
        k = min(len(raw), 4096)
        mid = len(raw) // 2
        parts.append((id(leaf), a.shape, str(a.dtype),
                      zlib.crc32(raw[:k].tobytes()),
                      zlib.crc32(raw[mid:mid + k].tobytes()),
                      zlib.crc32(raw[-k:].tobytes())))
    return tuple(parts)


def _device_cached_data(model, entry, x, y, batch: int):
    """The model's device-resident dataset (`entry.dc`) holding (x, y),
    uploaded once per distinct content and cached on the model (JAX
    L954-965: `model._device_data` keeps the content key, the device views
    and strong references to the host arrays, so the key's identities stay
    valid). New content of the same row shapes and dtypes, and at most as
    many rows, is copied into the same device buffers, so the programs
    captured on them stay valid; other content gets new buffers."""
    key = (_data_fingerprint((x, y)), str(entry.device), batch)
    cached = model.__dict__.get("_device_data")
    dc = entry.dc
    if cached is not None and cached[0] == key and dc is not None:
        return dc
    if dc is None or not dc.fits(x, y, batch):
        dc = entry.new_device_epoch(x, y, batch)
    dc.load(x, y)
    model._device_data = (key, dc.x_view(), dc.y_view(), (x, y))
    return dc


def _epoch_order(n: int, batch: int, shuffle: bool, seed: int) -> np.ndarray:
    """The rows of an epoch's whole batches in order: the host path's own
    `np.random.RandomState(seed + epoch)` shuffle (`iter_batches`), so the
    device-resident epoch trains on the same batches as the host path."""
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    return idx[:(n // batch) * batch].astype(np.int64)


def _chunk_batches(it, k: int):
    """Group (xb, yb, real, uploaded) items into lists of up to k for
    k-step runs (JAX L552-563); the last group may be short and runs as a
    program of its own length."""
    group = []
    for item in it:
        group.append(item)
        if len(group) == k:
            yield group
            group = []
    if group:
        yield group


# ---------------------------------------------------------------------------
# The graphed step: the scalar table, the state, the programs
# ---------------------------------------------------------------------------
def _state_merge(dst, src):
    """`src`'s values in `dst`'s tensors: every tensor leaf of `src` copied
    into `dst`'s leaf (unless it is that tensor), every other leaf taken
    from `src`. A program reads and writes the same state tensors at every
    replay, whatever tensors an update returns."""
    if isinstance(src, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
        return dst
    if isinstance(src, dict):
        return {k: _state_merge(dst[k], v) for k, v in src.items()}
    if isinstance(src, tuple) and hasattr(src, "_fields"):
        return type(src)(*(_state_merge(d, v) for d, v in zip(dst, src)))
    if isinstance(src, (list, tuple)):
        return type(src)(_state_merge(d, v) for d, v in zip(dst, src))
    return src


def _is_count(leaf) -> bool:
    return isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool)


def _counts(tree) -> List[int]:
    """The optimizer state's host integers, in order: its step counts."""
    return [int(v) for v in tree_leaves(tree) if _is_count(v)]


def _advance(tree, steps: int):
    """The state `steps` steps on: every step count plus `steps`. An
    update advances each of its counts by one a step (checked on every
    eager run), so a replay's state needs no Python run of the step."""
    if _is_count(tree):
        return tree + steps
    if isinstance(tree, dict):
        return {k: _advance(v, steps) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_advance(v, steps) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_advance(v, steps) for v in tree)
    return tree


# host rows a table keeps in flight: the host writes step n + 1's rows
# while the card may still copy step n's
_TABLE_RING = 4


class _StepTable:
    """The per-step scalars of a program of `n` steps on the device, one row
    a step: `seeds` int64 `[n]` (the step seeds) and `floats` f32
    `[n, width]` (the one-step's values: the optimizer's rate, bias
    corrections or folded scalars). The host fills the rows with the
    functions that compute them (`torch.randint` on the fit's generator,
    `one_step.scalars`) in pinned staging buffers and copies them to the
    card on the caller's stream before each run."""

    def __init__(self, n: int, width: int, device: torch.device):
        self.width = width
        self.device = device
        self.seeds = torch.zeros(n, dtype=torch.int64, device=device)
        self.floats = torch.zeros((n, max(width, 1)), dtype=torch.float32,
                                  device=device)
        pin = device.type == "cuda"
        self._slots = [[torch.zeros(n, dtype=torch.int64, pin_memory=pin),
                        torch.zeros((n, max(width, 1)), dtype=torch.float32,
                                    pin_memory=pin), None]
                       for _ in range(_TABLE_RING if pin else 1)]
        self._next = 0

    def write(self, seeds: List[int], rows: List[List[float]]) -> None:
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot[2] is not None:
            slot[2].synchronize()      # its last copy has left the buffer
        slot[0].numpy()[:] = seeds
        if self.width:
            slot[1].numpy()[:, :self.width] = rows
        self.seeds.copy_(slot[0], non_blocking=True)
        self.floats.copy_(slot[1], non_blocking=True)
        if self.device.type == "cuda":
            slot[2] = torch.cuda.Event()
            slot[2].record(torch.cuda.current_stream(self.device))

    def seed(self, i: int) -> DeviceSeed:
        return DeviceSeed(self.seeds[i:i + 1])

    def row(self, i: int) -> torch.Tensor:
        return self.floats[i, :self.width]


def _rows_signature(tree) -> Tuple:
    """Structure, row shape and dtype of every leaf of a dataset."""
    leaves = [np.asarray(a) for a in tree_leaves(tree) if a is not None]
    return (str(tree_map(lambda a: None, tree)),
            tuple((a.shape[1:], a.dtype.str) for a in leaves))


class _DeviceEpoch:
    """The device-resident dataset of a model's fits and the cursor its
    programs gather their batches with. The data lies in buffers of `rows`
    rows; `perm` holds the epoch's rows (uploaded once an epoch), and every
    step gathers row `cursor` of `perm` viewed as `[rows // batch, batch]`
    and increments `cursor`, inside the graph."""

    def __init__(self, x, y, batch: int, device: torch.device):
        self.rows = _tree_len(x)
        self.batch = batch
        self.sig = _rows_signature((x, y))
        alloc = lambda a: torch.empty(  # noqa: E731
            np.shape(a), dtype=torch.from_numpy(
                np.ascontiguousarray(np.asarray(a)[:1])).dtype,
            device=device)
        self.x = tree_map(alloc, x)
        self.y = tree_map(alloc, y) if y is not None else None
        self.n = self.steps = 0
        cap = (self.rows // batch) * batch
        self.perm = torch.zeros(cap, dtype=torch.int64, device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self._stage = torch.zeros(cap, dtype=torch.int64,
                                  pin_memory=device.type == "cuda")

    def fits(self, x, y, batch: int) -> bool:
        return (batch == self.batch and _tree_len(x) <= self.rows
                and _rows_signature((x, y)) == self.sig)

    def load(self, x, y) -> None:
        """(x, y) into the first rows of the buffers."""
        self.n = _tree_len(x)
        self.steps = self.n // self.batch

        def put(buf, a):
            buf[:self.n].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        tree_map(put, self.x, x)
        if y is not None:
            tree_map(put, self.y, y)

    def x_view(self):
        return tree_map(lambda a: a[:self.n], self.x)

    def y_view(self):
        return tree_map(lambda a: a[:self.n], self.y) \
            if self.y is not None else None

    def start_epoch(self, order: np.ndarray) -> None:
        self._stage.numpy()[:len(order)] = order
        self.perm.copy_(self._stage, non_blocking=True)
        self.cursor.zero_()
        if self.perm.is_cuda:
            # the next epoch rewrites the staging buffer
            torch.cuda.current_stream(self.perm.device).synchronize()

    def batch_at(self):
        rows = self.perm.view(-1, self.batch).index_select(
            0, self.cursor).view(-1)
        take = lambda a: a.index_select(0, rows)  # noqa: E731
        return (tree_map(take, self.x),
                tree_map(take, self.y) if self.y is not None else None)


class _Program:
    """One training program and its buffers: `n` steps, their scalar
    table and loss buffer, and the static batch of a host program (`xs`,
    `ys`, `[n, B, ...]`) or the device epoch it gathers from."""

    def __init__(self, n: int, table: _StepTable, device: torch.device):
        self.n = n
        self.table = table
        self.loss = torch.zeros(n, dtype=torch.float32, device=device)
        self.xs = self.ys = self.dc = None
        self.program = None
        self.cost_sig = None
        # the capture record: its key, whether the cache held it and the
        # build count when the program began; where it came from, once
        # settled (`_TrainEntry._settle`)
        self.cache_key = None
        self.found = False
        self.compiles = 0
        self.source = None

    def fill(self, group) -> None:
        """Copy a group's batches into the static batch, on the caller's
        stream."""
        for j, (xb, yb, _, _) in enumerate(group):
            tree_map(lambda s, a: s[j].copy_(a, non_blocking=True),
                     self.xs, xb)
            if yb is not None:
                tree_map(lambda s, a: s[j].copy_(a, non_blocking=True),
                         self.ys, yb)


def _static_like(batch, n: int, device: torch.device):
    return tree_map(lambda a: torch.empty((n,) + tuple(a.shape),
                                          dtype=a.dtype, device=device),
                    batch)


class _TrainEntry:
    """What the JAX fit caches on the model as its jitted step (L1439-1490):
    the one-step, the optimizer it steps with, the optimizer state (its
    tensors kept across fits: a new fit's fresh or restored state is
    written into them) and the programs, by kind, length and input
    signature. A fit that finds a storage change of any tensor the
    programs read drops them, and they are captured again."""

    def __init__(self, model, optimizer, one_step, device: torch.device,
                 discriminators: Dict[str, Any], graphs: bool = True,
                 sharding: str = ""):
        # the model holds this entry (`_train_cache`): held back weakly,
        # so the two make no reference cycle
        self._model = weakref.ref(model)
        self.graphs = graphs
        self.sharding = sharding
        self.optimizer = optimizer
        self.one_step = one_step
        self.device = device
        self.discriminators = discriminators
        self.state = None
        self.params: Dict[str, torch.Tensor] = {}
        self.programs: Dict[Tuple, _Program] = {}
        self.ptrs: Tuple = ()
        self.dc: Optional[_DeviceEpoch] = None
        self.width = 0
        self.model_fp = None
        # per fit
        self.cost: Optional[_StepCostTracker] = None
        self.cache = None
        self.shuffle = True
        self.sources: List[Dict[str, str]] = []

    @property
    def model(self):
        return self._model()

    # -- state ------------------------------------------------------------
    def adopt(self, params: Dict[str, torch.Tensor], opt_state):
        """Take a fit's parameters and its starting optimizer state, the
        latter written into the kept state tensors. Returns the state."""
        self.params = params
        self.state = opt_state if self.state is None \
            else _state_merge(self.state, opt_state)
        self.width = len(self.one_step.scalars(self.state))
        return self.state

    def check_storage(self) -> None:
        ptrs = tuple(t.data_ptr() for t in itertools.chain(
            self.params.values(), self.model.buffers(),
            (v for v in tree_leaves(self.state)
             if isinstance(v, torch.Tensor))))
        if ptrs != self.ptrs:
            self.programs.clear()
            self.ptrs = ptrs

    def new_device_epoch(self, x, y, batch: int) -> _DeviceEpoch:
        """New device buffers for (x, y): the programs that gathered from
        the old ones are dropped."""
        self.dc = _DeviceEpoch(x, y, batch, self.device)
        self.programs = {k: p for k, p in self.programs.items()
                         if k[0] != "device"}
        return self.dc

    # -- programs ---------------------------------------------------------
    def _steps(self, prog: _Program, capturing: bool, batch_at,
               after_step=None):
        st = self.state
        for i in range(prog.n):
            xb, yb = batch_at(i)
            step = self.one_step
            if not capturing:
                if i == 0:
                    prog.cost_sig = _StepCostTracker._sig((xb, yb))
                if self.cost is not None:
                    step = self.cost.step_fn(step, (xb, yb))
            _, new, loss = step(self.params, st, xb, yb,
                                prog.table.seed(i), prog.table.row(i))
            st = _state_merge(st, new)
            prog.loss[i].copy_(loss)
            if after_step is not None:
                after_step()
        return st

    def _device_epoch_steps(self, prog: _Program, capturing: bool):
        dc = prog.dc
        return self._steps(prog, capturing, lambda i: dc.batch_at(),
                           lambda: dc.cursor.add_(1))

    def _group_steps(self, prog: _Program, capturing: bool):
        return self._steps(prog, capturing, lambda i: (
            tree_map(lambda a: a[i], prog.xs),
            tree_map(lambda a: a[i], prog.ys)
            if prog.ys is not None else None))

    def _new_program(self, key: Tuple, n: int, group=None) -> _Program:
        from analytics_zoo_tpu_torch.compile_cache.graphs import TrainProgram
        prog = _Program(n, _StepTable(n, self.width, self.device),
                        self.device)
        if group is None:
            prog.dc = self.dc
            name = f"train device-epoch x{n}"
            fn = _TrainEntry._device_epoch_steps
        else:
            prog.xs = _static_like(group[0][0], n, self.device)
            prog.ys = _static_like(group[0][1], n, self.device) \
                if group[0][1] is not None else None
            name = f"train x{n}"
            fn = _TrainEntry._group_steps
        # the entry and the program are arguments of each call: a function
        # that closed over them would make a reference cycle with them,
        # which keeps a dead model's programs and graph pools until a
        # garbage collection
        prog.program = TrainProgram(name, fn, self.device, self.graphs)
        self.programs[key] = prog
        return prog

    def _record_key(self, prog: _Program):
        from analytics_zoo_tpu_torch.compile_cache.key import (
            abstract_signature, make_key, model_fingerprint)
        if self.model_fp is None:
            self.model_fp = model_fingerprint(type(self.model), self.model)
        inputs = [prog.table.seeds, prog.table.floats]
        if prog.dc is not None:
            inputs += [prog.dc.x, prog.dc.y, prog.dc.perm]
        else:
            inputs += [prog.xs, prog.ys]
        dc = prog.dc
        extra = dict(self.discriminators, multi=prog.n > 1,
                     device_cache=dc is not None,
                     dc_steps=dc.rows // dc.batch if dc is not None else 0,
                     shuffle=self.shuffle if dc is not None else None)
        return make_key("train", self.model_fp,
                        abstract_signature(inputs), sharding=self.sharding,
                        extra=extra, device=self.device)

    def run(self, key: Tuple, n: int, seeds: List[int], group=None):
        """One run of the program `key` (made on its first run) over the
        next `n` steps: their rows into its table, the group's batches
        into its static batch, then an eager run or a replay. Returns the
        program's `n` losses (a device tensor)."""
        prog = self.programs.get(key) or self._new_program(key, n, group)
        rows, st = [], self.state
        for _ in range(n):
            rows.append(self.one_step.scalars(st))
            st = _advance(st, 1)
        prog.table.write(seeds, rows)
        if group is not None:
            prog.fill(group)
        if self.cache is not None and prog.source is None \
                and prog.cache_key is None:
            prog.cache_key = self._record_key(prog)
            prog.found = self.cache.load(prog.cache_key) is not None
            prog.compiles = _build.build_events()["compiles"]
        def libraries():
            return _build.library_cache(self.cache) \
                if self.cache is not None else contextlib.nullcontext()

        with libraries():
            out, replayed = prog.program(self, prog)
        if replayed:
            self.state = _advance(self.state, n)
            if self.cost is not None and prog.cost_sig is not None:
                self.cost.add(prog.cost_sig, n)
        else:
            if _counts(out) != [c + n for c in _counts(self.state)]:
                raise RuntimeError(
                    f"{prog.program.name}: an optimizer update advanced "
                    "its state's integers by other than one a step; a "
                    "replayed step could not know its counts")
            self.state = out
            with libraries():
                prog.program.capture(self, prog)
        if prog.source is None and (prog.program.graph is not None
                                    or self.device.type != "cuda"
                                    or not self.graphs):
            self._settle(prog)
        return prog.loss.clone()

    def _settle(self, prog: _Program) -> None:
        """Where the program came from, once it is captured (run, on the
        CPU): "cached" when its capture record was in `compile_cache_dir`
        and nvcc ran 0 times for it, else "compiled" (the record is then
        written); "uncached" without a cache."""
        if self.cache is None:
            prog.source = "uncached"
        elif prog.found and \
                _build.build_events()["compiles"] == prog.compiles:
            prog.source = "cached"
        else:
            prog.source = "compiled"
            if not prog.found:
                self.cache.put(prog.cache_key,
                               prog.program.name.encode())
        self.sources.append({"program": prog.program.name,
                             "source": prog.source})


def _train_entry(model, fused_optimizer: Optional[bool],
                 mixed_precision: bool, lazy_specs, device: torch.device,
                 dfit: Optional[_Distributed] = None) -> _TrainEntry:
    """The model's cached entry under the JAX `cache_key` (L1439-1447: the
    compiled optimizer and loss, mixed precision, lazy tables, fused, the
    sharding descriptor), or a new one."""
    sharding = dfit.key if dfit is not None else ""
    key = (id(model.optimizer), id(model.loss), mixed_precision,
           bool(lazy_specs), bool(fused_optimizer), str(device), sharding,
           id(dfit.mesh) if dfit is not None else None)
    cached = model.__dict__.get("_train_cache")
    if cached is not None and cached[0] == key:
        return cached[1]
    optimizer = _resolve_fused(model, model.optimizer, fused_optimizer,
                               lazy_specs)
    one_step = _pick_one_step(model, model.loss, optimizer, mixed_precision,
                              lazy_specs, bool(fused_optimizer),
                              dfit.layout if dfit is not None else None)
    entry = _TrainEntry(model, optimizer, one_step, device, dict(
        loss=model.loss, optimizer=getattr(optimizer, "update", None),
        mixed_precision=mixed_precision, lazy=bool(lazy_specs),
        fused=bool(fused_optimizer)),
        graphs=dfit.graphs if dfit is not None else True,
        sharding=sharding)
    model._train_cache = (key, entry)
    return entry


def fit_keras(model, x, y=None, batch_size: int = 32, epochs: int = 1,
              validation_data=None, distributed: bool = True,
              shuffle: bool = True, checkpoint_trigger=None,
              end_trigger=None, seed: int = 0,
              batch_iter_factory: Optional[Callable] = None,
              steps_per_run: int = 1, mixed_precision: bool = False,
              prefetch: bool = True,
              prefetch_depth: Optional[int] = None,
              lazy_embeddings: bool = False,
              device_cache: Optional[bool] = None,
              flat_optimizer: bool = False,
              fused_optimizer: Optional[bool] = None,
              sharding_rules=None,
              flops_per_step: Optional[float] = None,
              metrics_report_s: Optional[float] = None,
              compile_cache_dir: Optional[str] = None,
              auto_resume: bool = False,
              int8_sidecar: bool = False,
              step_retries: int = 0,
              step_timeout_s: Optional[float] = None,
              profile_steps: Optional[Tuple[int, int]] = None,
              profile_dir: Optional[str] = None
              ) -> Dict[str, List[float]]:
    """`KerasNet.fit` backend: trains `model` in place on the device its
    parameters live on; returns `{"loss": [mean per epoch]}`, with
    `"val_<metric>"` lists when `validation_data=(x, y)` is given and
    `"profile_artifacts"` when `profile_steps` captured a window.

    `batch_iter_factory(epoch) -> iterator of (xb, yb, real)` replaces the
    in-memory batching (`x` and `y` are then not read). `prefetch`,
    `prefetch_depth`, `flops_per_step`, `metrics_report_s`,
    `profile_steps`, `profile_dir`, `steps_per_run`, `device_cache` and
    `compile_cache_dir` are the JAX package's (the module docstring).
    `distributed` and `sharding_rules` run the fit over the context's mesh
    of ranks (the module docstring). `fused_optimizer=None` means False
    (the port has no environment switch for it). `checkpoint_trigger`,
    `end_trigger`, `auto_resume`, `step_retries` and `step_timeout_s` are
    the JAX package's too."""
    if flat_optimizer:
        raise ValueError("flat_optimizer was retired in the JAX package; "
                         "use fused_optimizer=True")
    from analytics_zoo_tpu_torch.common.context import current_context
    ctx = current_context()
    mesh = ctx.mesh if distributed and ctx is not None else None
    shard_rules = _resolve_sharding_rules(sharding_rules, ctx)
    if shard_rules is not None and mesh is None:
        if sharding_rules is None:
            # config-driven default (ZooConfig.sharded_fit) quietly
            # steps aside for an explicitly non-distributed fit;
            # only the explicit kwarg is a hard contradiction
            shard_rules = None
        elif not distributed:
            raise ValueError(
                "sharding_rules needs distributed=True (the rule "
                "table shards over the context mesh); drop "
                "distributed=False or the rules")
        else:
            # no context: the one-rank mesh a JAX local context on one
            # device would give
            from analytics_zoo_tpu_torch.common.mesh import DeviceMesh
            mesh = DeviceMesh()
    if shard_rules is not None:
        if lazy_embeddings:
            raise NotImplementedError(
                "sharding_rules is incompatible with lazy_embeddings: "
                "the per-table state re-packs the parameter tree the "
                "rule table is written against")
        if mesh.size("fsdp") == 1 and mesh.size("tensor") == 1:
            log.warning(
                "sharding_rules requested but the mesh has fsdp=1 and "
                "tensor=1 (%s): params/opt_state will be fully "
                "replicated. Set the fsdp axis (e.g. "
                "init_orca_context(data=1, fsdp=-1) or ZOO_MESH_FSDP) "
                "to actually shard state.", mesh)
    dp = mesh.data_parallel_size if mesh is not None else 1
    check_global_batch(batch_size, dp,
                       fsdp=mesh.size("fsdp") if mesh is not None else 1)
    # Multi-process: `batch_size` stays GLOBAL (the reference's
    # total-core contract); each process feeds its LOCAL data, sliced at
    # global/process_count per step
    n_proc = mesh.world if mesh is not None else 1
    local_batch = batch_size
    if n_proc > 1:
        if batch_size % n_proc:
            raise ValueError(
                f"global batch_size ({batch_size}) must divide by the "
                f"process count ({n_proc})")
        if dp != n_proc:
            raise NotImplementedError(
                "Multi-process fit currently supports pure data-parallel "
                "meshes (data×fsdp covering all ranks); got "
                f"dp={dp} of {n_proc} ranks")
        if batch_iter_factory is not None and not getattr(
                batch_iter_factory, "shards_per_host", False):
            # a streaming factory that does NOT declare per-host shard
            # assignment would feed every process the same records
            raise NotImplementedError(
                "Multi-process fit over streaming datasets needs "
                "per-host shard assignment: every process would feed "
                "the same records. Use TPUDataset.from_tfrecord (which "
                "shards files per host) or materialize a per-host "
                "shard and pass arrays instead")
        if device_cache is True:
            raise NotImplementedError(
                "device_cache=True is single-process only (each process "
                "would pin the full global dataset); drop the flag for "
                "multi-process fits")
        local_batch = batch_size // n_proc
    dist_fit = mesh is not None and mesh.distributed
    if dist_fit and lazy_embeddings:
        raise NotImplementedError(
            "lazy_embeddings in a fit over a process group: the row-sparse "
            "step has no collective yet (ROADMAP item 7b)")
    if steps_per_run < 1:
        raise ValueError(f"steps_per_run must be >=1, got {steps_per_run}")
    profiler = None
    if profile_steps is not None:
        p_start, p_stop = int(profile_steps[0]), int(profile_steps[1])
        if not 0 <= p_start < p_stop:
            raise ValueError(
                f"profile_steps={profile_steps!r} must be (start, stop) "
                "with 0 <= start < stop")
        from analytics_zoo_tpu_torch.observability.capture import \
            ProfileCapture
        profiler = ProfileCapture(profile_dir or "zoo_profiles")
    depth = int(prefetch_depth) if prefetch_depth else 2
    streaming = batch_iter_factory is not None
    if streaming and device_cache:
        raise NotImplementedError(
            "device_cache=True needs in-memory arrays; streaming input "
            "(batch_iter_factory) has no host copy to keep on the device")
    use_device_cache = not streaming and _device_cache_eligible(
        x, y, mesh, n_proc, device_cache,
        checkpoint_trigger=checkpoint_trigger, end_trigger=end_trigger)
    if batch_iter_factory is None:
        n = _tree_len(x)
        if n_proc > 1:
            # unequal shards would desync the per-step collectives; gather
            # the counts BEFORE any local raise (a rank bailing early would
            # strand the others inside this very collective)
            counts = mesh.all_gather_ints([n])[:, 0]
            if not (counts == counts[0]).all():
                raise ValueError(
                    "Every process must hold the same number of local "
                    f"samples; got {counts.tolist()} across ranks")
        if n < local_batch:
            raise ValueError(
                f"Dataset has {n} samples but the batch is {local_batch}; "
                "training batches are whole-batch only. Lower batch_size "
                "or add data.")
        if not model.built:
            model.ensure_built(x, seed=seed)

        def batch_iter_factory(epoch):  # noqa: F811 — the default factory
            return iter_batches(x, y, local_batch, shuffle=shuffle,
                                seed=seed + epoch)
    elif not model.built:
        try:
            sample = next(iter(batch_iter_factory(0)))[0]
        except StopIteration:
            raise ValueError(
                "Dataset produced no full batches; lower batch_size")
        model.ensure_built(sample, seed=seed)
    if model.optimizer is None:
        raise RuntimeError("Model must be compiled before fit")
    ckpt_path = getattr(model, "_checkpoint_path", None)
    if auto_resume and not ckpt_path:
        raise ValueError(
            "auto_resume=True needs a checkpoint directory; call "
            "model.set_checkpoint(path) first")
    lazy_specs = None
    if lazy_embeddings:
        from analytics_zoo_tpu_torch.learn.lazy_embedding import resolve_specs
        lazy_specs = resolve_specs(model)
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    dfit = None
    if dist_fit:
        if n_proc > 1 and any(b.is_floating_point()
                              for b in model.buffers()):
            raise NotImplementedError(
                "a multi-rank fit of a model with buffers (BatchNorm's "
                "moving statistics): the JAX forward reduces them over "
                "the global batch, a synchronised BatchNorm is not ported "
                "(ROADMAP item 7b)")
        if shard_rules is not None:
            from analytics_zoo_tpu_torch.parallel.sharding import \
                check_fsdp_divisibility
            # fail at config time, not at OOM time
            check_fsdp_divisibility(params, mesh, shard_rules)
        dfit = _Distributed(mesh, shard_rules, params)
        if not dfit.graphs and device.type == "cuda":
            log.info("fit over %s ranks by %s: its steps run eagerly (a "
                     "CUDA graph cannot hold gloo's collectives)",
                     mesh.world, mesh.backend)
    entry = _train_entry(model, fused_optimizer, mixed_precision, lazy_specs,
                         device, dfit)
    optimizer = entry.optimizer
    if lazy_specs:
        from analytics_zoo_tpu_torch.learn.lazy_embedding import init_state
        opt_state = init_state(params, lazy_specs, optimizer)
    else:
        opt_state = optimizer.init(params)
    opt_layout = _opt_layout(optimizer)
    gen = torch.Generator().manual_seed(seed)

    # -- auto-resume: continue from the newest intact epoch-boundary
    # checkpoint instead of step 0 --------------------------------------
    start_epoch = 0
    iteration = 0
    resumed = None
    if auto_resume:
        resumed = restore_training_state(model, optimizer, opt_state, gen,
                                         ckpt_path, lazy=bool(lazy_specs))
        if resumed is not None:
            opt_state, meta = resumed
            start_epoch = int(meta.get("epoch", 0))
            iteration = int(meta["iteration"])
    if dfit is not None:
        params, opt_state = dfit.shard(model, params, opt_state)
    entry.adopt(params, opt_state)
    if use_device_cache:
        _device_cached_data(model, entry, x, y, local_batch)
    entry.check_storage()
    entry.cache = None
    if compile_cache_dir is not None:
        from analytics_zoo_tpu_torch.compile_cache.store import get_cache
        entry.cache = get_cache(compile_cache_dir)
    entry.sources = []
    entry.shuffle = shuffle

    ckpt_mgr = None
    if ckpt_path:
        from analytics_zoo_tpu_torch import convert
        from analytics_zoo_tpu_torch.learn.checkpoint import (
            CheckpointManager, write_publish_marker)
        from analytics_zoo_tpu_torch.serving.quantization import \
            write_int8_sidecar
        if dfit is None or mesh.rank == 0:
            # only rank 0 writes and publishes
            ckpt_mgr = CheckpointManager(ckpt_path)
        if checkpoint_trigger is None:
            checkpoint_trigger = tg.EveryEpoch()

    writer = None
    if getattr(model, "_tensorboard_dir", None):
        from analytics_zoo_tpu_torch.utils.tensorboard import SummaryWriter
        writer = SummaryWriter(model._tensorboard_dir + "/train")
    telemetry = _TrainingMetrics()
    reporter = None
    if metrics_report_s:
        from analytics_zoo_tpu_torch.observability.reporter import \
            MetricsReporter
        reporter = MetricsReporter(interval_s=metrics_report_s,
                                   writer=writer).start()
    if resumed is not None:
        telemetry.resumes.inc()
    telemetry.graphs.set(1.0 if device.type == "cuda" and entry.graphs
                         else 0.0)
    telemetry.state_bytes.set(float(
        _tensor_bytes(entry.params) + _tensor_bytes(entry.state)))

    # the counted roofline: one harvest per (step kind, input signature),
    # memoized on the model (`compile` clears it)
    from analytics_zoo_tpu_torch.observability.roofline import \
        get_accountant
    memo_root = getattr(model, "_roofline_cost_memo", None)
    if memo_root is None:
        memo_root = model._roofline_cost_memo = {}
    cost_tracker = _StepCostTracker(memo_root.setdefault(
        (mixed_precision, bool(lazy_specs), bool(fused_optimizer)), {}))
    entry.cost = cost_tracker
    get_accountant().reset("train")

    uploader = _PinnedUploader(device) if prefetch \
        and device.type == "cuda" else None
    clock = _EpochClock(device)
    profile_state = {"active": False, "done": False}

    def _profile_tick(it: int):
        """Start the capture when the iteration counter reaches `start`,
        stop it once it reaches `stop` (JAX L1584-1618)."""
        if profiler is None or profile_state["done"]:
            return
        try:
            if not profile_state["active"] and it >= p_start:
                profiler.start(tag=f"fit-it{it}")
                profile_state["active"] = True
            elif profile_state["active"] and it >= p_stop:
                manifest = profiler.stop()
                profile_state["active"] = False
                profile_state["done"] = True
                history.setdefault("profile_artifacts", []).append(
                    manifest["dir"])
                log.info("profiler capture written to %s (%d files)",
                         manifest["dir"], len(manifest["files"]))
        except Exception as e:  # noqa: BLE001 — profiling must never
            # take down the fit it watches
            log.warning("profiler capture failed: %s: %s",
                        type(e).__name__, e)
            profile_state["done"] = True

    def _ckpt_extra(ep: int, finished: bool) -> Dict[str, Any]:
        """Checkpoint sidecar: everything auto-resume needs for bitwise
        continuation — epoch/iteration cursors, the step-seed generator,
        and the opt-state layout marker."""
        return {"epoch": ep, "iteration": iteration,
                "epoch_finished": finished,
                GENERATOR_KEY: base64.b64encode(
                    gen.get_state().numpy().tobytes()).decode("ascii"),
                "opt_state_layout": opt_layout}

    def _ckpt_save(extra: Dict[str, Any]) -> None:
        """One commit funnel for every save site (mid-epoch trigger,
        epoch boundary, emergency): the checkpoint set; with
        `int8_sidecar`, the post-training quantization pass on the same
        tree (a failure there is one warning: serving quantizes at load,
        and the version stays unpublished, since the version the fleet
        would quantize at load is not the one meant to be published); then
        the publish marker, the last act (a failure there leaves the
        version resumable but unpublished)."""
        if dfit is not None:
            # every rank gathers; rank 0 writes while the others wait
            full = dfit.layout.gather_dict(entry.params)
            state_dict = {k: full.get(k, v)
                          for k, v in model.state_dict().items()}
            opt_state = dfit.layout.gather(entry.state)
            if ckpt_mgr is None:
                mesh.barrier()
                return
            try:
                _ckpt_write(extra, state_dict, opt_state)
            finally:
                mesh.barrier()
            return
        _ckpt_write(extra, model.state_dict(), entry.state)

    def _ckpt_write(extra, state_dict, opt_state) -> None:
        tree = convert.state_to_jax(state_dict, model)
        ckpt_mgr.save(iteration, tree,
                      convert.opt_layout_to_jax(optimizer, opt_state,
                                                model, lazy=bool(lazy_specs)),
                      extra=extra)
        if int8_sidecar:
            try:
                write_int8_sidecar(ckpt_mgr.run_dir, iteration, model,
                                   params=tree)
            except Exception as e:  # noqa: BLE001 — the sidecar is optional
                log.warning("int8 sidecar write failed at iteration %d "
                            "(%s: %s); serving will quantize at load and "
                            "the version stays unpublished", iteration,
                            type(e).__name__, e)
                return
        try:
            write_publish_marker(ckpt_mgr.run_dir, iteration, extra=extra)
        except Exception as e:  # noqa: BLE001 — resume still works
            log.warning("publish marker failed at iteration %d (%s: %s); "
                        "the version resumes but will not roll out",
                        iteration, type(e).__name__, e)

    def _close(batches) -> None:
        if isinstance(batches, _Prefetcher):
            batches.close()

    history: Dict[str, List[float]] = {"loss": []}
    batches = None
    epoch = start_epoch
    try:
        for epoch in range(start_epoch, epochs):
            it0 = iteration
            n_seen = 0
            losses = []   # device tensors; read once at the end of the epoch
            clock.start()

            coll0 = _collective_totals()

            def draw(k: int) -> List[int]:
                return [int(torch.randint(0, 2 ** 62, (1,), generator=gen))
                        for _ in range(k)]

            if use_device_cache:
                # the device-resident epoch: ⌈steps/k⌉ runs, no batch
                # copied from the host; triggers are checked at the epoch
                # boundary only, as in the JAX package (L1701-1712)
                dc = entry.dc
                batches = None
                dc.start_epoch(_epoch_order(_tree_len(x), local_batch,
                                            shuffle, seed + epoch))
                for at in range(0, dc.steps, steps_per_run):
                    k = min(steps_per_run, dc.steps - at)
                    seeds = draw(k)
                    if dfit is not None:
                        seeds = dfit.seeds(seeds)
                    _profile_tick(iteration)
                    loss = _step_with_watchdog(
                        entry.run, (("device", k), k, seeds),
                        step_retries, step_timeout_s,
                        telemetry.step_retries, iteration, device)
                    iteration += k
                    n_seen += k * local_batch
                    losses.append(loss)
            else:
                source = batch_iter_factory(epoch)
                if prefetch:
                    batches = _Prefetcher(
                        source, uploader or _host_transfer, depth=depth,
                        on_wait=lambda w: telemetry.input_wait_ms.observe(
                            w * 1e3))
                else:
                    batches = ((_to_device(xb, device),
                                _to_device(yb, device) if yb is not None
                                else None, real, None)
                               for xb, yb, real in source)
                for group in _chunk_batches(batches, steps_per_run):
                    for xb, yb, _, uploaded in group:
                        _await_upload(uploaded, (xb, yb), device)
                    k = len(group)
                    seeds = draw(k)
                    if dfit is not None:
                        seeds = dfit.seeds(seeds)
                    _profile_tick(iteration)
                    key = ("host", k, _StepCostTracker._sig(
                        (group[0][0], group[0][1])))
                    loss = _step_with_watchdog(
                        entry.run, (key, k, seeds, group),
                        step_retries, step_timeout_s,
                        telemetry.step_retries, iteration, device)
                    iteration += k
                    n_seen += sum(item[2] for item in group)
                    losses.append(loss)
                    # triggers that read .loss (Min/MaxLoss) sync on it;
                    # counter triggers stay asynchronous; with k steps a
                    # run they are checked every k iterations (JAX
                    # L1741-1761)
                    state = tg.TriggerState(epoch=epoch,
                                            iteration=iteration,
                                            loss=loss[-1])
                    if checkpoint_trigger and ckpt_path and \
                            checkpoint_trigger(state):
                        _ckpt_save(_ckpt_extra(epoch, False))
                    if end_trigger and end_trigger(state):
                        break
            _close(batches)     # an early break leaves the worker mid-queue
            if epoch == start_epoch and not losses:
                raise ValueError(
                    "Dataset produced no full batches; lower batch_size")
            mean_loss = float(torch.cat(losses).cpu().numpy().mean()) \
                if losses else 0.0
            dt = clock.seconds()
            history["loss"].append(mean_loss)
            step_ms = telemetry.epoch(iteration - it0, n_seen, dt, mean_loss,
                                      flops_per_step, device)
            # the prefetch queue's blocked time over the epoch: the share
            # of the fit that was input-bound
            input_wait_s = batches.wait_s \
                if isinstance(batches, _Prefetcher) else 0.0
            telemetry.input_bound.set(min(1.0, input_wait_s / max(dt, 1e-9)))
            if dfit is not None:
                coll = _collective_totals()
                telemetry.collective_ms.set(
                    (coll[0] - coll0[0]) * 1e3 / max(iteration - it0, 1))
                telemetry.host_staged.inc(coll[1] - coll0[1])
            get_accountant().account_stall("train", input_wait_s)
            if cost_tracker.calls:
                telemetry.roofline(cost_tracker.flops, cost_tracker.bytes,
                                   dt, device)
                cost_tracker.reset_epoch()
            throughput = n_seen / max(dt, 1e-9)
            if writer:
                writer.scalar("Loss", mean_loss, iteration)
                writer.scalar("Throughput", throughput, iteration)
                writer.scalar("StepTime_ms", step_ms, iteration)
            log.info("Epoch %d/%d  loss=%.4f  %.0f samples/s", epoch + 1,
                     epochs, mean_loss, throughput)

            if validation_data is not None:
                vx, vy = validation_data
                if dfit is not None:
                    dfit.restore(model, entry.params)
                val = evaluate_keras(model, vx, vy,
                                     batch_per_thread=max(batch_size, 1))
                if dfit is not None:
                    dfit.release(model)
                for k, v in val.items():
                    history.setdefault("val_" + k, []).append(v)
                    telemetry.val.set(v, name=k)
                    if writer:
                        writer.scalar("val_" + k, v, iteration)

            # epoch-boundary checkpoint trigger (EveryEpoch semantics)
            state = tg.TriggerState(epoch=epoch + 1, iteration=iteration,
                                    epoch_finished=True)
            if checkpoint_trigger and ckpt_path and checkpoint_trigger(state):
                _ckpt_save(_ckpt_extra(epoch + 1, True))
            if end_trigger and end_trigger(state):
                break
    except Exception:
        _close(batches)
        # the step watchdog exhausted its retries, or any other failure:
        # leave an emergency checkpoint so auto_resume (or an operator)
        # can continue; skipped when this iteration is already on disk (an
        # emergency save would demote a boundary checkpoint's meta)
        if dfit is not None and mesh.world > 1:
            log.warning("a fit across %d ranks failed at iteration %d: no "
                        "emergency checkpoint (it would need every rank); "
                        "the last periodic checkpoint is the resume point",
                        mesh.world, iteration)
        elif ckpt_mgr is not None and iteration > 0 \
                and iteration not in ckpt_mgr._saved:
            try:
                _ckpt_save(dict(_ckpt_extra(epoch, False), emergency=True))
                log.warning("emergency checkpoint written at iteration %d",
                            iteration)
            except Exception as ce:  # noqa: BLE001 — already failing
                log.warning("emergency checkpoint failed (%s: %s); the "
                            "last periodic checkpoint is the resume "
                            "point", type(ce).__name__, ce)
        raise
    finally:
        _close(batches)
        if dfit is not None:
            dfit.restore(model, entry.params)
        if profiler is not None and profile_state["active"]:
            # a fit that ends (or dies) inside the window still leaves a
            # finished, loadable artifact behind
            try:
                manifest = profiler.stop()
                history.setdefault("profile_artifacts", []).append(
                    manifest["dir"])
            except Exception as e:  # noqa: BLE001 — already tearing down
                log.warning("profiler capture failed: %s: %s",
                            type(e).__name__, e)
        if reporter is not None:
            reporter.stop()   # a final digest (before the writer closes)
        if writer:
            writer.close()
        entry.cost = None
    return history


def _collective_totals() -> Tuple[float, int]:
    """(host seconds, host-staged calls) of the mesh's collectives so far."""
    from analytics_zoo_tpu_torch.common.mesh import collective_stats
    stats = collective_stats().values()
    return (sum(v["seconds"] for v in stats),
            sum(v["host_staged"] for v in stats))


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def program_sources(model) -> List[Dict[str, str]]:
    """The training programs the model's last fit built, in order, each
    with where it came from: "cached" (its capture record was in
    `compile_cache_dir` and nvcc ran 0 times for it), "compiled" or
    "uncached" (no `compile_cache_dir`)."""
    cached = model.__dict__.get("_train_cache")
    return list(cached[1].sources) if cached is not None else []


# ---------------------------------------------------------------------------
# evaluate / predict
# ---------------------------------------------------------------------------
def _model_device(model) -> torch.device:
    """Where the model's tensors live (an int8 model may hold its weights
    in buffers only)."""
    return next(itertools.chain(model.parameters(), model.buffers())).device


def build_eval_step(model, metrics) -> Callable:
    """`eval_step(states, xb, yb, real) -> states`: one forward and every
    metric's update on the first `real` rows, without an autograd
    graph."""
    def eval_step(states, xb, yb, real: int):
        with torch.inference_mode():
            pred = tree_map(lambda a: a[:real], model(xb, training=False))
            return [m.update(s, yb, pred) for m, s in zip(metrics, states)]

    return eval_step


def _forward_numpy(model, xb) -> Any:
    with torch.inference_mode():
        pred = model(xb, training=False)
    return tree_map(lambda a: a.float().cpu().numpy() if a.dtype in (
        torch.bfloat16, torch.float16) else a.cpu().numpy(), pred)


def evaluate_keras(model, x, y=None, batch_per_thread: int = 32,
                   metrics=None) -> Dict[str, float]:
    """The compiled metrics (or the compiled loss, when there are none)
    over `(x, y)`, on the device the parameters live on. Whole batches
    first; then the tail, padded to a whole batch and sliced to its real
    rows before the metrics see it."""
    model.ensure_built(x)
    ms = metrics if metrics is not None else model.metrics
    if not ms:
        from analytics_zoo_tpu_torch.ops.metrics import Loss
        ms = [Loss(model.loss)] if model.loss else []
    if not ms:
        raise ValueError("No metrics to evaluate; compile with metrics=[...]")
    device = _model_device(model)
    batch = batch_per_thread
    eval_step = build_eval_step(model, ms)
    states = [m.init() for m in ms]
    for xb, yb, real in iter_batches(x, y, batch, drop_remainder=False,
                                     pad_to_batch=False):
        states = eval_step(states, _to_device(xb, device),
                           _to_device(yb, device) if yb is not None
                           else None, real)
    n = _tree_len(x)
    tail = n % batch
    if tail:
        sel = np.concatenate([np.arange(n - tail, n),
                              np.repeat([n - 1], batch - tail)])
        yb = _to_device(_tree_take(y, sel[:tail]), device) \
            if y is not None else None
        states = eval_step(states, _to_device(_tree_take(x, sel), device),
                           yb, tail)
    return {m.name: float(m.compute(s)) for m, s in zip(ms, states)}


def predict_keras(model, x, batch_per_thread: int = 32):
    """The model's outputs on `x` as numpy arrays (float32 for a bf16
    model), in batches of `batch_per_thread`, the last padded to a whole
    batch and sliced to its real rows."""
    model.ensure_built(x)
    device = _model_device(model)
    outs: List[Any] = []
    for xb, _, real in iter_batches(x, None, batch_per_thread,
                                    drop_remainder=False, pad_to_batch=True):
        pred = _forward_numpy(model, _to_device(xb, device))
        outs.append(tree_map(lambda a: a[:real], pred))
    if isinstance(outs[0], (list, tuple)):
        return type(outs[0])(np.concatenate([o[i] for o in outs])
                             for i in range(len(outs[0])))
    return np.concatenate(outs)
