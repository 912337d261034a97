"""Parallel streaming host input pipeline.

Copied from `analytics_zoo_tpu/data/pipeline.py` (L1-249): `_ShardError`
(L91), `ShardPipeline` (L113) and `parallel_read` (L225) as they are;
`resolve_workers` (L48) and `host_shard` (L67) with their JAX parts
rewritten: an explicit value wins, then the context config's
`pipeline_workers` (`common/config.py`, env `ZOO_PIPELINE_WORKERS`) or,
without a context, the environment's `ZOO_PIPELINE_WORKERS`, then the
default.
`host_shard` reads its host from `process_topology`: `torch.distributed`'s
rank and world size when a process group is initialised (index 0 of 1
otherwise), where the JAX package reads `jax.process_index()` /
`jax.process_count()`; `allgather_counts` is the JAX package's
`multihost_utils.process_allgather` of one count (`dataset.py:434`).

Every compute-side lever the platform pulls — sharded pjit fit, fused
Pallas optimizer, shared AOT cache — assumes the accelerator is FED. On
a real TPU a BERT step is milliseconds, so the single-threaded Python
decode the seed shipped (`_TFRecordDataset.iter_train` parsing records
one at a time on the consumer thread) makes any file-backed fit
input-bound. This module is the host-side answer, the training twin of
the serving pipeline: a worker pool reads+decodes *shards*
(files / row-groups / index-batches — whatever the dataset's parallel
unit is) concurrently, and a bounded reorder buffer re-serializes the
results so the emitted sample stream is the EXACT shard order the
caller supplied, at any worker count.

Determinism contract: output order is a pure function of the shard
order (which the datasets derive from `(seed, epoch)`), never of
thread scheduling. `pipeline_workers=1` and `=16` produce bitwise-
identical streams — test-asserted in tests/test_input_pipeline.py and
tests/test_torch_data_pipeline.py —
so turning parallelism on cannot change a single training batch.

Memory contract: at most `workers + reorder_slack` decoded shards are
ever resident. Admission is window-gated on the CONSUMER's progress
(a worker may start shard `i` only once shard `i - window` has been
retired), so a slow consumer backpressures the pool instead of the
pool racing ahead and buffering the corpus. A 10 GB corpus streams in
a small fixed host footprint.

Failure contract: a shard that fails to read/decode surfaces ONE
actionable error *naming the shard*, raised at the shard's position in
the stream (deterministic — the same error at any worker count), never
a hang or a silent short epoch.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import (Any, Callable, Iterator, List, Optional, Sequence,
                    Tuple)

log = logging.getLogger("analytics_zoo_tpu_torch.data.pipeline")

# consumer/worker wakeup granularity; purely an interruption bound
# (shutdown latency), never a throughput knob — all handoffs are
# condition-notified
_WAIT_S = 0.1


def resolve_workers(explicit: Optional[int] = None,
                    default: int = 1) -> int:
    """One resolution rule for every dataset/reader knob: an explicit
    per-call `pipeline_workers` wins; otherwise the context config's
    `pipeline_workers` (env `ZOO_PIPELINE_WORKERS`; the environment's alone
    without a context); otherwise `default` (single-threaded —
    parallelism is opt-in)."""
    if explicit is not None:
        return max(1, int(explicit))
    from analytics_zoo_tpu_torch.common.context import current_context
    ctx = current_context()
    try:
        w = int(ctx.config.pipeline_workers) if ctx is not None else \
            int(os.environ.get("ZOO_PIPELINE_WORKERS", "0") or 0)
        if w > 0:
            return w
    except ValueError:
        pass
    return max(1, int(default))


def process_topology() -> Tuple[int, int]:
    """(index, count) of this process: `torch.distributed`'s rank and
    world size where it is initialised, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def allgather_counts(n: int) -> List[int]:
    """Every process's `n`, in rank order (a one-process topology: [n])."""
    import torch
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return [int(n)]
    dev = "cpu"
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    v = torch.tensor([int(n)], dtype=torch.int64, device=dev)
    parts = [torch.empty_like(v) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, v)
    return [int(p.item()) for p in parts]


def host_shard(items: Sequence[Any], index: Optional[int] = None,
               count: Optional[int] = None) -> List[Any]:
    """Deterministic per-host shard assignment: host `index` of `count`
    owns `items[index::count]` — disjoint across hosts, union = all
    items, and a pure function of the item order (shuffle first, then
    assign, and every host's subset is reproducible from the same
    `(seed, epoch)`). Defaults read `process_topology()`, under which
    process order is the data-axis order (the mesh lays ranks out
    row-major with the batch axes outermost of those a fit may use)."""
    if index is None or count is None:
        rank, world = process_topology()
        index = rank if index is None else index
        count = world if count is None else count
    if not (0 <= index < count):
        raise ValueError(f"host_shard: index {index} outside [0, {count})")
    mine = list(items[index:: count])
    if not mine:
        raise ValueError(
            f"host_shard: host {index} of {count} gets no shards from "
            f"{len(items)} — a host with nothing to read would desync "
            "the per-step collectives; use fewer hosts or more shards")
    return mine


class _ShardError:
    """A worker's failure, parked at its shard's sequence slot so the
    consumer raises it deterministically in stream order."""

    __slots__ = ("exc", "label")

    def __init__(self, exc: BaseException, label: str):
        self.exc = exc
        self.label = label

    def raise_(self):
        exc = self.exc
        if self.label and self.label in str(exc):
            raise exc          # already names the shard (tfrecord errors)
        try:
            wrapped = type(exc)(f"{self.label}: {exc}")
        except Exception:  # noqa: BLE001 — exotic exception signature
            wrapped = RuntimeError(
                f"{self.label}: {type(exc).__name__}: {exc}")
        raise wrapped from exc


class ShardPipeline:
    """Worker pool over an ordered shard list with a bounded reorder
    buffer: `read_fn(shard)` runs concurrently, `samples()` yields each
    shard's items strictly in the given shard order.

    `label_fn(shard)` names a shard in errors (default `str`); pass the
    file path for file shards. `reorder_slack` is the extra completed
    shards the buffer may hold beyond the in-flight set (1 keeps the
    pool busy across a slow head-of-line shard without unbounding
    memory). `max_resident` records the high-water mark of decoded
    shards held at once — the bounded-memory contract, assertable in
    tests."""

    def __init__(self, shards: Sequence[Any],
                 read_fn: Callable[[Any], Sequence[Any]],
                 workers: int = 4, reorder_slack: int = 1,
                 label_fn: Callable[[Any], str] = str):
        self._shards = list(shards)
        self._read_fn = read_fn
        self._label_fn = label_fn
        self.workers = max(1, min(int(workers), len(self._shards) or 1))
        self._window = self.workers + max(0, int(reorder_slack))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._done: dict = {}          # seq -> List[sample] | _ShardError
        self._next_submit = 0          # next shard index to hand a worker
        self._next_emit = 0            # next shard index the consumer needs
        self._running = 0              # shards currently being decoded
        self._stop = False
        self.max_resident = 0
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"input-pipeline-{i}")
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    # -- worker side -------------------------------------------------------
    def _claim(self) -> Optional[int]:
        """Next shard index this worker may start, respecting the
        admission window; None once the list is exhausted or stopped."""
        with self._cond:
            while not self._stop:
                if self._next_submit >= len(self._shards):
                    return None
                if self._next_submit < self._next_emit + self._window:
                    seq = self._next_submit
                    self._next_submit += 1
                    self._running += 1
                    return seq
                self._cond.wait(_WAIT_S)
            return None

    def _worker(self):
        while True:
            seq = self._claim()
            if seq is None:
                return
            shard = self._shards[seq]
            try:
                out: Any = list(self._read_fn(shard))
            except Exception as e:  # noqa: BLE001 — parked for the consumer
                out = _ShardError(e, self._label_fn(shard))
            with self._cond:
                self._running -= 1
                if self._stop:
                    return
                self._done[seq] = out
                resident = len(self._done) + self._running
                if resident > self.max_resident:
                    self.max_resident = resident
                self._cond.notify_all()

    # -- consumer side -----------------------------------------------------
    def samples(self) -> Iterator[Any]:
        """Yield every shard's items in shard order. A shard error
        raises at that shard's position (items of earlier shards were
        already delivered). Always pairs with `close()` — the generator
        closes the pipeline itself on normal exhaustion, early `break`
        (GeneratorExit) and error alike."""
        try:
            for seq in range(len(self._shards)):
                with self._cond:
                    while seq not in self._done and not self._stop:
                        self._cond.wait(_WAIT_S)
                    if self._stop:
                        return
                    out = self._done.pop(seq)
                    self._next_emit = seq + 1
                    self._cond.notify_all()   # window advanced: admit next
                if isinstance(out, _ShardError):
                    out.raise_()
                yield from out
        finally:
            self.close()

    def close(self):
        """Stop the pool and drop buffered shards; idempotent."""
        with self._cond:
            self._stop = True
            self._done.clear()
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parallel_read(items: Sequence[Any], read_fn: Callable[[Any], Any],
                  workers: Optional[int] = None,
                  label_fn: Callable[[Any], str] = str) -> List[Any]:
    """Ordered parallel map over whole items (one result per item) —
    the shape `readers.read_csv`-style per-file loads want: N files
    read concurrently, results in file order, a per-file failure raised
    as one error naming the file. `workers` resolves via
    `resolve_workers` (explicit > config > 1); at 1 this degrades to a
    plain loop with the same error contract."""
    items = list(items)
    w = resolve_workers(workers, default=1)
    if w <= 1 or len(items) <= 1:
        out = []
        for it in items:
            try:
                out.append(read_fn(it))
            except Exception as e:  # noqa: BLE001 — re-raised with name
                _ShardError(e, label_fn(it)).raise_()
        return out
    pipe = ShardPipeline(items, lambda it: [read_fn(it)], workers=w,
                         label_fn=label_fn)
    try:
        return list(pipe.samples())
    finally:
        pipe.close()
