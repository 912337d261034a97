"""InferenceModel — the concurrent inference façade, single device.

Port of `analytics_zoo_tpu/serving/inference_model.py`: `_next_bucket`
(L64), `PendingPrediction` (L71), `_JoinedPending` (L276), the buckets and
the admission semaphore of `InferenceModel.__init__` (L305-395),
`load_keras` (L398), `load_zoo_model` (L425), `load_fn` (L495), `predict`
(L1135), `predict_async` (L1140) and `warmup` (L1231); and the generative decode half (L1353-1671):
`load_generative`, `warmup_generative`, `warmup_generative_paged`,
`generative_prefill`, `generative_step`, `generative_prefill_paged`,
`generative_step_paged` and `account_generative`.

- A batch is padded to a power-of-two bucket by repeating its last row on
  the device, in its own dtype (a uint8 image batch is uploaded and padded
  as uint8; only float64 narrows to float32), and a batch above
  `max_batch` is split into chunks that are all dispatched before any is
  awaited.
- Dispatch is asynchronous: `predict_async` returns once the forward is
  queued on the device; `PendingPrediction.result()` copies the valid rows
  to the host (the one sync) and records dispatch + materialize time in
  the `predict` Timer.
- `warmup` runs every bucket once at load time, so the kernel build (nvcc),
  each kernel's first launch and the cuBLAS set-up never land on the
  request path. (The JAX package warms to compile one XLA program per
  bucket; PyTorch runs eagerly, so there is nothing to compile per shape.)

Generative mode runs two program families: a prefill per prompt bucket
(and, paged, per (chunk bucket, context bucket)) and a decode step per kv
bucket. The JAX package compiles one executable per program at warmup so
that the request path compiles nothing. PyTorch runs eagerly; the port's
warmup runs every program once, so the decode-attention kernel library is
built and loaded and cuBLAS is set up before any request: the request path
builds no kernel (`kernels._build.build_events` shows it).

Not ported yet: replicas and the router, sharded placement, the persistent
compile cache, roofline accounting (`account_generative` is a no-op), fault
points of the forward path and hot swap.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_map
from analytics_zoo_tpu_torch.serving.quantization import INT8_NOT_PORTED
from analytics_zoo_tpu_torch.serving.timer import Timer


def _next_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _as_host_tensor(a) -> torch.Tensor:
    """A request leaf as a C-contiguous CPU tensor (a copy, so a read-only
    or broadcast array is safe); float64 narrows to float32, as jax
    canonicalizes it with x64 off."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, order="C"))
    return t.float() if t.dtype == torch.float64 else t


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:      # numpy has no bfloat16
        t = t.float()
    return t.cpu().numpy()


class PendingPrediction:
    """Async handle from `predict_async`: the device computes while the
    caller keeps dispatching; `result()` materializes the output (the one
    blocking copy) and slices off bucket padding. Idempotent and
    thread-safe."""

    def __init__(self, out, valid_n: int, timer: Optional[Timer] = None,
                 dispatch_s: float = 0.0,
                 ready: Optional[torch.cuda.Event] = None):
        self._out = out
        self._n = valid_n
        self._timer = timer
        self._dispatch_s = dispatch_s
        self._ready = ready
        self._result = None
        self._done = False
        self._lock = threading.Lock()

    def done(self) -> bool:
        """True once the device output is ready; never blocks."""
        if self._done:
            return True
        ready = self._ready
        return ready is None or ready.query()

    def result(self):
        with self._lock:
            if not self._done:
                t0 = time.perf_counter()
                self._result = tree_map(lambda t: _to_numpy(t[:self._n]),
                                         self._out)
                self._out = None            # free device memory promptly
                self._done = True
                if self._timer is not None:
                    # model time = dispatch + materialize wait
                    self._timer.record(self._dispatch_s
                                       + time.perf_counter() - t0)
        return self._result


class _JoinedPending:
    """PendingPrediction over max_batch chunks: each chunk was dispatched
    independently; result() syncs them in order and concatenates."""

    def __init__(self, parts: List[PendingPrediction]):
        self._parts = parts
        self._result = None
        self._done = False
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._done or all(p.done() for p in self._parts)

    def result(self):
        with self._lock:
            if not self._done:
                chunks = [p.result() for p in self._parts]
                self._result = tree_map(lambda *cs: np.concatenate(cs),
                                        *chunks)
                self._parts = []
                self._done = True
        return self._result


class InferenceModel:
    def __init__(self, concurrent_num: int = 1, auto_scaling: bool = False,
                 max_batch: int = 512, device: DeviceLike = None):
        """`device`: where the model serves; `None` is `cuda`, and asking
        for `cuda` without a GPU raises. `concurrent_num` permits bound the
        predict calls dispatching at once (`auto_scaling` grows them on
        contention)."""
        self.device = resolve_device(device)
        self.concurrent_num = concurrent_num
        self.auto_scaling = auto_scaling
        self._sema = threading.BoundedSemaphore(concurrent_num) \
            if not auto_scaling else threading.Semaphore(concurrent_num)
        self._fn: Optional[Callable] = None
        self._params = None
        self.max_batch = max_batch
        self.buckets = [b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
                        if b <= max_batch] or [max_batch]
        self.timer = Timer("predict")
        self.warmup_report: Dict[str, float] = {}
        self.warmed_buckets: set = set()
        self.serving_dtype: str = "float32"
        self._gen_prefill_fn: Optional[Callable] = None
        self._gen_step_fn: Optional[Callable] = None
        self._gen_paged_prefill_fn: Optional[Callable] = None
        self._gen_paged_step_fn: Optional[Callable] = None

    # -- loaders ---------------------------------------------------------
    def load_keras(self, model, params=None,
                   quantize: Optional[str] = None) -> "InferenceModel":
        """A port Keras-style model (a built `KerasNet`, nested models
        included, or a `ZooModel`, served through its `model`). `params`,
        a state dict, is loaded into it first. The model moves to this
        InferenceModel's device in place and is put in eval mode."""
        from analytics_zoo_tpu_torch.models.common import ZooModel
        if isinstance(model, ZooModel):
            model = model.model
        if quantize is not None:
            if quantize != "int8":
                raise ValueError(
                    f"Unsupported quantize={quantize!r}; only 'int8'")
            raise NotImplementedError(INT8_NOT_PORTED)
        if params is not None:
            model.load_state_dict(params)
        if not model.built:
            raise ValueError("Model has no parameters; fit or load first")
        return self.load_fn(lambda m, x: m.apply(x, training=False), model)

    def load_zoo_model(self, cls, path: str,
                       quantize: Optional[str] = None) -> "InferenceModel":
        """`doLoadBigDL` analogue: a `ZooModel` directory saved by either
        package (`cls.load_model`), built on this InferenceModel's
        device."""
        return self.load_keras(cls.load_model(path, device=self.device),
                               quantize=quantize)

    @staticmethod
    def _infer_serving_dtype(weights) -> str:
        """What precision this model serves in, from its weights (tensors):
        any int8 tensor → "int8", else bf16 → "bfloat16", else
        "float32"."""
        dtypes = {t.dtype for t in weights}
        if torch.int8 in dtypes:
            return "int8"
        if torch.bfloat16 in dtypes:
            return "bfloat16"
        return "float32"

    def load_fn(self, fn: Callable, params: nn.Module) -> "InferenceModel":
        """Forward `fn(params, x)`; `params` is the module holding the
        weights (moved to the device in place, put in eval mode)."""
        self._fn = fn
        self.serving_dtype = self._infer_serving_dtype(
            params.state_dict().values())
        self._params = params.to(self.device).eval()
        self.warmup_report = {}
        self.warmed_buckets = set()
        return self

    # -- predict ---------------------------------------------------------
    def predict(self, x) -> np.ndarray:
        """Sync predict: dispatch + materialize."""
        return self.predict_async(x).result()

    def _forward(self, x):
        with torch.inference_mode():
            return self._fn(self._params, x)

    def predict_async(self, x, valid_n: Optional[int] = None):
        """Dispatch without syncing: upload the raw batch once, pad it to
        its bucket on the device by repeating the last row, queue the
        forward and return a `PendingPrediction`. `valid_n` marks how many
        leading records are real when the caller already padded."""
        if self._fn is None:
            raise RuntimeError("No model loaded")
        x = tree_map(_as_host_tensor, x)
        leaves = tree_leaves(x)
        n = leaves[0].shape[0] if leaves[0].dim() > 0 else 1
        valid_n = n if valid_n is None else min(valid_n, n)

        if n > self.max_batch:
            # split oversize inputs into max_batch chunks, all in flight
            parts = []
            for s in range(0, n, self.max_batch):
                part = tree_map(lambda a: a[s:s + self.max_batch], x)
                remain = max(0, valid_n - s)
                parts.append(self.predict_async(
                    part, valid_n=min(remain, self.max_batch)))
            return _JoinedPending(parts)

        acquired = self._sema.acquire(timeout=60)
        if not acquired:
            if not self.auto_scaling:
                raise TimeoutError("predict queue exhausted "
                                   "(concurrent_num permits busy)")
            self._sema.release()  # grow like the reference's auto-scaling
        t0 = time.perf_counter()
        try:
            bucket = _next_bucket(n, self.buckets)
            x = tree_map(lambda a: a.to(self.device, non_blocking=True), x)
            if n != bucket:
                pad = bucket - n
                x = tree_map(lambda a: torch.cat(
                    [a, a[-1:].expand((pad,) + tuple(a.shape[1:]))]), x)
            out = self._forward(x)
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
        finally:
            # the permit bounds dispatch admission, not result lifetime
            if acquired:
                self._sema.release()
        return PendingPrediction(out, valid_n, timer=self.timer,
                                 dispatch_s=time.perf_counter() - t0,
                                 ready=ready)

    # -- warmup ----------------------------------------------------------
    def warmup(self, sample, buckets: Optional[List[int]] = None
               ) -> "InferenceModel":
        """Run every shape bucket once at load time. `sample` is ONE record
        (no batch dim), or a list/dict of records for multi-input models.
        Per-bucket seconds land in `warmup_report`, keyed
        `"{record shape}:b{bucket}"`; warmed buckets in `warmed_buckets`.
        Warmup bypasses `predict`, so the serving Timer stays clean."""
        if self._fn is None:
            raise RuntimeError("No model loaded")
        buckets = list(buckets) if buckets is not None else list(self.buckets)
        sample = tree_map(np.asarray, sample)
        tag = "x".join(map(str, tree_leaves(sample)[0].shape)) or "scalar"
        for b in buckets:
            batch = tree_map(
                lambda a: _as_host_tensor(np.broadcast_to(
                    a[None], (b,) + a.shape)).to(self.device), sample)
            t0 = time.perf_counter()
            self._forward(batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            rkey = f"{tag}:b{b}"
            self.warmup_report[rkey] = round(time.perf_counter() - t0, 4)
            self.warmed_buckets.add(b)
        return self

    # -- generative decode mode ------------------------------------------
    #
    # Autoregressive serving replaces the single forward program with two
    # program families: a PREFILL per prompt bucket (run the padded prompt,
    # park its KV into one pool slot, emit the first token's logits) and a
    # DECODE STEP per kv bucket (one token for every slot at once, windowed
    # to the step's serving bucket). See models/generative.py for the
    # calling contract. Every call runs under `torch.inference_mode` with
    # the model's device current, entered here because the engine calls
    # from its own thread and both are thread-local.

    def load_generative(self, prefill_fn: Callable, step_fn: Callable,
                        params, paged_prefill_fn: Optional[Callable] = None,
                        paged_step_fn: Optional[Callable] = None,
                        ) -> "InferenceModel":
        """Load the decode-mode program pair (and the paged pair). `params`
        is the model's tree (numpy or tensor leaves), moved onto this
        model's device. Single device: the KV pool is one device buffer
        the programs update in place."""
        self._fn = None
        self._gen_prefill_fn = prefill_fn
        self._gen_step_fn = step_fn
        self._gen_paged_prefill_fn = paged_prefill_fn
        self._gen_paged_step_fn = paged_step_fn
        self._params = tree_map(
            lambda a: _as_host_tensor(a).to(self.device), params)
        self.serving_dtype = self._infer_serving_dtype(
            tree_leaves(self._params))
        self.warmup_report = {}
        self.warmed_buckets = set()
        return self

    def _gen_context(self):
        """inference mode, with this model's CUDA device current."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
        return stack

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup_generative(self, init_kv: Callable, slots: int,
                          max_kv_len: int, prompt_buckets: List[int],
                          kv_buckets: List[int]) -> "InferenceModel":
        """Run the whole decode program ladder once: one prefill per
        prompt bucket, one step per kv bucket, on a warmup-only KV pool
        (the engine allocates its own with identical shapes). Per-program
        seconds land in `warmup_report` (`gen-prefill:p{P}`,
        `gen-step:kv{B}`)."""
        if self._gen_prefill_fn is None:
            raise RuntimeError("load_generative() first")
        prefill, step = self._gen_prefill_fn, self._gen_step_fn
        kv = init_kv(int(slots), int(max_kv_len))
        for P in sorted({int(p) for p in prompt_buckets}):
            t0 = time.perf_counter()
            with self._gen_context():
                prefill(self._params, kv, np.zeros(P, np.int32), 1, 0)
            self._sync()
            self.warmup_report[f"gen-prefill:p{P}"] = round(
                time.perf_counter() - t0, 4)
        for b in sorted({int(b) for b in kv_buckets}):
            if b > max_kv_len:
                raise ValueError(f"kv bucket {b} exceeds max_kv_len "
                                 f"{max_kv_len}")
            zeros = np.zeros(int(slots), np.int32)
            t0 = time.perf_counter()
            with self._gen_context():
                step(self._params, kv, zeros, zeros, kv_bucket=b)
            self._sync()
            self.warmup_report[f"gen-step:kv{b}"] = round(
                time.perf_counter() - t0, 4)
        return self

    def warmup_generative_paged(self, init_kv_blocks: Callable,
                                num_blocks: int, block_len: int,
                                lanes: int, table_len: int,
                                chunk_buckets: List[int],
                                kv_buckets: List[int]) -> "InferenceModel":
        """Run the paged ladder once: one chunked prefill per (chunk bucket
        × context bucket) — the context window is 0 on a fresh first chunk
        and a kv bucket otherwise — and one paged step per kv bucket, on a
        warmup-only block pool with all-zero (scratch) tables."""
        if self._gen_paged_prefill_fn is None:
            raise RuntimeError("load_generative(..., paged_prefill_fn=, "
                               "paged_step_fn=) first")
        prefill, step = self._gen_paged_prefill_fn, self._gen_paged_step_fn
        kv = init_kv_blocks(int(num_blocks), int(block_len))
        ctx_buckets = [0] + sorted({int(b) for b in kv_buckets})
        table = np.zeros(int(table_len), np.int32)
        for Cb in sorted({int(c) for c in chunk_buckets}):
            for kvb in ctx_buckets:
                t0 = time.perf_counter()
                with self._gen_context():
                    prefill(self._params, kv, np.zeros(Cb, np.int32), table,
                            0, 1, kv_bucket=kvb)
                self._sync()
                self.warmup_report[f"gen-paged-prefill:c{Cb}:kv{kvb}"] = \
                    round(time.perf_counter() - t0, 4)
        for b in sorted({int(b) for b in kv_buckets}):
            if b % int(block_len):
                raise ValueError(f"kv bucket {b} not a multiple of "
                                 f"block_len {block_len}")
            zeros = np.zeros(int(lanes), np.int32)
            t0 = time.perf_counter()
            with self._gen_context():
                step(self._params, kv, zeros, zeros,
                     np.zeros((int(lanes), int(table_len)), np.int32),
                     kv_bucket=b)
            self._sync()
            self.warmup_report[f"gen-paged-step:kv{b}"] = round(
                time.perf_counter() - t0, 4)
        return self

    @staticmethod
    def _ids(a) -> np.ndarray:
        """Ids, positions and tables as the programs take them: int32
        arrays (the model moves them onto its device)."""
        return np.ascontiguousarray(a, np.int32)

    def generative_prefill(self, kv, tokens, length, slot):
        """One prompt (padded to a prompt bucket) through the prefill
        program. Returns (kv, logits[vocab]) on the device."""
        with self._gen_context():
            return self._gen_prefill_fn(self._params, kv, self._ids(tokens),
                                        int(length), int(slot))

    def generative_step(self, kv, tokens, positions, kv_bucket: int):
        """One decode step for every slot under the serving bucket.
        Returns (kv, logits[slots, vocab]) on the device."""
        with self._gen_context():
            return self._gen_step_fn(self._params, kv, self._ids(tokens),
                                     self._ids(positions),
                                     kv_bucket=int(kv_bucket))

    def generative_prefill_paged(self, kv, tokens, table, pre_len,
                                 chunk_len, kv_bucket: int):
        """One prompt chunk through the paged prefill for its (chunk
        bucket, context bucket). Returns (kv, logits[vocab])."""
        with self._gen_context():
            return self._gen_paged_prefill_fn(
                self._params, kv, self._ids(tokens), self._ids(table),
                int(pre_len), int(chunk_len), kv_bucket=int(kv_bucket))

    def generative_step_paged(self, kv, tokens, positions, tables,
                              kv_bucket: int):
        """One decode step for every lane through the block tables.
        Returns (kv, logits[lanes, vocab])."""
        with self._gen_context():
            return self._gen_paged_step_fn(
                self._params, kv, self._ids(tokens), self._ids(positions),
                self._ids(tables), kv_bucket=int(kv_bucket))

    def account_generative(self, kind: str, bucket, secs: float):
        """Roofline accounting of one generative call: a no-op until the
        roofline accountant is ported (ROADMAP.md queue 1, item 3)."""
