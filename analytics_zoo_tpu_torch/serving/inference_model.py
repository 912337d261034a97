"""InferenceModel — the concurrent inference façade.

Port of `analytics_zoo_tpu/serving/inference_model.py`:
`NoHealthyReplicaError` (L58), `_next_bucket` (L64), `PendingPrediction`
(L71), `_RoutedPending` (L133, with `_rebind` and `abandon`), `_Replica`
(L257), `_JoinedPending` (L276), `InferenceModel.__init__` (L305-395: the
buckets, the admission semaphore, `num_replicas`, `devices`,
`max_inflight_per_replica`), `load_keras` (L398, with `quantize="int8"`),
`load_zoo_model` (L425), `load_quantized` (L430), `load_checkpoint`
(L442), `_infer_serving_dtype` (L480), `load_fn` (L495), hot swap
(`current_params` L570, `_swap_signature` L580, `swap_params` L597), the
roofline (`_record_cost`, `_harvest_jit_cost` and `_roofline_cb`,
L656-715), the replica pool (`_replica_loop` L802 with the
`replica.dispatch` fault point, `_notify_replica`, `close` L864,
`_acquire_replica` L890, `_release_replica`, `quarantine_replica` L938,
`revive_replica` L994, `healthy_replicas`, `quarantined_replicas`,
`probe_replica_async` / `probe_replica` L1022-1060, `replica_inflight`,
`replica_stats` L1070), `weight_bytes` (L1083), `placement_info` (L1098),
`load_torch` (L1123), `predict` (L1135), `predict_async` (L1140) and
`warmup` (L1231, with the replica fan-out of L1293); the persistent
compile cache (`compile_cache=` L312, `_exec_sig` L717, `_cache_key`
L723, `_aot_call` L749, `_warm_executable` L759-800, `warmup_source`,
`compile_cache_size` L1673); and the generative decode half
(L1353-1671): `load_generative`, `warmup_generative`,
`warmup_generative_paged`, `generative_prefill`, `generative_step`,
`generative_prefill_paged`, `generative_step_paged` and
`account_generative` (L1656), with the `_gen_cost` harvest and the
program table of `_warm_gen` (L1459-1500).

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
  request path, and captures one program per (replica, bucket): on the
  card a CUDA graph (`compile_cache/graphs.py`), on the CPU the same
  static-buffer protocol run eagerly. Where the JAX package dispatches a
  warmed bucket to its AOT executable, the port replays the bucket's
  graph; an unwarmed bucket still serves, eagerly.

Replicas (`num_replicas` above 1, or `"auto"`: one per visible GPU): each
holds its own copy of the weights (`common/modules.copy_module`), its own
worker thread and, on the card, its own `torch.cuda.Stream`. `devices` may
name one card more than once (`["cuda:0", "cuda:0"]`): the replicas then
share the card as streams, where the JAX package's replicas are devices;
as there, a pool never has more replicas than the devices it is given.
The dispatching thread uploads and pads the batch on its current stream
and records an event; the worker makes its stream wait for it, marks the
batch as used there (`record_stream`), runs the forward on its stream (the
kernels launch on the current stream) and records the `ready` event that
`result()` waits for. Routing is least outstanding work with a per-replica
in-flight bound and round-robin ties; quarantine moves a replica's queued
jobs, permits and all, to healthy replicas; probes run a canary batch on a
quarantined replica. A replica that fails surfaces its error in `result()`
and in `_on_replica_event`; nothing carries the batch on the CPU.

Hot swap: `swap_params` of a state with the live structure copies the new
weights into the live module's own tensors — the storage the captured
graphs read — on each replica's stream, ordered after the forwards
already dispatched there, so a batch already dispatched (in a pool,
picked up by its worker) finishes on the old weights and the next reads
the new ones (`"same"`: no warmup, no kernel build, no capture); another
structure (f32 ⇄ int8) reloads through `load_fn` and re-warms, and so
recaptures, the warm buckets (`"restructured"`).

Persistent compile cache (`compile_cache=`, a `compile_cache.CompileCache`):
warmup keys each (replica, bucket) program as the JAX package keys its
executable (`make_key("serving", ...)`, `serving_dtype` an explicit
field) and reports it in `warmup_source` as "warm" (already in this
process's table), "cached" (its capture record was in the store and
nvcc ran 0 times for it: its kernel libraries came from the store or were
loaded already) or "compiled"; without a cache, "uncached". A graph itself
is never persisted.

Roofline: `warmup` counts each bucket's forward once
(`observability.roofline.CostMeter`, the kernels' declared costs and the
int8 GEMMs included) and `result()` charges it against the time from
dispatch to materialize, under `kind="serving"`; an unwarmed model pays
nothing. The generative warmups count each program the same way, and
`account_generative` charges the decode engine's calls with it.

Generative mode runs two program families: a prefill per prompt bucket
(and, paged, per (chunk bucket, context bucket)) and a decode step per kv
bucket. The JAX package compiles one executable per program at warmup so
that the request path compiles nothing. PyTorch runs eagerly; the port's
warmup runs every program once, so the decode-attention kernel library is
built and loaded and cuBLAS is set up before any request: the request path
builds no kernel (`kernels._build.build_events` shows it).

Not ported yet: sharded placement (`placement="sharded"`, ROADMAP.md queue
1, item 7b) and `load_keras_encrypted` (item 8).
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.common.modules import copy_module
from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_map
from analytics_zoo_tpu_torch.compile_cache.graphs import (ProgramTable,
                                                          capture_program)
from analytics_zoo_tpu_torch.compile_cache.key import (abstract_signature,
                                                       make_key,
                                                       model_fingerprint)
from analytics_zoo_tpu_torch.kernels import _build
from analytics_zoo_tpu_torch.observability.roofline import (CostMeter,
                                                            count_cost,
                                                            get_accountant)
from analytics_zoo_tpu_torch.serving.timer import Timer

log = logging.getLogger("analytics_zoo_tpu_torch.serving")

PLACEMENTS = ("replicated", "sharded")


class NoHealthyReplicaError(RuntimeError):
    """Every replica in the pool is quarantined: the router fails fast (no
    60 s permit wait), so callers can park work or answer 503."""


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


def _keras_forward(model, x):
    return model.apply(x, training=False)


def _torch_forward(module, x):
    return module(*x) if isinstance(x, (list, tuple)) else module(x)


def _unflatten(template, leaves):
    """`template`'s tree with `leaves` in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


class _Spec:
    """A leaf's shape and dtype: what a program is keyed on."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


def _bucket_spec(x, bucket: int):
    """The shapes and dtypes of `x` padded to `bucket` rows."""
    return tree_map(lambda a: _Spec((bucket,) + tuple(a.shape[1:]), a.dtype),
                    x)


def _host_rows(out, n: int, ready: Optional[torch.cuda.Event]):
    """The first `n` rows of a device output tree as numpy, once the
    stream that computed it has reached `ready`."""
    if ready is not None:
        ready.synchronize()
    return tree_map(lambda t: _to_numpy(t[:n]), out)


class PendingPrediction:
    """Async handle from `predict_async`: the device computes while the
    caller keeps dispatching; `result()` materializes the output (the one
    blocking copy) and slices off bucket padding. Idempotent and
    thread-safe."""

    def __init__(self, out, valid_n: int, timer: Optional[Timer] = None,
                 dispatch_s: float = 0.0,
                 ready: Optional[torch.cuda.Event] = None,
                 replica: int = 0,
                 roofline_cb: Optional[Callable[[float], None]] = None):
        self._out = out
        self._n = valid_n
        self._timer = timer
        self._dispatch_s = dispatch_s
        self._ready = ready
        self.replica = replica        # which model replica computed this
        self._roofline_cb = roofline_cb
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
                self._result = _host_rows(self._out, self._n, self._ready)
                self._out = None            # free device memory promptly
                self._done = True
                # model time = dispatch + materialize wait
                busy_s = self._dispatch_s + time.perf_counter() - t0
                if self._timer is not None:
                    self._timer.record(busy_s)
                if self._roofline_cb is not None:
                    self._roofline_cb(busy_s)
        return self._result


class _RoutedPending:
    """PendingPrediction fulfilled by a replica worker thread:
    `predict_async` returns it before the batch has reached the device;
    the worker attaches the device output (or the dispatch failure, which
    `result()` re-raises)."""

    def __init__(self, valid_n: int, timer: Optional[Timer] = None,
                 replica: int = 0,
                 on_done: Optional[Callable[[], None]] = None,
                 roofline_cb: Optional[Callable[[float], None]] = None):
        self._n = valid_n
        self._timer = timer
        self.replica = replica
        self._on_done = on_done
        self._roofline_cb = roofline_cb
        self._event = threading.Event()
        self._out = None
        self._ready: Optional[torch.cuda.Event] = None
        self._exc: Optional[BaseException] = None
        self._dispatch_s = 0.0
        self.busy_s = 0.0              # dispatch + materialize, once done
        self._result = None
        self._done = False
        self._lock = threading.Lock()

    # -- worker side -------------------------------------------------------
    def _fulfill(self, out, dispatch_s: float,
                 ready: Optional[torch.cuda.Event] = None):
        self._out = out
        self._ready = ready
        self._dispatch_s = dispatch_s
        self._event.set()

    def _fail(self, exc: BaseException):
        self._exc = exc
        self._event.set()

    # -- consumer side -----------------------------------------------------
    def done(self) -> bool:
        """Never blocks: False until the worker has dispatched, then the
        device's readiness."""
        if self._done:
            return True
        if not self._event.is_set():
            return False
        if self._exc is not None:
            return True
        ready = self._ready
        return ready is None or ready.query()

    def result(self):
        with self._lock:
            if not self._done:
                # the worker sets the event on every exit path, and
                # abandon() and quarantine's failure path set it too
                self._event.wait()  # blocking-ok: always signalled
                try:
                    if self._exc is None:
                        t0 = time.perf_counter()
                        self._result = _host_rows(self._out, self._n,
                                                  self._ready)
                        self._out = None
                        self.busy_s = self._dispatch_s \
                            + time.perf_counter() - t0
                        if self._timer is not None:
                            self._timer.record(self.busy_s)
                        if self._roofline_cb is not None:
                            self._roofline_cb(self.busy_s)
                except Exception as e:  # noqa: BLE001 — kept for re-raise
                    self._exc = e
                finally:
                    # the replica permit releases exactly once, success or
                    # failure: a leak would wedge the router
                    self._done = True
                    cb, self._on_done = self._on_done, None
                    if cb is not None:
                        cb()
            if self._exc is not None:
                raise self._exc
        return self._result

    def _rebind(self, replica: int, on_done) -> bool:
        """Quarantine re-dispatch: point this pending at a new replica (and
        its permit-release callback) before it is re-queued there. Refused
        once the pending is done, and when its lock is held (a consumer
        waits in `result()`, which takes the router's lock to release a
        permit: blocking here would invert the lock order); the caller
        then fails it instead."""
        if not self._lock.acquire(blocking=False):
            return False
        try:
            if self._done:
                return False
            self.replica = replica
            self._on_done = on_done
            return True
        finally:
            self._lock.release()

    def abandon(self):
        """Release the replica permit without materializing (the
        shutdown-drop path of the serving plane)."""
        with self._lock:
            if not self._done:
                self._done = True
                self._out = None
                cb, self._on_done = self._on_done, None
                if cb is not None:
                    cb()


class _Replica:
    """One slot of the replicated pool: its module on its device, its
    stream (on the card), its work queue and the router's book-keeping.
    `inflight` / `batches` / `quarantined` are guarded by the model's
    router condition variable."""

    __slots__ = ("index", "device", "params", "stream", "inflight",
                 "batches", "work_q", "thread", "quarantined", "lock")

    def __init__(self, index: int, device: torch.device, params: nn.Module,
                 stream: Optional[torch.cuda.Stream]):
        self.index = index
        self.device = device
        self.params = params
        self.stream = stream
        self.inflight = 0          # routed but not yet materialized
        self.batches = 0           # total batches ever routed here
        self.quarantined = False   # supervisor pulled it from the router
        self.work_q: "queue.Queue" = queue.Queue()
        self.thread: Optional[threading.Thread] = None
        # held while a forward is dispatched and while a swap writes the
        # weights: a batch reads one version of them
        self.lock = threading.Lock()


class _JoinedPending:
    """PendingPrediction over max_batch chunks: each chunk was dispatched
    independently; result() syncs them in order and concatenates."""

    replica = None                 # spans replicas; no single owner

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
                 max_batch: int = 512, device: DeviceLike = None,
                 num_replicas=1, devices: Optional[List] = None,
                 max_inflight_per_replica: int = 2,
                 placement: str = "replicated", compile_cache=None):
        """`device`: where the model serves; `None` is `cuda`, and asking
        for `cuda` without a GPU raises. `concurrent_num` permits bound the
        predict calls dispatching at once (`auto_scaling` grows them on
        contention).

        `num_replicas`: model copies; 1 (the default) is the single-device
        path, with no pool and no threads; `"auto"` / -1 / 0 / None takes
        one per device of `devices`, by default one per visible GPU.
        `devices` names the replicas' devices (a card may repeat: its
        replicas run on streams of their own); replica i takes
        `devices[i]`. `max_inflight_per_replica` bounds routed but
        unmaterialized batches per replica: the router's backpressure.

        `compile_cache`: a `compile_cache.CompileCache` — warmup then keys
        every (replica, bucket) program there: its capture record and the
        kernel libraries its warmup loads are read from it (no nvcc on a
        warm restart) or written to it."""
        if placement not in PLACEMENTS:
            raise ValueError(f"placement={placement!r} not in {PLACEMENTS}")
        if placement == "sharded":
            raise NotImplementedError(
                "placement='sharded' is not ported yet (ROADMAP.md queue 1, "
                "item 7b)")
        if devices is not None:
            devs = [resolve_device(d) for d in devices]
            if not devs:
                raise ValueError("no devices available")
        else:
            dev = resolve_device(device)
            devs = [dev]
            if num_replicas != 1 and dev.type == "cuda":
                devs = [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
        if num_replicas in (None, 0, -1, "auto"):
            n = len(devs)
        else:
            n = int(num_replicas)
        if n < 1:
            raise ValueError(f"num_replicas={num_replicas!r} must be >= 1 "
                             "(or 'auto'/-1 for one per device)")
        if n > len(devs):
            raise ValueError(
                f"num_replicas={n} exceeds the {len(devs)} available "
                "device(s); lower it or pass more devices")
        self.num_replicas = n
        self.devices = devs[:n]
        self.device = self.devices[0]
        self.placement = placement
        self.max_inflight_per_replica = max(1, int(max_inflight_per_replica))
        self.concurrent_num = concurrent_num
        self.auto_scaling = auto_scaling
        self._sema = threading.BoundedSemaphore(concurrent_num) \
            if not auto_scaling else threading.Semaphore(concurrent_num)
        self._fn: Optional[Callable] = None
        self._params = None
        self._replicas: Optional[List[_Replica]] = None
        # an RLock inside: predict_async routes and enqueues under it,
        # re-entering through _acquire_replica
        self._replica_cv = threading.Condition()
        self._rr = 0               # round-robin tie-break cursor
        # supervision hooks: the outcome stream and the canary batches
        # probes reuse
        self._on_replica_event: Optional[Callable[[int, bool, float],
                                                  None]] = None
        self._last_input = None        # most recent dispatched batch
        self._last_good_input = None   # most recent successful batch
        self.max_batch = max_batch
        self.buckets = [b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
                        if b <= max_batch] or [max_batch]
        self.timer = Timer("predict")
        self.warmup_report: Dict[str, float] = {}
        self.warmup_source: Dict[str, str] = {}
        self.warmed_buckets: set = set()
        self.compile_cache = compile_cache
        # the program table, (replica, input signature) -> GraphProgram,
        # filled by warmup; replica 0 is the single-device model, which
        # replays on a stream of its own (`_stream0`) under `_lock0`
        self._programs = ProgramTable()
        self._model_fp: Optional[str] = None
        self._stream0: Optional[torch.cuda.Stream] = None
        self._lock0 = threading.Lock()
        self._gen_kv = None
        self._gen_kv_blocks = None
        # who serves from each warmed pool (a weak reference; by `paged`)
        # and the generative calls that ran eagerly on another pool
        self._kv_owner: Dict[bool, Any] = {False: None, True: None}
        self._kv_lock = threading.Lock()
        self.gen_eager_calls: Dict[str, int] = {}
        # the record the last warmup() ran with: what a restructuring
        # swap_params re-warms
        self._warmup_sample = None
        self.serving_dtype: str = "float32"
        # roofline: per-bucket counted cost, charged per materialized
        # batch; empty until warmup runs
        self._exec_cost: Dict[tuple, Any] = {}
        self._gen_cost: Dict[tuple, Any] = {}
        self._roofline = None
        self._gen_prefill_fn: Optional[Callable] = None
        self._gen_step_fn: Optional[Callable] = None
        self._gen_paged_prefill_fn: Optional[Callable] = None
        self._gen_paged_step_fn: Optional[Callable] = None

    # -- loaders ---------------------------------------------------------
    def load_keras(self, model, params=None,
                   quantize: Optional[str] = None) -> "InferenceModel":
        """A port Keras-style model (a built `KerasNet`, nested models
        included, or a `ZooModel`, served through its `model`). `params`, a
        state dict, is loaded into it first; an int8 state (a quantized
        model's) is served on a structural copy of it. `quantize="int8"`
        serves the int8 twin (`serving/quantization.quantize_model_params`).
        The model serves a copy of `model` (`load_fn`): `model` stays where
        it is."""
        from analytics_zoo_tpu_torch.models.common import ZooModel
        from analytics_zoo_tpu_torch.serving import quantization
        if isinstance(model, ZooModel):
            model = model.model
        if quantize is not None and quantize != "int8":
            raise ValueError(
                f"Unsupported quantize={quantize!r}; only 'int8'")
        if params is not None:
            if set(params) != set(model.state_dict()):
                model = quantization.with_layout(model, params)
            else:
                model.load_state_dict(params)
        if not model.built:
            raise ValueError("Model has no parameters; fit or load first")
        if quantize is not None:
            model = quantization.quantize_model_params(model)
        return self.load_fn(_keras_forward, model)

    def load_zoo_model(self, cls, path: str,
                       quantize: Optional[str] = None) -> "InferenceModel":
        """`doLoadBigDL` analogue: a `ZooModel` directory saved by either
        package (`cls.load_model`), built on this InferenceModel's
        device."""
        return self.load_keras(cls.load_model(path, device=self.device),
                               quantize=quantize)

    def load_quantized(self, model, path: str) -> "InferenceModel":
        """A pre-quantized int8 artifact (`quantization.save_quantized`, of
        either package) on `model`'s architecture: no f32 weights needed
        at serve time."""
        from analytics_zoo_tpu_torch.serving.quantization import \
            load_quantized
        return self.load_fn(_keras_forward, load_quantized(model, path))

    def load_checkpoint(self, model, path: str,
                        version: Optional[int] = None,
                        quantize: Optional[str] = None
                        ) -> "InferenceModel":
        """Serve a training checkpoint (`learn/checkpoint.py`, written by
        either package) on `model`'s architecture. `quantize="int8"`
        prefers the checkpoint's intact int8 sidecar
        (`fit_keras(int8_sidecar=True)`) and falls back to quantize-at-load
        when there is none (a torn sidecar costs a calibration, never the
        serve)."""
        from analytics_zoo_tpu_torch import convert
        from analytics_zoo_tpu_torch.learn import checkpoint as ckpt_mod
        from analytics_zoo_tpu_torch.serving import quantization
        net = quantization._net(model)
        if quantize is not None:
            if quantize != "int8":
                raise ValueError(
                    f"Unsupported quantize={quantize!r}; only 'int8'")
            # one resolution, reused by the fallback
            found = ckpt_mod.resolve_checkpoint(path, version)
            q = quantization.load_int8_sidecar(*found)
            if q is not None:
                return self.load_fn(_keras_forward, quantization.with_layout(
                    net, convert.state_from_jax(net._remap_loaded(q), net)))
            path, version = found
        params, _, _ = ckpt_mod.load_checkpoint(path, version)
        return self.load_keras(
            net, params=convert.state_from_jax(net._remap_loaded(params),
                                               net),
            quantize=quantize)

    def load_torch(self, torch_module: nn.Module) -> "InferenceModel":
        """`doLoadPyTorch` analogue: the module is served as it is (the JAX
        package converts it to a native model first); a list or tuple
        input is passed as its positional arguments."""
        return self.load_fn(_torch_forward, torch_module)

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
        weights. The model serves a copy of it in eval mode, its own (one
        on the device; in a pool, one per replica on the replica's device
        and stream): `params` itself is left as it is, and a `"same"` swap,
        which writes into the served tensors, never reaches it."""
        self.close()               # reload: retire any old replica pool
        self._fn = fn
        self.serving_dtype = self._infer_serving_dtype(
            params.state_dict().values())
        self._programs.clear()
        self._model_fp = None
        if self.compile_cache is not None:
            # fingerprint before placement: the key must be the same in
            # every process
            self._model_fp = model_fingerprint(fn, params)
        if self.num_replicas > 1:
            self._params = None
            reps = []
            for i, dev in enumerate(self.devices):
                stream = torch.cuda.Stream(dev) if dev.type == "cuda" \
                    else None
                rep = _Replica(i, dev, self._place(params, dev, stream),
                               stream)
                rep.thread = threading.Thread(
                    target=self._replica_loop, args=(rep,),
                    name=f"infer-replica-{i}", daemon=True)
                rep.thread.start()
                reps.append(rep)
            self._replicas = reps
        else:
            self._params = self._place(params, self.device, None)
            if self.device.type == "cuda" and self._stream0 is None:
                self._stream0 = torch.cuda.Stream(self.device)
        self.warmup_report = {}
        self.warmup_source = {}
        self.warmed_buckets = set()
        self._warmup_sample = None
        self._reset_roofline()
        return self

    def _reset_roofline(self) -> None:
        """A fresh model, a fresh roofline: the serving gauges describe the
        model now loaded."""
        self._exec_cost = {}
        self._gen_cost = {}
        self._roofline = get_accountant()
        self._roofline.reset("serving")

    @staticmethod
    @torch.no_grad()
    def _place(module: nn.Module, device: torch.device,
               stream: Optional[torch.cuda.Stream],
               state=None) -> nn.Module:
        """A copy of `module` on `device` holding `state`'s values (default:
        its own) in its own dtypes and layouts, allocated on `stream` (so
        that the memory returns to that stream's pool when it is
        dropped)."""
        src = module.state_dict() if state is None else state

        def make(key, t):
            v = src[key]
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.asarray(v))
            return torch.empty_like(t, device=device).copy_(v)

        if stream is None:
            return copy_module(module, make).eval()
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.device(device), torch.cuda.stream(stream):
            out = copy_module(module, make).eval()
        stream.synchronize()
        return out

    # -- hot swap ----------------------------------------------------------
    def current_params(self):
        """The served module, the model's own copy (replica 0's in a pool;
        None until a model loads). A `"same"` swap writes into its tensors,
        so a rollout that may roll back snapshots a copy of its state
        first."""
        if self._replicas:
            return self._replicas[0].params
        return self._params

    @staticmethod
    def _swap_signature(state) -> tuple:
        """Keys with their shapes and canonical dtypes (float64 serves as
        float32), the structure test of a swap."""
        def leaf(v):
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.asarray(v))
            dtype = torch.float32 if t.dtype == torch.float64 else t.dtype
            return tuple(t.shape), str(dtype)
        return tuple(sorted((k,) + leaf(v) for k, v in state.items()))

    def swap_params(self, params) -> str:
        """Replace the served weights without reloading the model: the
        engine-side primitive of a versioned rollout. `params` is a state
        dict (or a module, for its state dict). Returns:

        - ``"same"``: the structure, shapes and dtypes are the live ones.
          The new values are copied into each replica's live tensors (the
          storage its captured graphs read), on its stream, after the
          forwards already dispatched there and before the next: a batch
          already dispatched (in a pool: picked up by its replica's
          worker) finishes on the old weights, the next reads the new
          ones. No warmup, no capture and no kernel build.
        - ``"restructured"``: the structure changed (int8 ⇄ f32, a dtype,
          a layer): the model reloads through `load_fn` on a structural
          copy of the live module and re-warms the buckets that were warm.

        Callers that want a version boundary with no mixed batches drain
        dispatch first."""
        if self._fn is None:
            raise RuntimeError("No model loaded; load_* before swapping")
        from analytics_zoo_tpu_torch.serving.quantization import with_layout
        state = params.state_dict() if isinstance(params, nn.Module) \
            else dict(params)
        live = self.current_params()
        new_sig = self._swap_signature(state)
        live_sig = self._swap_signature(live.state_dict())
        if new_sig != live_sig:
            log.info("swap_params: structure changed; reload + re-warmup")
            sample, buckets = self._warmup_sample, sorted(
                self.warmed_buckets)
            self.load_fn(self._fn, with_layout(live, state))
            if sample is not None:
                self.warmup(sample, buckets=buckets or None)
            return "restructured"
        if self._replicas is not None:
            with self._replica_cv:
                reps = self._replicas
                if reps is None:
                    raise RuntimeError(
                        "replica pool closed mid-swap; reload the model")
            for rep in reps:
                with rep.lock:
                    self._write_state(rep.params, state, rep.device,
                                      rep.stream)
        else:
            with self._lock0:
                self._write_state(self._params, state, self.device, None)
        return "same"

    @staticmethod
    def _write_state(module: nn.Module, state, device: torch.device,
                     stream: Optional[torch.cuda.Stream]) -> None:
        """Copy `state`'s values into `module`'s own tensors, and refresh
        the padded int8 GEMM operands built from them. On a replica's
        stream the copies queue behind its forwards; the single-device
        model's forwards run on other streams, so the card is
        synchronized before and after."""
        from analytics_zoo_tpu_torch.serving.quantization import \
            refresh_int8_operands
        live = module.state_dict(keep_vars=True)
        cuda = device.type == "cuda"
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.inference_mode())
        if cuda:
            ctx.enter_context(torch.cuda.device(device))
            if stream is not None:
                ctx.enter_context(torch.cuda.stream(stream))
            else:
                torch.cuda.synchronize(device)
        with ctx:
            for k, t in live.items():
                v = state[k]
                t.copy_(v if isinstance(v, torch.Tensor)
                        else torch.from_numpy(np.asarray(v)))
            refresh_int8_operands(live.values())
        if cuda and stream is None:
            torch.cuda.synchronize(device)

    # -- roofline accounting (observability/roofline.py) -------------------
    @staticmethod
    def _cost_key(x) -> tuple:
        """Per-batch cost-table key: the padded batch's leaf shapes and
        dtypes (the weights are fixed per model)."""
        return tuple((tuple(a.shape), str(a.dtype)) for a in tree_leaves(x))

    def _record_cost(self, batch, cost) -> None:
        if cost is not None and (cost.flops > 0 or cost.bytes > 0):
            self._exec_cost.setdefault(self._cost_key(batch), cost)

    def _counted_forward(self, params, x):
        """`(output, ExecCost)` of one forward. Under `no_grad`, not
        `inference_mode`: in inference mode composite operators (`matmul`,
        `linear`, `einsum`) reach the meter undecomposed, without a FLOP
        formula."""
        with torch.no_grad():
            return count_cost(self._fn, params, x)

    def _harvest_cost(self, params, batch) -> None:
        """Count one forward of `batch` (run for real) unless its shape is
        counted already. Telemetry only: a failure is logged."""
        if self._cost_key(batch) in self._exec_cost:
            return
        try:
            _, cost = self._counted_forward(params, batch)
        except Exception as e:  # noqa: BLE001 — telemetry only
            log.debug("serving cost harvest failed: %s: %s",
                      type(e).__name__, e)
            return
        self._record_cost(batch, cost)

    def _roofline_cb(self, x):
        """The per-batch accounting callback for a pending, or None when
        this batch shape has no counted cost (no warmup ran)."""
        if not self._exec_cost or self._roofline is None:
            return None
        cost = self._exec_cost.get(self._cost_key(x))
        if cost is None:
            return None
        acct = self._roofline
        return lambda secs, _c=cost, _a=acct: _a.account(
            "serving", _c.flops, _c.bytes, secs, n_devices=1,
            int8_flops=_c.int8_flops)

    # -- the replica pool ---------------------------------------------------
    def _forward_on(self, params, x):
        with torch.inference_mode():
            return self._fn(params, x)

    def _program(self, replica: int, spec):
        """The warmed program of (`replica`, `spec`'s signature), or
        None."""
        if not len(self._programs):
            return None
        return self._programs.get((replica, abstract_signature(spec)))

    def _run_on_replica(self, rep: _Replica, x, uploaded):
        """One forward on the replica's module, on its stream when it has
        one — the bucket's program when warmup made one, else eagerly:
        `(output, ready event or None)`."""
        program = self._program(rep.index, x)
        with rep.lock:
            params = rep.params
            if rep.stream is None:
                x = tree_map(lambda a: a.to(rep.device), x)
                if program is not None:
                    return program(*tree_leaves(x)), None
                return self._forward_on(params, x), None
            stream = rep.stream
            with torch.cuda.device(rep.device), torch.cuda.stream(stream):
                if uploaded is not None:
                    stream.wait_event(uploaded)
                else:              # a probe's or a moved job's batch
                    stream.wait_stream(torch.cuda.current_stream(rep.device))

                def on_stream(a):
                    a = a.to(rep.device, non_blocking=True)
                    a.record_stream(stream)
                    return a

                xd = tree_map(on_stream, x)
                if program is not None:
                    out = program(*tree_leaves(xd))
                else:
                    out = self._forward_on(params, xd)
                ready = torch.cuda.Event()
                ready.record(stream)
            return out, ready

    def _replica_loop(self, rep: _Replica):
        """Per-replica dispatcher. `t0` is the router hand-off time, so
        `dispatch_s` covers queue wait + dispatch (+ compute, on the CPU).
        Every job's outcome and latency reports through
        `_on_replica_event` unless the replica is quarantined. The
        `replica.dispatch` fault point sits where a device fault would
        land."""
        while True:
            try:
                job = rep.work_q.get(timeout=1.0)
            except queue.Empty:
                continue
            if job is None:
                return
            x, pending, t0, uploaded = job
            t_start = time.perf_counter() if t0 is None else t0
            # the canary the supervisor probes quarantined replicas with
            self._last_input = x
            try:
                faults.fire("replica.dispatch", replica=rep.index,
                            batch=rep.batches)
                out, ready = self._run_on_replica(rep, x, uploaded)
                # the preferred canary: an input a replica handled; a
                # poison batch must not become the only probe
                self._last_good_input = x
                dt = time.perf_counter() - t_start
                pending._fulfill(out, dt, ready)
                self._notify_replica(rep, True, dt)
            except Exception as e:  # noqa: BLE001 — surfaces in result()
                pending._fail(e)
                self._notify_replica(rep, False,
                                     time.perf_counter() - t_start)

    def _notify_replica(self, rep: _Replica, ok: bool, latency_s: float):
        cb = self._on_replica_event
        if cb is None or rep.quarantined:
            return
        try:
            cb(rep.index, ok, latency_s)
        except Exception:  # noqa: BLE001 — supervision must never take
            pass           # down the dispatch path it watches

    def close(self):
        """Retire the replica pool's worker threads (no-op otherwise).
        Safe to call repeatedly; `load_fn` calls it on reload. After close
        a pool model needs a fresh `load_*` to predict again."""
        with self._replica_cv:
            # swapped out under the router CV: a concurrent predict_async
            # either enqueued before this point (FIFO: its job runs before
            # the pill) or sees the closed pool
            reps, self._replicas = self._replicas, None
            self._replica_cv.notify_all()
        if reps:
            for rep in reps:
                rep.work_q.put_nowait(None)
            for rep in reps:
                if rep.thread is not None:
                    rep.thread.join(timeout=5)
            # the replicas' graphs and their pools go with them
            self._programs.clear()
            if self._params is None:
                self._fn = None

    def _acquire_replica(self, timeout: float = 60.0) -> _Replica:
        """Least-outstanding-work selection with a per-replica in-flight
        bound; round-robin tie-break so equally idle replicas alternate.
        Blocks (bounded) when every replica is at the bound."""
        deadline = time.monotonic() + timeout
        with self._replica_cv:
            while True:
                reps = self._replicas
                if reps is None:
                    raise RuntimeError(
                        "replica pool closed while routing; stop the "
                        "serving engine before close()/load_fn()")
                healthy = [r for r in reps if not r.quarantined]
                if not healthy:
                    raise NoHealthyReplicaError(
                        f"all {len(reps)} replicas are quarantined; "
                        "waiting on canary revival")
                free = [r for r in healthy
                        if r.inflight < self.max_inflight_per_replica]
                if free:
                    lo = min(r.inflight for r in free)
                    n = len(reps)
                    rep = min((r for r in free if r.inflight == lo),
                              key=lambda r: (r.index - self._rr) % n)
                    self._rr = (rep.index + 1) % n
                    rep.inflight += 1
                    rep.batches += 1
                    return rep
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._replica_cv.wait(remaining):
                    raise TimeoutError(
                        "every model replica is at its in-flight bound "
                        f"({self.max_inflight_per_replica}); results are "
                        "not being materialized")

    def _release_replica(self, rep: _Replica):
        with self._replica_cv:
            rep.inflight -= 1
            self._replica_cv.notify()

    def quarantine_replica(self, index: int) -> bool:
        """Pull one replica out of the routing set: every job still queued
        on it re-dispatches to the least-loaded healthy replica with its
        in-flight permit; the job its worker runs finishes normally.
        Idempotent; True when this call made the transition."""
        with self._replica_cv:
            reps = self._replicas
            if reps is None or index >= len(reps):
                return False
            rep = reps[index]
            if rep.quarantined:
                return False
            rep.quarantined = True
            healthy = [r for r in reps if not r.quarantined]
            moved = []
            while True:
                try:
                    job = rep.work_q.get_nowait()
                except queue.Empty:
                    break
                if job is None:
                    # close()'s pill: the worker must still see it
                    rep.work_q.put_nowait(job)
                    break
                moved.append(job)
            for x, pending, _, uploaded in moved:
                target = min(healthy, key=lambda r: r.inflight) \
                    if healthy else None
                if target is not None and pending._rebind(
                        target.index,
                        lambda _r=target: self._release_replica(_r)):
                    # permit transfer: the quarantined slot frees now, the
                    # target's through the rebound callback
                    rep.inflight -= 1
                    target.inflight += 1
                    target.batches += 1
                    # t0 resets: the detour must not read as the target's
                    # latency
                    target.work_q.put_nowait(
                        (x, pending, time.perf_counter(), uploaded))
                else:
                    # no healthy peer (or the pending finished): fail it;
                    # the old permit releases through its callback
                    pending._fail(NoHealthyReplicaError(
                        "replica quarantined with no healthy peer to "
                        "re-dispatch to"))
            self._replica_cv.notify_all()
            return True

    def revive_replica(self, index: int) -> bool:
        """Return a quarantined replica to the routing set (after a
        successful canary probe)."""
        with self._replica_cv:
            reps = self._replicas
            if reps is None or index >= len(reps) \
                    or not reps[index].quarantined:
                return False
            reps[index].quarantined = False
            self._replica_cv.notify_all()
            return True

    def healthy_replicas(self) -> int:
        """Replicas accepting routed work (the whole model on the
        single-device path)."""
        reps = self._replicas
        if reps is None:
            return self.num_replicas
        with self._replica_cv:
            return sum(1 for r in reps if not r.quarantined)

    def quarantined_replicas(self) -> List[int]:
        reps = self._replicas
        if reps is None:
            return []
        with self._replica_cv:
            return [r.index for r in reps if r.quarantined]

    def probe_replica_async(self, index: int, x=None):
        """Enqueue a canary batch on replica `index`'s worker (bypassing the
        router: a quarantined replica still drains its queue) and return
        the `_RoutedPending` without waiting, or None when there is nothing
        to probe with. `x` defaults to the most recent batch a replica
        handled successfully, else the most recent dispatched one."""
        reps = self._replicas
        if reps is None or index >= len(reps):
            return None
        if x is not None:
            x = tree_map(_as_host_tensor, x)
        else:
            x = self._last_good_input if self._last_good_input is not None \
                else self._last_input
        if x is None:
            return None
        leaves = tree_leaves(x)
        n = leaves[0].shape[0] if leaves and leaves[0].dim() > 0 else 1
        pending = _RoutedPending(n, timer=None, replica=index)
        reps[index].work_q.put_nowait((x, pending, None, None))
        return pending

    def probe_replica(self, index: int, x=None,
                      timeout_s: float = 10.0) -> bool:
        """Blocking canary probe: True iff the forward completes within the
        budget (the revival signal)."""
        pending = self.probe_replica_async(index, x)
        if pending is None:
            return False
        if not pending._event.wait(timeout_s):
            return False
        try:
            pending.result()
        except Exception:  # noqa: BLE001 — a failing probe is the signal
            return False
        return True

    def replica_inflight(self, index: int) -> int:
        """Routed but unmaterialized batches on one replica (0 on the
        single-device path)."""
        reps = self._replicas
        if reps is None or index >= len(reps):
            return 0
        return reps[index].inflight

    def replica_stats(self) -> List[Dict[str, Any]]:
        """Per-replica routing book-keeping for metrics."""
        if self._replicas is None:
            return [{"replica": 0, "device": str(self.device),
                     "batches": None, "inflight": 0}]
        with self._replica_cv:
            return [{"replica": r.index, "device": str(r.device),
                     "batches": r.batches, "inflight": r.inflight,
                     "quarantined": r.quarantined}
                    for r in self._replicas]

    def weight_bytes(self) -> int:
        """Bytes of the loaded weights, one copy's worth (0 until a model
        loads), with the padded int8 GEMM operands built at first use:
        int8 weights read ~4x under their f32 source."""
        params = self.current_params()
        if params is None:
            return 0
        tensors = list(params.state_dict(keep_vars=True).values()
                       if isinstance(params, nn.Module)
                       else tree_leaves(params))
        tensors += [t._int8_operand[1] for t in tensors
                    if getattr(t, "_int8_operand", None) is not None]
        return sum(t.numel() * t.element_size() for t in tensors)

    def placement_info(self) -> Dict[str, Any]:
        """Placement summary for the serving plane's metrics."""
        return {"placement": self.placement,
                "num_replicas": self.num_replicas,
                "n_devices": len(self.devices),
                "serving_dtype": self.serving_dtype}

    # -- predict ---------------------------------------------------------
    def predict(self, x) -> np.ndarray:
        """Sync predict: dispatch + materialize."""
        return self.predict_async(x).result()

    @staticmethod
    def _upload(x, device: torch.device, n: int, bucket: int):
        """The raw batch on `device` (uploaded once, on the current stream),
        padded to `bucket` by repeating its last row; with the event that
        marks the upload's end on the card."""
        x = tree_map(lambda a: a.to(device, non_blocking=True), x)
        if n != bucket:
            pad = bucket - n
            x = tree_map(lambda a: torch.cat(
                [a, a[-1:].expand((pad,) + tuple(a.shape[1:]))]), x)
        uploaded = None
        if device.type == "cuda":
            uploaded = torch.cuda.Event()
            uploaded.record(torch.cuda.current_stream(device))
        return x, uploaded

    def predict_async(self, x, valid_n: Optional[int] = None):
        """Dispatch without syncing: upload the raw batch once, pad it to
        its bucket on the device by repeating the last row, queue the
        forward (or route it to a replica) and return a pending.
        `valid_n` marks how many leading records are real when the caller
        already padded."""
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
            if self._replicas is not None:
                # route, upload and enqueue under the router CV: close()
                # swaps the pool out under it, so a job never lands behind
                # a worker's stop pill
                with self._replica_cv:
                    rep = self._acquire_replica()
                    try:
                        xd, uploaded = self._upload(x, rep.device, n,
                                                    bucket)
                    except BaseException:
                        rep.inflight -= 1
                        self._replica_cv.notify()
                        raise
                    pending = _RoutedPending(
                        valid_n, timer=self.timer, replica=rep.index,
                        on_done=lambda rep=rep: self._release_replica(rep),
                        roofline_cb=self._roofline_cb(xd))
                    rep.work_q.put_nowait((xd, pending, t0, uploaded))
                return pending
            params = self._params
            if params is None:
                raise RuntimeError(
                    "model closed mid-predict; reload before predicting")
            spec = _bucket_spec(x, bucket)
            program = self._program(0, spec)
            with self._lock0:
                if program is not None:
                    # the raw batch goes straight into the program's
                    # static input, padded there on the device
                    out = program(*tree_leaves(x))
                else:
                    xd, _ = self._upload(x, self.device, n, bucket)
                    out = self._forward_on(params, xd)
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
                                 ready=ready,
                                 roofline_cb=self._roofline_cb(spec))

    # -- warmup ----------------------------------------------------------
    @staticmethod
    def _sample_batch(sample, b: int, device: torch.device):
        return tree_map(lambda a: _as_host_tensor(np.broadcast_to(
            a[None], (b,) + a.shape)).to(device), sample)

    def warmup(self, sample, buckets: Optional[List[int]] = None
               ) -> "InferenceModel":
        """Run every shape bucket once at load time, counting each
        bucket's cost for the roofline, and capture its program (a CUDA
        graph on the card), largest bucket first. `sample` is ONE record
        (no batch dim), or a list/dict of records for multi-input models.
        Per-bucket seconds land in `warmup_report`, keyed
        `"{record shape}:b{bucket}"` (`"r{i}:..."` per replica of a pool),
        and where each program came from in `warmup_source` under the same
        keys; warmed buckets in `warmed_buckets`. Warmup bypasses
        `predict`, so the serving Timer stays clean."""
        if self._fn is None:
            raise RuntimeError("No model loaded")
        buckets = list(buckets) if buckets is not None else list(self.buckets)
        sample = tree_map(np.asarray, sample)
        self._warmup_sample = sample
        tag = "x".join(map(str, tree_leaves(sample)[0].shape)) or "scalar"
        with self._library_cache():
            if self._replicas is not None:
                return self._warmup_replicas(sample, buckets, tag)
            return self._warmup_single(sample, buckets, tag)

    def _library_cache(self):
        """The kernel libraries a warmup loads come from (and go to) the
        compile cache, whichever call loads them first."""
        if self.compile_cache is None:
            return contextlib.nullcontext()
        return _build.library_cache(self.compile_cache)

    def _warmup_single(self, sample, buckets, tag) -> "InferenceModel":
        # the largest bucket first: the smaller captures reuse its pool
        for b in sorted(buckets, reverse=True):
            batch = self._sample_batch(sample, b, self.device)
            t0 = time.perf_counter()
            since = _build.build_events()["compiles"]
            _, cost = self._counted_forward(self._params, batch)
            src = self._warm_program(0, self._params, batch, self._stream0,
                                     since)
            self._sync()
            rkey = f"{tag}:b{b}"
            self.warmup_report[rkey] = round(time.perf_counter() - t0, 4)
            self.warmup_source[rkey] = src
            self.warmed_buckets.add(b)
            self._record_cost(batch, cost)
        return self

    def _cache_key(self, sig):
        """The persistent key of a serving program (JAX `_cache_key`
        L723): `serving_dtype` an explicit field, absent for float32."""
        return make_key("serving", self._model_fp or "", sig,
                        placement=self.placement,
                        dtype=self.serving_dtype
                        if self.serving_dtype != "float32" else "",
                        device=self.device)

    def _warm_program(self, replica: int, params, batch, stream,
                      compiles_since: int) -> str:
        """Capture the program of one (replica, bucket) (JAX
        `_warm_executable` L759): "warm" when this process holds it, else
        what `capture_program` reports, counting the kernel builds since
        `compiles_since`."""
        sig = abstract_signature(batch)
        if self._programs.get((replica, sig)) is not None:
            return "warm"
        leaves = tree_leaves(batch)
        bucket = leaves[0].shape[0] if leaves[0].dim() else 1
        program, src = capture_program(
            f"predict r{replica} b{bucket}",
            lambda *xs: self._forward_on(params, _unflatten(batch, xs)),
            leaves, leaves[0].device, stream, self._programs.pool(stream),
            self.compile_cache,
            self._cache_key(sig) if self.compile_cache is not None
            else None, compiles_since)
        self._programs.put((replica, sig), program)
        return src

    def _warmup_replicas(self, sample, buckets, tag) -> "InferenceModel":
        """Fan warmup out across the pool: every replica's worker runs its
        own (replica, bucket) jobs concurrently. Jobs bypass the router and
        carry no timer. Then one count per bucket on the calling thread
        (every replica runs the same program), when nothing else runs: a
        kernel's declared cost reaches every active counter."""
        since = _build.build_events()["compiles"]
        jobs = []
        for b in buckets:
            for rep in self._replicas:
                batch, uploaded = self._upload(
                    self._sample_batch(sample, b, torch.device("cpu")),
                    rep.device, b, b)
                pending = _RoutedPending(b, timer=None, replica=rep.index)
                rep.work_q.put_nowait((batch, pending, None, uploaded))
                jobs.append((rep.index, b, pending))
        for idx, b, pending in jobs:
            pending.result()
            self.warmup_report[f"r{idx}:{tag}:b{b}"] = round(
                pending.busy_s, 4)
            self.warmed_buckets.add(b)
        # then one program per (replica, bucket), the largest bucket
        # first, captured on the replica's stream (one capture at a time
        # in a process); each replica's first capture of a bucket reads
        # the record replica 0's wrote, as the JAX pool loads the one
        # entry per bucket it persisted
        for b in sorted(buckets, reverse=True):
            for rep in self._replicas:
                t0 = time.perf_counter()
                batch = self._sample_batch(sample, b, rep.device)
                with rep.lock:
                    src = self._warm_program(rep.index, rep.params, batch,
                                             rep.stream, since)
                rkey = f"r{rep.index}:{tag}:b{b}"
                self.warmup_report[rkey] = round(
                    self.warmup_report[rkey] + time.perf_counter() - t0, 4)
                self.warmup_source[rkey] = src
        rep0 = self._replicas[0]
        for b in buckets:
            self._harvest_cost(rep0.params,
                               self._sample_batch(sample, b, rep0.device))
        self._sync()
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
    #
    # Warmup captures every program against the KV pool it allocates and
    # keeps that pool; `serving_kv` hands it to one `DecodeServing` at a
    # time, so the graphs write where that engine reads. A call on another
    # pool has no program and runs eagerly, as an unwarmed bucket does; it
    # is counted in `gen_eager_calls` and logged.

    def load_generative(self, prefill_fn: Callable, step_fn: Callable,
                        params, paged_prefill_fn: Optional[Callable] = None,
                        paged_step_fn: Optional[Callable] = None,
                        ) -> "InferenceModel":
        """Load the decode-mode program pair (and the paged pair). `params`
        is the model's tree (numpy or tensor leaves), moved onto this
        model's device. Single device: the KV pool is one device buffer
        the programs update in place."""
        self.close()
        self._fn = None
        self._gen_prefill_fn = prefill_fn
        self._gen_step_fn = step_fn
        self._gen_paged_prefill_fn = paged_prefill_fn
        self._gen_paged_step_fn = paged_step_fn
        self._programs.clear()
        self._gen_kv = self._gen_kv_blocks = None
        self._kv_owner = {False: None, True: None}
        self.gen_eager_calls = {}
        self._model_fp = None
        if self.compile_cache is not None:
            # the paged pair joins the fingerprint only when supplied, as
            # in the JAX package
            fns = (prefill_fn, step_fn)
            if paged_prefill_fn is not None or paged_step_fn is not None:
                fns = fns + (paged_prefill_fn, paged_step_fn)
            self._model_fp = model_fingerprint(fns, params)
        self._params = tree_map(
            lambda a: _as_host_tensor(a).to(self.device), params)
        if self.device.type == "cuda" and self._stream0 is None:
            self._stream0 = torch.cuda.Stream(self.device)
        self.serving_dtype = self._infer_serving_dtype(
            tree_leaves(self._params))
        self.warmup_report = {}
        self.warmup_source = {}
        self.warmed_buckets = set()
        self._reset_roofline()
        return self

    @staticmethod
    def _gen_bucket_key(bucket):
        """A bucket discriminator: an int for a prefill or a step, a
        (chunk bucket, kv bucket) tuple for a paged prefill."""
        if isinstance(bucket, (tuple, list)):
            return tuple(int(b) for b in bucket)
        return int(bucket)

    @contextlib.contextmanager
    def _warm_gen(self, kind: str, bucket, report_key: str):
        """One warmup run of a generative program: under `no_grad` (as
        `_counted_forward`) with the model's device current and a
        `CostMeter` (the decode kernels' declared costs included),
        synchronized, timed into `warmup_report`; its count is what
        `account_generative` charges for that program."""
        t0 = time.perf_counter()
        with self._gen_context(torch.no_grad), CostMeter() as meter:
            yield
        self._sync()
        self.warmup_report[report_key] = round(time.perf_counter() - t0, 4)
        cost = meter.cost()
        if cost.flops > 0 or cost.bytes > 0:
            self._gen_cost[(kind, self._gen_bucket_key(bucket))] = cost

    def _gen_context(self, grad_mode=torch.inference_mode):
        """inference mode (`no_grad` for a counted run), with this model's
        CUDA device current."""
        stack = contextlib.ExitStack()
        stack.enter_context(grad_mode())
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
        return stack

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm_gen_program(self, kind: str, bucket, fn: Callable,
                          inputs, report_key: str,
                          compiles_since: int) -> None:
        """Capture one generative program (JAX `_warm_gen` L1459) over
        static buffers shaped like `inputs`; `fn(*inputs)` returns its
        logits. Keyed as the JAX package keys its executable: the model's
        fingerprint, the inputs' signature, the dtype, and `("decode",
        kind, bucket)` as `extra`. Kernel builds count from
        `compiles_since`."""
        bkey = self._gen_bucket_key(bucket)
        tkey = (0, (kind, bkey))
        t0 = time.perf_counter()
        if self._programs.get(tkey) is not None:
            src = "warm"
        else:
            key = None
            if self.compile_cache is not None:
                key = make_key(
                    "serving", self._model_fp or "",
                    abstract_signature(list(inputs)),
                    placement=self.placement,
                    dtype=self.serving_dtype
                    if self.serving_dtype != "float32" else "",
                    extra=("decode", kind) + (bkey if isinstance(
                        bkey, tuple) else (bkey,)),
                    device=self.device)

            def run(*xs):
                with self._gen_context():
                    return fn(*xs)

            program, src = capture_program(
                f"{kind} {bkey}", run, inputs, self.device, self._stream0,
                self._programs.pool(self._stream0), self.compile_cache, key,
                compiles_since)
            self._programs.put(tkey, program)
        self.warmup_report[report_key] = round(
            self.warmup_report.get(report_key, 0.0)
            + time.perf_counter() - t0, 4)
        self.warmup_source[report_key] = src

    def _gen_pool(self, held, init: Callable, args, kinds):
        """The KV pool of a warmup: the one an earlier warmup captured
        `kinds`' programs on when its shape is the same (they stay valid),
        else a new one, and those programs are dropped."""
        args = tuple(int(a) for a in args)
        if held is not None and held[0] == args:
            return held
        for k, _ in self._programs.items():
            if k[1][0] in kinds:
                self._programs.drop(k)
        with self._kv_lock:            # a new pool: no one serves from it
            self._kv_owner[kinds[0].startswith("paged")] = None
        return args, init(*args)

    def serving_kv(self, init_kv: Callable, owner, paged: bool = False
                   ) -> Callable:
        """The pool factory a `DecodeServing` (`owner`) allocates its KV
        through. The pool warmup captured the programs on serves one owner
        at a time: the first that asks for its shape, until
        `release_kv(owner)` (the engine's `stop`) or until the owner is
        collected. Any other owner, or another shape, gets a pool of its
        own from `init_kv`, on which every call runs eagerly."""
        def make(*args):
            held = self._gen_kv_blocks if paged else self._gen_kv
            if held is not None and held[0] == tuple(int(a) for a in args) \
                    and self.claim_kv(owner, paged):
                return held[1]
            if held is not None:
                log.warning("a KV pool %s of its own for %r (the warmed "
                            "one, %s, is held or of another shape): its "
                            "calls run eagerly", tuple(args), owner,
                            held[0])
            return init_kv(*args)
        return make

    def claim_kv(self, owner, paged: bool = False, kv=None) -> bool:
        """Make `owner` the one that serves from the warmed pool (`paged`
        or contiguous), or with `kv`, from `kv` when it is that pool: True
        when the pool is free or `owner`'s already (or `kv` is another
        pool), False while another owner serves from it."""
        with self._kv_lock:
            held = self._gen_kv_blocks if paged else self._gen_kv
            if kv is not None and (held is None or kv is not held[1]):
                return True
            ref = self._kv_owner[paged]
            other = ref() if ref is not None else None
            if other is not None and other is not owner:
                return False
            self._kv_owner[paged] = weakref.ref(owner)
            return True

    def release_kv(self, owner) -> None:
        """`owner` no longer serves from the warmed pools it claimed."""
        with self._kv_lock:
            for paged, ref in self._kv_owner.items():
                if ref is not None and ref() is owner:
                    self._kv_owner[paged] = None

    def _gen_program(self, kind: str, bucket, kv):
        """The warmed program of (`kind`, `bucket`) when `kv` is the pool
        it was captured on, else None (a call on another pool is counted
        in `gen_eager_calls`)."""
        program = self._programs.get((0, (kind, self._gen_bucket_key(
            bucket))))
        if program is None:
            return None
        held = self._gen_kv_blocks if kind.startswith("paged") \
            else self._gen_kv
        pool = tree_leaves(held[1])
        leaves = tree_leaves(kv)
        if len(leaves) != len(pool) or any(
                a is not b for a, b in zip(leaves, pool)):
            with self._kv_lock:
                self.gen_eager_calls[kind] = \
                    self.gen_eager_calls.get(kind, 0) + 1
            return None
        return program

    def program_replays(self) -> Dict[str, int]:
        """Runs of each warmed program by name (on the card, replays of
        its CUDA graph): what shows that a path went through them."""
        return {p.name: p.replays for _, p in self._programs.items()}

    def warmup_generative(self, init_kv: Callable, slots: int,
                          max_kv_len: int, prompt_buckets: List[int],
                          kv_buckets: List[int]) -> "InferenceModel":
        """Run the whole decode program ladder once and capture it: one
        prefill per prompt bucket, one step per kv bucket, on the KV pool
        this warmup allocates and keeps for the engine
        (`serving_kv`). Per-program seconds land in `warmup_report`
        (`gen-prefill:p{P}`, `gen-step:kv{B}`), where each came from in
        `warmup_source`, and each program's count is kept for
        `account_generative`."""
        if self._gen_prefill_fn is None:
            raise RuntimeError("load_generative() first")
        prefill, step = self._gen_prefill_fn, self._gen_step_fn
        for b in kv_buckets:
            if int(b) > max_kv_len:
                raise ValueError(f"kv bucket {b} exceeds max_kv_len "
                                 f"{max_kv_len}")
        self._gen_kv = self._gen_pool(self._gen_kv, init_kv,
                                      (slots, max_kv_len),
                                      ("prefill", "step"))
        kv, params = self._gen_kv[1], self._params
        one, zero = np.ones(1, np.int32), np.zeros(1, np.int32)
        with self._library_cache():
            for P in sorted({int(p) for p in prompt_buckets}, reverse=True):
                tokens = np.zeros(P, np.int32)
                since = _build.build_events()["compiles"]
                with self._warm_gen("prefill", P, f"gen-prefill:p{P}"):
                    prefill(params, kv, tokens, 1, 0)
                self._warm_gen_program(
                    "prefill", P,
                    lambda t, n, s: prefill(params, kv, t, n, s)[1],
                    [tokens, one, zero], f"gen-prefill:p{P}", since)
            for b in sorted({int(b) for b in kv_buckets}, reverse=True):
                zeros = np.zeros(int(slots), np.int32)
                since = _build.build_events()["compiles"]
                with self._warm_gen("step", b, f"gen-step:kv{b}"):
                    step(params, kv, zeros, zeros, kv_bucket=b)
                self._warm_gen_program(
                    "step", b,
                    lambda t, p, _b=b: step(params, kv, t, p,
                                            kv_bucket=_b)[1],
                    [zeros, zeros], f"gen-step:kv{b}", since)
        return self

    def warmup_generative_paged(self, init_kv_blocks: Callable,
                                num_blocks: int, block_len: int,
                                lanes: int, table_len: int,
                                chunk_buckets: List[int],
                                kv_buckets: List[int]) -> "InferenceModel":
        """Run the paged ladder once and capture it: one chunked prefill
        per (chunk bucket × context bucket) — the context window is 0 on a
        fresh first chunk and a kv bucket otherwise — and one paged step
        per kv bucket, on the block pool this warmup allocates and keeps
        for the engine (`serving_kv(..., paged=True)`), with all-zero
        (scratch) tables."""
        if self._gen_paged_prefill_fn is None:
            raise RuntimeError("load_generative(..., paged_prefill_fn=, "
                               "paged_step_fn=) first")
        prefill, step = self._gen_paged_prefill_fn, self._gen_paged_step_fn
        for b in kv_buckets:
            if int(b) % int(block_len):
                raise ValueError(f"kv bucket {b} not a multiple of "
                                 f"block_len {block_len}")
        self._gen_kv_blocks = self._gen_pool(
            self._gen_kv_blocks, init_kv_blocks, (num_blocks, block_len),
            ("paged_prefill", "paged_step"))
        kv, params = self._gen_kv_blocks[1], self._params
        ctx_buckets = [0] + sorted({int(b) for b in kv_buckets})
        table = np.zeros(int(table_len), np.int32)
        one, zero = np.ones(1, np.int32), np.zeros(1, np.int32)
        with self._library_cache():
            for Cb in sorted({int(c) for c in chunk_buckets}, reverse=True):
                for kvb in reversed(ctx_buckets):
                    tokens = np.zeros(Cb, np.int32)
                    rkey = f"gen-paged-prefill:c{Cb}:kv{kvb}"
                    since = _build.build_events()["compiles"]
                    with self._warm_gen("paged_prefill", (Cb, kvb), rkey):
                        prefill(params, kv, tokens, table, 0, 1,
                                kv_bucket=kvb)
                    self._warm_gen_program(
                        "paged_prefill", (Cb, kvb),
                        lambda t, tb, pre, n, _k=kvb: prefill(
                            params, kv, t, tb, pre, n, kv_bucket=_k)[1],
                        [tokens, table, zero, one], rkey, since)
            for b in sorted({int(b) for b in kv_buckets}, reverse=True):
                zeros = np.zeros(int(lanes), np.int32)
                tables = np.zeros((int(lanes), int(table_len)), np.int32)
                since = _build.build_events()["compiles"]
                with self._warm_gen("paged_step", b,
                                    f"gen-paged-step:kv{b}"):
                    step(params, kv, zeros, zeros, tables, kv_bucket=b)
                self._warm_gen_program(
                    "paged_step", b,
                    lambda t, p, tb, _b=b: step(params, kv, t, p, tb,
                                                kv_bucket=_b)[1],
                    [zeros, zeros, tables], f"gen-paged-step:kv{b}", since)
        return self

    @staticmethod
    def _ids(a) -> np.ndarray:
        """Ids, positions, tables and per-call integers as the programs
        take them: int32 arrays (the model moves them onto its device, a
        program copies them into its static buffers)."""
        return np.ascontiguousarray(a, np.int32)

    # Each call replays the warmed program of its bucket (its ids and
    # integers copied into the program's static buffers through pinned
    # staging), or runs the program eagerly when warmup did not make it.

    def generative_prefill(self, kv, tokens, length, slot):
        """One prompt (padded to a prompt bucket) through the prefill
        program. Returns (kv, logits[vocab]) on the device."""
        tokens = self._ids(tokens)
        program = self._gen_program("prefill", tokens.shape[-1], kv)
        if program is not None:
            return kv, program(tokens, self._ids([length]),
                               self._ids([slot]))
        with self._gen_context():
            return self._gen_prefill_fn(self._params, kv, tokens,
                                        int(length), int(slot))

    def generative_step(self, kv, tokens, positions, kv_bucket: int):
        """One decode step for every slot under the serving bucket.
        Returns (kv, logits[slots, vocab]) on the device."""
        tokens, positions = self._ids(tokens), self._ids(positions)
        program = self._gen_program("step", kv_bucket, kv)
        if program is not None:
            return kv, program(tokens, positions)
        with self._gen_context():
            return self._gen_step_fn(self._params, kv, tokens, positions,
                                     kv_bucket=int(kv_bucket))

    def generative_prefill_paged(self, kv, tokens, table, pre_len,
                                 chunk_len, kv_bucket: int):
        """One prompt chunk through the paged prefill for its (chunk
        bucket, context bucket). Returns (kv, logits[vocab])."""
        tokens, table = self._ids(tokens), self._ids(table)
        program = self._gen_program(
            "paged_prefill", (tokens.shape[-1], kv_bucket), kv)
        if program is not None:
            return kv, program(tokens, table, self._ids([pre_len]),
                               self._ids([chunk_len]))
        with self._gen_context():
            return self._gen_paged_prefill_fn(
                self._params, kv, tokens, table, int(pre_len),
                int(chunk_len), kv_bucket=int(kv_bucket))

    def generative_step_paged(self, kv, tokens, positions, tables,
                              kv_bucket: int):
        """One decode step for every lane through the block tables.
        Returns (kv, logits[lanes, vocab])."""
        tokens, positions = self._ids(tokens), self._ids(positions)
        tables = self._ids(tables)
        program = self._gen_program("paged_step", kv_bucket, kv)
        if program is not None:
            return kv, program(tokens, positions, tables)
        with self._gen_context():
            return self._gen_paged_step_fn(
                self._params, kv, tokens, positions, tables,
                kv_bucket=int(kv_bucket))

    def account_generative(self, kind: str, bucket, secs: float):
        """Charge one generative call (`kind` "prefill", "step",
        "paged_prefill" or "paged_step", its bucket, its measured seconds)
        against the serving roofline with the cost counted at warmup; a
        program not warmed pays nothing. Decode is memory-bound, and the
        decode kernels' declared costs are what let the accountant see
        it."""
        if self._roofline is None:
            return
        cost = self._gen_cost.get((kind, self._gen_bucket_key(bucket)))
        if cost is None:
            return
        self._roofline.account("serving", cost.flops, cost.bytes, secs,
                               n_devices=1, int8_flops=cost.int8_flops)

    def compile_cache_size(self) -> int:
        """Programs this model holds (JAX L1673): one per warmed
        (replica, bucket) and per warmed generative program — on the card
        each a captured CUDA graph — summed over replicas."""
        return len(self._programs)

    def graph_pool_bytes(self) -> Dict[Any, Optional[int]]:
        """Device bytes of each replica's graph memory pool (replica 0 is
        the single-device model), from `observability.memwatch`; empty on
        the CPU."""
        return self._programs.pool_bytes()
