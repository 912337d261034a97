"""Captured programs: the port's counterpart of an AOT executable.

The JAX package compiles one executable per (replica, bucket) at warmup
(`analytics_zoo_tpu/compile_cache/aot_fn.py`, and `serialization.py` to
write it to disk) and dispatches through that table
(`serving/inference_model.py` `_aot_call` L749, `_warm_executable`
L759-800, `_warm_gen` L1459-1500). PyTorch runs eagerly, and a forward is
hundreds of launches from Python; the port's counterpart is a CUDA graph,
captured once per program at warmup and replayed, in a table keyed by
(replica, `abstract_signature` of the program's inputs).

`GraphProgram` holds one program over static input buffers:

- on a CUDA device it runs the program once eagerly on the replica's
  stream (that builds and loads its kernel libraries and sets up cuBLAS
  for that stream), captures it with `torch.cuda.graph` on the same
  stream into the stream's memory pool, and keeps the static inputs and
  outputs. A call copies its inputs into the static buffers (host inputs
  through pinned staging buffers), replays, and clones the outputs, all
  on the program's stream and under the program's lock, so that two
  threads never interleave their copies and replays and a pending result
  is never overwritten by the next replay;
- on the CPU it runs the same buffer protocol with no capture: copy in,
  call, copy out. This is the plain path the CPU tests see, as a kernel
  wrapper takes its plain version for a CPU tensor.

A wrapper called during the capture launches nothing and counts nothing
(`kernels.LAUNCHES.capturing`). After the capture the program reads the
captured graph's kernel nodes through libcuda
(`graph_kernel_symbols`) and counts those that are the repo's kernels
(`kernels.kernel_counts`); the capture fails unless they are the wrapper
calls it saw, one node each. Every replay launches those nodes, and adds
their counts to `LAUNCHES`: a replayed BERT forward counts the 12 flash
nodes its graph holds. A capture that fails raises, naming the program;
nothing falls back to eager.

A graph cannot be written to disk. What persists (`capture_program`, with
a `CompileCache`) is a capture record per program, a marker keyed as the
JAX package keys the executable, and, through `kernels/_build.py`, the
kernel libraries: a warm restart takes them from the cache during the
eager run before the capture, runs no nvcc, and reports the program
"cached".

Captures run one at a time in a process (`torch.cuda.graph`'s own rule),
with `capture_error_mode="thread_local"`, so that serving threads keep
running while a swap recaptures. One memory pool per stream: the
programs of one replica replay in order on its stream, never at once, so
they may share one pool; capture the largest bucket first.

`TrainProgram` is the training twin, the counterpart of the JAX fit's
jitted step (`build_train_step`) and k-step run (`build_train_run`): one
program of one or more training steps over buffers its caller owns (the
static batch or the device-resident data and its cursor, the step's
scalar table, the model's parameters and buffers, the optimizer state
and a loss buffer). Its first run is eager, on the program's stream;
the second captures it, with the calls of every thread recorded (the
backward runs on autograd's device thread), and replays; every later run
replays. Nothing a step reads may be a host value that changes from step
to step: the seeds and optimizer scalars come from the table, which the
caller writes before each run.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_map
from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build, kernel_counts

# one capture at a time in a process (torch.cuda.graph's documented rule);
# the eager run before it is inside too, so a program's kernel builds are
# its own
_CAPTURE_LOCK = threading.Lock()


class CaptureError(RuntimeError):
    """A program could not be captured as a CUDA graph."""


_CU_GRAPH_NODE_TYPE_KERNEL = 0
_CU_GRAPH_NODE_TYPE_GRAPH = 4
_libcuda_lib = None


def _libcuda():
    """libcuda, its graph and function queries typed."""
    global _libcuda_lib
    if _libcuda_lib is None:
        lib = ctypes.CDLL("libcuda.so.1")
        vp, sz = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        lib.cuGraphGetNodes.argtypes = [vp, ctypes.POINTER(vp), sz]
        lib.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
        lib.cuGraphChildGraphNodeGetGraph.argtypes = [vp,
                                                      ctypes.POINTER(vp)]
        lib.cuGraphKernelNodeGetParams_v2.argtypes = [vp, vp]
        lib.cuFuncGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), vp]
        _libcuda_lib = lib
    return _libcuda_lib


def _cu(result: int, what: str) -> None:
    if result != 0:
        raise CaptureError(f"{what} failed: CUresult {result}")


def graph_kernel_symbols(graph: int) -> List[str]:
    """The symbol of every kernel node of a captured CUDA graph (a
    `cudaGraph_t`, `CUDAGraph.raw_cuda_graph()`), child graphs included,
    read through libcuda: `cuGraphGetNodes`, `cuGraphNodeGetType`,
    `cuGraphKernelNodeGetParams` (the function is the first field of its
    `CUDA_KERNEL_NODE_PARAMS_v2`) and `cuFuncGetName`."""
    cu = _libcuda()
    n = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out: List[str] = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _cu(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        if kind.value == _CU_GRAPH_NODE_TYPE_GRAPH:
            child = ctypes.c_void_p()
            _cu(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                "cuGraphChildGraphNodeGetGraph")
            out += graph_kernel_symbols(child.value)
        elif kind.value == _CU_GRAPH_NODE_TYPE_KERNEL:
            params = (ctypes.c_void_p * 16)()     # > the 72-byte struct
            _cu(cu.cuGraphKernelNodeGetParams_v2(node, params),
                "cuGraphKernelNodeGetParams")
            name = ctypes.c_char_p()
            _cu(cu.cuFuncGetName(ctypes.byref(name), params[0]),
                "cuFuncGetName")
            out.append(name.value.decode())
    return out


@contextlib.contextmanager
def _no_collection():
    """No garbage collection inside a capture: a collection could destroy
    a dead program's graph (a model and its programs form a reference
    cycle), which the capturing thread may not do, and the capture would
    be invalidated. `torch.cuda.graph` collects just before it begins."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


class GraphProgram:
    """One program `fn(*inputs)` over static input buffers shaped like
    `inputs` (its outputs: a tensor, or a tree of tensors). `device` is
    where it runs; on CUDA, `stream` (the replica's) and `pool` (that
    stream's memory pool) are where it is captured and replayed.
    `launches`: the repo's kernel nodes its graph holds, by count name,
    which each replay adds to `LAUNCHES` (empty on the CPU)."""

    def __init__(self, name: str, fn: Callable[..., Any],
                 inputs: Sequence, device: torch.device,
                 stream: Optional["torch.cuda.Stream"] = None,
                 pool=None):
        self.name = name
        self.device = torch.device(device)
        self._fn = fn
        self._lock = threading.Lock()
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.graph = None
        self.stream = stream
        self.pool = pool
        cuda = self.device.type == "cuda"
        self.static_in = [torch.empty_like(_as_tensor(x), device=self.device)
                          for x in inputs]
        for s, x in zip(self.static_in, inputs):
            s.copy_(_as_tensor(x))
        # pinned staging for host inputs, and the event that says the last
        # staged copy has left it
        self._stage: List[Optional[torch.Tensor]] = [None] * len(inputs)
        self._staged: Optional["torch.cuda.Event"] = None
        self.static_out = None
        if cuda:
            self._capture()

    # -- capture ------------------------------------------------------------
    def _capture(self) -> None:
        dev = self.device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        stream = self.stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                # eager first: kernel libraries load here, never inside the
                # capture, and cuBLAS sets up its workspace for this stream
                self._fn(*self.static_in)
            stream.synchronize()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with LAUNCHES.capturing() as called, torch.cuda.device(dev), \
                    _no_collection():
                with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    out = self._fn(*self.static_in)
            stream.synchronize()
            nodes = kernel_counts(graph_kernel_symbols(
                graph.raw_cuda_graph()))
            graph.instantiate()
        except Exception as e:  # noqa: BLE001 — re-raised, named
            raise CaptureError(
                f"CUDA graph capture of {self.name} failed: "
                f"{type(e).__name__}: {e}") from e
        if nodes != called:
            raise CaptureError(
                f"CUDA graph capture of {self.name}: the graph holds the "
                f"kernel nodes {nodes}, its kernel wrappers were called "
                f"{called}")
        self.graph = graph
        self.static_out = out
        self.launches = nodes

    # -- replay -------------------------------------------------------------
    def _fill(self, static: torch.Tensor, x, i: int) -> None:
        """Copy one input into its static buffer. An input with fewer rows
        than the buffer fills the first rows, and its last row repeats into
        the rest (a batch padded to its bucket)."""
        x = _as_tensor(x)
        if x.dim() != static.dim() or x.shape[1:] != static.shape[1:] \
                or (x.dim() and not 0 < x.shape[0] <= static.shape[0]):
            raise ValueError(
                f"{self.name}: input {i} {tuple(x.shape)} does not fit its "
                f"static buffer {tuple(static.shape)}")
        n = rows = 0
        if static.dim():
            n, rows = x.shape[0], static.shape[0]
        head = static[:n] if static.dim() else static
        if x.device.type == "cpu" and static.device.type == "cuda":
            stage = self._stage[i]
            if stage is None:
                stage = self._stage[i] = torch.empty_like(
                    static, device="cpu").pin_memory()
            stage_head = stage[:n] if stage.dim() else stage
            stage_head.copy_(x)
            head.copy_(stage_head, non_blocking=True)
        else:
            head.copy_(x, non_blocking=True)
        if n < rows:
            static[n:].copy_(static[n - 1:n].expand(
                (rows - n,) + tuple(static.shape[1:])))

    def __call__(self, *inputs):
        """One run: copy in, replay (or call, on the CPU), copy out."""
        if len(inputs) != len(self.static_in):
            raise ValueError(f"{self.name} takes {len(self.static_in)} "
                             f"inputs, got {len(inputs)}")
        with self._lock:
            if self.graph is None:
                for i, (s, x) in enumerate(zip(self.static_in, inputs)):
                    self._fill(s, x, i)
                out = tree_map(torch.clone, self._fn(*self.static_in))
                self.replays += 1
                return out
            dev = self.device
            cur = torch.cuda.current_stream(dev)
            stream = self.stream
            other = stream != cur
            if other:
                stream.wait_stream(cur)
            if self._staged is not None and any(
                    not (isinstance(x, torch.Tensor) and x.is_cuda)
                    for x in inputs):
                self._staged.synchronize()   # the last staged copy left
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                for i, (s, x) in enumerate(zip(self.static_in, inputs)):
                    if other and isinstance(x, torch.Tensor) and x.is_cuda:
                        x.record_stream(stream)
                    self._fill(s, x, i)
                if self._staged is None:
                    self._staged = torch.cuda.Event()
                self._staged.record(stream)
                self.graph.replay()
                out = tree_map(torch.clone, self.static_out)
            if other:
                cur.wait_stream(stream)
                for t in tree_leaves(out):
                    t.record_stream(cur)
            LAUNCHES.add_counts(self.launches)
            self.replays += 1
            return out


class ProgramTable:
    """The in-process program table: (replica, signature) → GraphProgram,
    with one memory pool per stream."""

    def __init__(self):
        self._programs: Dict[Tuple, GraphProgram] = {}
        self._pools: Dict[Any, Any] = {}
        self._lock = threading.Lock()

    def get(self, key: Tuple) -> Optional[GraphProgram]:
        return self._programs.get(key)

    def put(self, key: Tuple, program: GraphProgram) -> None:
        with self._lock:
            self._programs[key] = program

    def drop(self, key: Tuple) -> None:
        with self._lock:
            self._programs.pop(key, None)

    def pool(self, stream) -> Any:
        """The memory pool of `stream`'s captures (None on the CPU)."""
        if stream is None:
            return None
        with self._lock:
            pool = self._pools.get(stream)
            if pool is None:
                pool = self._pools[stream] = torch.cuda.graph_pool_handle()
            return pool

    def clear(self) -> None:
        with self._lock:
            self._programs = {}
            self._pools = {}

    def items(self) -> List[Tuple[Tuple, GraphProgram]]:
        with self._lock:
            return list(self._programs.items())

    def __len__(self) -> int:
        return len(self._programs)

    def pool_bytes(self) -> Dict[Any, Optional[int]]:
        """Device bytes of each replica's graph pool (None where the
        allocator cannot say), from `observability.memwatch`."""
        from analytics_zoo_tpu_torch.observability.memwatch import \
            graph_pool_bytes
        out: Dict[Any, Optional[int]] = {}
        for key, prog in self.items():
            if prog.pool is not None and key[0] not in out:
                out[key[0]] = graph_pool_bytes(prog.pool, prog.device)
        return out


_eager_only = threading.Event()


@contextlib.contextmanager
def eager_programs():
    """Run every `TrainProgram` eagerly inside the block, on the card
    too: the eager leg of a check that holds a graphed fit against an
    eager one."""
    _eager_only.set()
    try:
        yield
    finally:
        _eager_only.clear()


class TrainProgram:
    """One training program `fn(capturing)` on `device`. `fn` runs the
    program's steps on its caller's buffers and returns what its caller
    keeps from an eager run (`capturing` is True while it is captured, and
    its result is then dropped). On the card a call runs `fn` eagerly on
    the program's stream until `capture()` has captured it into a CUDA
    graph in its own memory pool, and replays the graph from then on; the
    caller's stream waits for the program. On the CPU every call runs `fn`
    eagerly and `capture()` does nothing. `launches`: the repo's kernel
    nodes of the graph, which each replay adds to `LAUNCHES`.
    `graphs=False` keeps a program eager on the card too (a fit whose
    collectives run over gloo, which a CUDA graph cannot hold): decided
    before any capture, never by a failed one."""

    def __init__(self, name: str, fn: Callable[[bool], Any],
                 device: torch.device, graphs: bool = True):
        self.name = name
        self.device = torch.device(device)
        self._fn = fn
        self.graphs = graphs
        self.launches: Dict[str, int] = {}
        self.graph = None
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    @contextlib.contextmanager
    def _on_stream(self):
        """The block on the program's stream, after the caller's stream's
        work; the caller's stream then waits for it."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        try:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                yield
        finally:
            cur.wait_stream(self.stream)

    def __call__(self) -> Tuple[Any, bool]:
        """One run: `(fn's result, False)` for an eager run, `(None,
        True)` for a replay."""
        if self.stream is None:
            return self._fn(False), False
        if self.graph is None or _eager_only.is_set():
            with self._on_stream():
                return self._fn(False), False
        with self._on_stream():
            self.graph.replay()
        LAUNCHES.add_counts(self.launches)
        return None, True

    def capture(self) -> None:
        """Capture the program (on the card, once, after an eager run has
        built and loaded its kernels; not inside `eager_programs()`)."""
        if self.stream is None or self.graph is not None \
                or not self.graphs or _eager_only.is_set():
            return
        with self._on_stream():
            self._capture()

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with _CAPTURE_LOCK, _no_collection():
            try:
                with LAUNCHES.capturing(all_threads=True) as called, \
                        torch.cuda.device(self.device):
                    with torch.cuda.graph(graph, stream=self.stream,
                                          capture_error_mode="thread_local"):
                        self._fn(True)
                self.stream.synchronize()
                nodes = kernel_counts(graph_kernel_symbols(
                    graph.raw_cuda_graph()))
                graph.instantiate()
            except Exception as e:  # noqa: BLE001 — re-raised, named
                raise CaptureError(
                    f"CUDA graph capture of {self.name} failed: "
                    f"{type(e).__name__}: {e}") from e
        if nodes != called:
            raise CaptureError(
                f"CUDA graph capture of {self.name}: the graph holds the "
                f"kernel nodes {nodes}, its kernel wrappers were called "
                f"{called}")
        self.graph = graph
        self.launches = nodes


def capture_program(name: str, fn: Callable[..., Any], inputs: Sequence,
                    device: torch.device, stream=None, pool=None,
                    cache=None, key=None, compiles_since: Optional[int] = None
                    ) -> Tuple[GraphProgram, str]:
    """Capture one program (`GraphProgram`) through the persistent cache:
    with `cache` and its capture-record `key`, the kernel libraries the
    eager run loads come from the cache where it holds them. Returns the
    program and where it came from: "cached" when the record was found and
    nvcc ran 0 times for the program (since `compiles_since`, the build
    count when the caller began warming it, default: this call), else
    "compiled" (the record is then written); "uncached" with no cache."""
    with _CAPTURE_LOCK:
        t0 = time.perf_counter()
        found = cache is not None and key is not None \
            and cache.load(key) is not None
        compiles = _build.build_events()["compiles"] \
            if compiles_since is None else compiles_since
        ctx = _build.library_cache(cache) if cache is not None \
            else contextlib.nullcontext()
        with ctx:
            program = GraphProgram(name, fn, inputs, device, stream, pool)
        if cache is None or key is None:
            return program, "uncached"
        if found and _build.build_events()["compiles"] == compiles:
            return program, "cached"
        if not found:
            cache.put(key, name.encode(),
                      compile_ms=(time.perf_counter() - t0) * 1e3)
    return program, "compiled"
