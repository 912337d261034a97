"""Kernels written by hand for Hopper, one module per Pallas kernel of the
JAX package (`analytics_zoo_tpu/pallas/`), sources under `../csrc/`.

Each kernel module keeps the plain PyTorch version of its function beside
the wrapper. The wrapper takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises. Every launch adds
one to the kernel's count in `LAUNCHES`, so a run can show that its main
path went through the kernel. A recompute launches again and counts
again: under `BERT(remat=True)` a training step launches the flash
forward twice a block (24 at BERT-base's 12 blocks) and each block's two
dropout passes twice.

Every wrapper also declares the cost of one call, the FLOPs and HBM bytes
its Pallas twin declares in its `pl.CostEstimate`, by running its body
inside `kernel_region(cost_fn, *args)`. A ctypes launch is invisible to
the roofline layer's operator counters (`observability/roofline.py`), so
the region hands its declared cost to every active `CostSink` instead,
and the counters skip the operators inside it: the plain path's aten ops
on the CPU, the allocations around a launch on the card. A step's count
is therefore the same whichever route runs the kernel. With no sink
active a region costs one list test.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Callable, Dict, Iterator, List


class LaunchCounter:
    """Per-kernel launch counts (plain integers), safe to bump from the
    serving threads. A wrapper called while its thread captures a CUDA
    graph (`capturing()`) launches nothing: its count goes to the capture's
    record only. A training step's backward runs on autograd's device
    thread, so a training capture records the calls of every thread
    (`capturing(all_threads=True)`; nothing else launches the repo's
    kernels while a fit captures). Each replay of the graph then adds the
    kernel nodes the graph holds (`add_counts`, with what
    `compile_cache.graphs` reads from the captured graph), so a replayed
    forward counts as an eager one."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._local = threading.local()
        self._shared: List[Dict[str, int]] = []

    def add(self, name: str) -> None:
        stack = getattr(self._local, "stack", None)
        if stack:
            for rec in stack:
                rec[name] = rec.get(name, 0) + 1
            return
        with self._lock:
            if self._shared:
                for rec in self._shared:
                    rec[name] = rec.get(name, 0) + 1
                return
        self.add_counts({name: 1})

    def add_counts(self, counts: Dict[str, int]) -> None:
        with self._lock:
            for name, n in counts.items():
                self._counts[name] = self._counts.get(name, 0) + n

    @contextlib.contextmanager
    def capturing(self, all_threads: bool = False
                  ) -> Iterator[Dict[str, int]]:
        """The wrapper calls this thread (with `all_threads`, any thread)
        makes inside the block, by name, kept out of the counts (a capture
        launches nothing)."""
        if all_threads:
            rec: Dict[str, int] = {}
            with self._lock:
                self._shared.append(rec)
            try:
                yield rec
            finally:
                with self._lock:
                    self._shared.remove(rec)
            return
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        rec: Dict[str, int] = {}
        stack.append(rec)
        try:
            yield rec
        finally:
            stack.remove(rec)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts = {}


# The CUDA symbol of each count's kernel (`csrc/*.cu`), as libcuda names
# a captured graph's kernel nodes (mangled; the demangled form matches
# too): one wrapper call launches one such kernel. The decode kernel's
# second template argument is `paged`.
KERNEL_SYMBOLS: Dict[str, "re.Pattern"] = {
    name: re.compile(pattern) for name, pattern in {
        "flash_attention_fwd": r"flash_fwd_(?:mma_)?kernel",
        "flash_attention_bwd_dkv": r"flash_bwd_dkv_(?:mma_)?kernel",
        "flash_attention_bwd_dq": r"flash_bwd_dq_(?:mma_)?kernel",
        "flash_attention_keep_scale": r"keep_scale_kernel",
        "dropout": r"dropout_kernel",
        "fused_adam": r"fused_adam_multi_kernel",
        "segment_adam": r"segment_adam_kernel",
        "segment_sum": r"segment_sum_kernel",
        "decode_attention":
            r"decode_attention_kernel(?:I[^L]*Lb0E|<[^<>]*,\s*false>)",
        "paged_decode_attention":
            r"decode_attention_kernel(?:I[^L]*Lb1E|<[^<>]*,\s*true>)",
    }.items()}


def kernel_counts(symbols) -> Dict[str, int]:
    """How many of `symbols` (kernel symbols, a graph's kernel nodes) each
    count's kernel is; other kernels (PyTorch's, cuBLAS's) are not
    counted."""
    out: Dict[str, int] = {}
    for sym in symbols:
        for name, pattern in KERNEL_SYMBOLS.items():
            if pattern.search(sym):
                out[name] = out.get(name, 0) + 1
                break
    return out


LAUNCHES = LaunchCounter()


class CostSink:
    """What a counting pass implements to receive declared kernel costs
    (`observability.roofline.CostMeter`)."""

    def add_declared(self, flops: float, bytes_: float) -> None:
        raise NotImplementedError


_SINKS: List[CostSink] = []
_SINKS_LOCK = threading.Lock()
_REGION = threading.local()


def add_sink(sink: CostSink) -> None:
    """Start handing declared costs to `sink`. Process-wide: a kernel
    region entered by any thread while the sink is active reaches it (the
    backward of a CUDA step runs on autograd's device thread)."""
    with _SINKS_LOCK:
        _SINKS.append(sink)


def remove_sink(sink: CostSink) -> None:
    with _SINKS_LOCK:
        _SINKS.remove(sink)


def in_kernel_region() -> bool:
    """True inside a kernel region on this thread: the operator counters
    skip what runs here."""
    return getattr(_REGION, "depth", 0) > 0


@contextlib.contextmanager
def kernel_region(cost_fn: Callable, *args):
    """One call of a kernel wrapper, on either route. `cost_fn(*args)`
    gives its declared `(flops, bytes)`; it is evaluated only while a sink
    is active, and only for the outermost region (a wrapper that calls
    another declares the whole)."""
    if not _SINKS:
        yield
        return
    depth = getattr(_REGION, "depth", 0)
    if depth == 0:
        flops, bytes_ = cost_fn(*args)
        with _SINKS_LOCK:
            sinks = list(_SINKS)
        for sink in sinks:
            sink.add_declared(float(flops), float(bytes_))
    _REGION.depth = depth + 1
    try:
        yield
    finally:
        _REGION.depth = depth
