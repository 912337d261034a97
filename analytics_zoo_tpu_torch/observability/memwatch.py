"""Device-memory telemetry.

Port of `analytics_zoo_tpu/observability/memwatch.py` (L1-256):
`device_memory_snapshot` (L38), `tree_device_bytes` (L101),
`DeviceMemoryWatcher` (L121), `DeviceMemoryLeak` (L207) and `leak_check`
(L212). Device memory is the scarcest resource on a card: a leaked cache
or an un-dropped device reference shows up as an out-of-memory error
hours into a run. This module publishes per-device live/peak byte gauges
and gives tests a leak-check assertion.

Sources, per device:

- a CUDA device: the caching allocator's counters
  (`torch.cuda.memory_allocated`, `max_memory_allocated`) and the card's
  capacity (`get_device_properties().total_memory`), labelled
  ``cuda:<index>`` with source "memory_stats";
- the CPU (the JAX package's CPU backend reports ``cpu:0`` from
  `jax.live_arrays()`): the bytes of every live CPU tensor's storage, each
  storage counted once, found among the objects the garbage collector
  tracks, with source "live_tensors". The watcher tracks the peak across
  samples. Same gauges either way, so dashboards don't care which device
  is under them.

With no `devices` given, a snapshot covers every CUDA device when there is
one, else the CPU.

`DeviceMemoryWatcher` is the periodic publisher (a daemon thread, like
`MetricsReporter`); `sample()` is the one-shot used by the watcher, the
`/healthz` payload, and `leak_check()` — the context manager tests wrap
around a workload to assert it returns device memory to baseline.
"""

from __future__ import annotations

import gc
import logging
import threading
from contextlib import nullcontext as _nullcontext
from typing import Dict, Optional

import torch

log = logging.getLogger("analytics_zoo_tpu_torch.observability")


def _device_label(d: torch.device) -> str:
    return f"{d.type}:{d.index or 0}"


def _default_devices():
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _live_cpu_bytes() -> float:
    """Bytes of every live CPU tensor's storage, each storage once (views
    and parameters sharing one buffer are one allocation)."""
    seen = {}
    for obj in gc.get_objects():
        # type(), not isinstance(): isinstance reads `__class__`, which
        # some lazily deprecated module attributes answer with a warning
        if issubclass(type(obj), torch.Tensor) \
                and obj.device.type == "cpu" \
                and obj.layout == torch.strided:
            try:
                st = obj.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
            except (RuntimeError, NotImplementedError):
                continue           # meta or wrapper tensors own no bytes
    return float(sum(seen.values()))


def graph_pool_bytes(pool, device=None) -> Optional[int]:
    """Device bytes the caching allocator holds for one CUDA graph memory
    pool (`torch.cuda.graph_pool_handle()`): the segments it reserved for
    the captures of one replica's stream. None when this PyTorch's
    snapshot does not name the pools."""
    pool = tuple(pool)
    with torch.cuda.device(device) if device is not None \
            else _nullcontext():
        try:
            segs = torch.cuda.memory_snapshot(mempool_id=pool)
        except TypeError:              # a PyTorch without the argument
            segs = [s for s in torch.cuda.memory_snapshot()
                    if tuple(s.get("segment_pool_id", ())) == pool]
            if not segs and not any("segment_pool_id" in s for s in
                                    torch.cuda.memory_snapshot()):
                return None
    return int(sum(s.get("total_size", 0) for s in segs))


def device_memory_snapshot(devices=None) -> Dict[str, Dict[str, float]]:
    """{device label: {live_bytes, peak_bytes?, limit_bytes?, source}}.
    Never raises: a device whose counters cannot be read reports
    live_bytes=0 with source "none"."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else _default_devices()
    out: Dict[str, Dict[str, float]] = {}
    for d in devs:
        label = _device_label(d)
        if d.type == "cuda":
            try:
                entry = {"live_bytes": float(torch.cuda.memory_allocated(d)),
                         "peak_bytes": float(
                             torch.cuda.max_memory_allocated(d)),
                         "source": "memory_stats"}
                # the card's capacity without creating a context on it
                entry["limit_bytes"] = float(
                    torch.cuda.get_device_properties(d).total_memory)
            except (RuntimeError, AssertionError) as e:
                log.debug("memory stats of %s failed: %s", label, e)
                entry = {"live_bytes": 0.0, "source": "none"}
            out[label] = entry
        elif d.type == "cpu":
            out[label] = {"live_bytes": _live_cpu_bytes(),
                          "source": "live_tensors"}
        else:
            out[label] = {"live_bytes": 0.0, "source": "none"}
    return out


def tree_device_bytes(tree) -> Dict[str, float]:
    """Exact per-device bytes of one module's or state dict's tensors (or
    any nest of dicts, lists and tuples of tensors): {device label:
    bytes}, each storage counted once. `device_memory_snapshot` reports
    the whole process, this reports one tree."""
    from analytics_zoo_tpu_torch.common.tree import tree_leaves
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict(keep_vars=True)
    storages: Dict[tuple, float] = {}
    for leaf in tree_leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            continue                       # host scalars hold no tensor
        st = leaf.untyped_storage()
        storages[(_device_label(leaf.device), st.data_ptr())] = \
            float(st.nbytes())
    out: Dict[str, float] = {}
    for (label, _), nbytes in storages.items():
        out[label] = out.get(label, 0.0) + nbytes
    return out


class DeviceMemoryWatcher:
    """Daemon thread publishing per-device memory gauges every
    `interval_s`:

    - `device_memory_live_bytes{device}` — bytes in use now
    - `device_memory_peak_bytes{device}` — high-water mark (runtime's
      when available, else the max this watcher has observed)
    - `device_memory_limit_bytes{device}` — capacity, when the runtime
      reports one

    `sample()` publishes once and returns the snapshot, so the watcher
    is equally usable one-shot (healthz, bench teardown)."""

    def __init__(self, interval_s: float = 10.0, registry=None,
                 devices=None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        from analytics_zoo_tpu_torch.observability.registry import \
            get_registry
        self.registry = registry if registry is not None else get_registry()
        self.interval_s = float(interval_s)
        self.devices = devices
        self._peaks: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self) -> Dict[str, Dict[str, float]]:
        snap = device_memory_snapshot(self.devices)
        live_g = self.registry.gauge(
            "device_memory_live_bytes",
            "device memory in use, per device (memory_stats or live "
            "tensor accounting)")
        peak_g = self.registry.gauge(
            "device_memory_peak_bytes",
            "device memory high-water mark, per device")
        limit_g = self.registry.gauge(
            "device_memory_limit_bytes",
            "device memory capacity, per device (when the runtime "
            "reports it)")
        for label, entry in snap.items():
            live = entry["live_bytes"]
            live_g.set(live, device=label)
            peak = entry.get("peak_bytes")
            if peak is None:
                # fallback source: track the max WE have seen
                peak = max(self._peaks.get(label, 0.0), live)
                entry["peak_bytes"] = peak
            self._peaks[label] = max(self._peaks.get(label, 0.0), peak)
            peak_g.set(self._peaks[label], device=label)
            if "limit_bytes" in entry:
                limit_g.set(entry["limit_bytes"], device=label)
        return snap

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception as e:  # noqa: BLE001 — the watcher must
                # outlive any backend hiccup it is watching
                log.debug("memory sample failed: %s: %s",
                          type(e).__name__, e)

    def start(self) -> "DeviceMemoryWatcher":
        if self._thread is not None:
            raise RuntimeError("watcher already started")
        self.sample()                       # gauges exist from t0
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="device-memory-watcher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "DeviceMemoryWatcher":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class DeviceMemoryLeak(AssertionError):
    """Raised by `leak_check` when live device bytes grew past the
    tolerance — an AssertionError so pytest renders it as a failure."""


class leak_check:  # noqa: N801 — context-manager, used like a function
    """Assert a workload returns device memory to baseline:

        with leak_check(tolerance_bytes=1 << 20):
            model.predict(batch)           # everything it allocates
                                           # must be released again

    Live bytes are measured (after a `gc.collect()` — dropped Python
    refs must not read as device leaks) before and after; growth beyond
    `tolerance_bytes` raises `DeviceMemoryLeak` naming the per-device
    deltas. The `grew` attribute carries the measured growth either
    way, for tests that want the number."""

    def __init__(self, tolerance_bytes: float = 1 << 20, devices=None):
        self.tolerance_bytes = float(tolerance_bytes)
        self.devices = devices
        self.before: Dict[str, float] = {}
        self.grew: Dict[str, float] = {}

    @staticmethod
    def _live(devices) -> Dict[str, float]:
        gc.collect()
        return {label: e["live_bytes"]
                for label, e in device_memory_snapshot(devices).items()}

    def __enter__(self) -> "leak_check":
        self.before = self._live(self.devices)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:
            return False               # the workload failed; report THAT
        after = self._live(self.devices)
        self.grew = {label: after.get(label, 0.0) - b
                     for label, b in self.before.items()
                     if after.get(label, 0.0) - b > 0}
        leaked = {label: g for label, g in self.grew.items()
                  if g > self.tolerance_bytes}
        if leaked:
            detail = ", ".join(f"{label}: +{g:,.0f} B"
                               for label, g in sorted(leaked.items()))
            raise DeviceMemoryLeak(
                f"device memory grew past the {self.tolerance_bytes:,.0f}"
                f" B tolerance ({detail})")
        return False
