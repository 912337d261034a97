"""Roofline accounting: how many FLOPs and HBM bytes a program moved per
second, against what the card can do.

Port of `analytics_zoo_tpu/observability/roofline.py`: `ExecCost` (L45),
`cost_of` (L78), the session roofline (`set_session_roofline` L143,
`session_roofline` L170), `RooflineAccountant` (L200) and `get_accountant`
(L333), with the same gauge names. Where XLA's cost analysis gives the JAX
package its count, the port counts the operators a call really runs:

- `CostMeter`, a `TorchDispatchMode`, sees every aten operator on the
  threads it is active on (autograd carries it into the backward). It
  counts FLOPs with `torch.utils.flop_counter`'s formulas (matmuls,
  convolutions, attention; elementwise operators count none, as in that
  module) and bytes as each operator's tensor operands and outputs, read
  and written once. View and allocation operators move nothing. So the
  bytes are those of eager PyTorch, operator by operator, where XLA's are
  those of the fused program.
- A hand-written kernel is a ctypes launch, invisible to the mode. Each
  kernel wrapper declares the cost its Pallas twin declares
  (`kernels.kernel_region`); the meter adds it and skips the operators
  inside the region, so the count is the same on the card and on the CPU,
  where the region runs the kernel's plain version.
- `torch.utils.flop_counter` has no formula for `aten._int_mm`, the int8
  GEMM of the quantized serving path (`serving/quantization.py`): the
  meter counts it as 2·M·N·K and keeps that share apart
  (`ExecCost.int8_flops`), and the accountant charges it at the int8
  rate, the rest at the bf16 one (a matmul's time at its own peak, both
  from the session roofline), so int8 serving does not read near 0 MFU.

The session roofline is the measured bound a caller installs
(`set_session_roofline`), else the card's published peaks
(`utils/roofline.py`: the H100's, for an unknown device too). The port
has no environment switches: the JAX package's `ZOO_SESSION_HBM_GBPS` /
`ZOO_SESSION_TFLOPS` are not read.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from analytics_zoo_tpu_torch.kernels import (CostSink, add_sink,
                                             in_kernel_region, remove_sink)

log = logging.getLogger("analytics_zoo_tpu_torch.observability")


class ExecCost:
    """FLOPs and HBM bytes one call performs: the model's work counted
    once (JAX L45). `kernel_flops` / `kernel_bytes` are the part the
    kernel regions declared, `int8_flops` the part int8 GEMMs did."""

    __slots__ = ("flops", "bytes", "kernel_flops", "kernel_bytes",
                 "int8_flops")

    def __init__(self, flops: float, bytes_: float,
                 kernel_flops: float = 0.0, kernel_bytes: float = 0.0,
                 int8_flops: float = 0.0):
        self.flops = float(flops)
        self.bytes = float(bytes_)
        self.kernel_flops = float(kernel_flops)
        self.kernel_bytes = float(kernel_bytes)
        self.int8_flops = float(int8_flops)

    def __repr__(self):
        return (f"ExecCost(flops={self.flops:g}, bytes={self.bytes:g}, "
                f"kernel_flops={self.kernel_flops:g}, "
                f"int8_flops={self.int8_flops:g})")


# operators that allocate without moving data
_NO_TRAFFIC = frozenset(
    getattr(torch.ops.aten, n) for n in (
        "empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "lift_fresh", "_local_scalar_dense")
    if hasattr(torch.ops.aten, n))
_INT_MM = torch.ops.aten._int_mm


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0


class CostMeter(TorchDispatchMode, CostSink):
    """Counts FLOPs and bytes of what runs inside `with CostMeter() as m:`
    (the operators on this thread and in the backward it starts), plus the
    declared cost of every kernel region entered meanwhile. The operators
    run unchanged: the mode only looks at them."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self._lock = threading.Lock()
        self.op_flops = 0.0
        self.op_bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.int8_flops = 0.0

    def add_declared(self, flops: float, bytes_: float) -> None:
        with self._lock:
            self.kernel_flops += flops
            self.kernel_bytes += bytes_

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not in_kernel_region():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        flops = 0
        int8 = packet is _INT_MM
        formula = self._formulas.get(packet)
        if int8:
            (m, k), n = args[0].shape, args[1].shape[1]
            flops = 2 * m * n * k
        elif formula is not None:
            try:
                flops = formula(*args, **kwargs, out_val=out)
            except Exception as e:  # noqa: BLE001 — telemetry only
                log.debug("flop formula of %s failed: %s", packet, e)
        nbytes = 0
        if packet not in _NO_TRAFFIC and not func.is_view:
            nbytes = _tensor_bytes(args) + _tensor_bytes(kwargs) \
                + _tensor_bytes(out)
        with self._lock:
            self.op_flops += flops
            self.op_bytes += nbytes
            if int8:
                self.int8_flops += flops

    def __enter__(self):
        add_sink(self)
        try:
            return super().__enter__()
        except BaseException:
            remove_sink(self)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            remove_sink(self)

    def cost(self) -> ExecCost:
        with self._lock:
            return ExecCost(self.op_flops + self.kernel_flops,
                            self.op_bytes + self.kernel_bytes,
                            self.kernel_flops, self.kernel_bytes,
                            self.int8_flops)


def count_cost(fn, *args, **kwargs) -> Tuple[Any, ExecCost]:
    """`(fn(*args, **kwargs), its ExecCost)`: the call runs for real under
    a `CostMeter`, so its result is what it computes without one."""
    with CostMeter() as meter:
        out = fn(*args, **kwargs)
    return out, meter.cost()


def cost_of(fn, *args, **kwargs) -> Optional[ExecCost]:
    """The ExecCost of one call of `fn` (JAX L78), or None when it counted
    nothing (no operator with a FLOP formula or bytes, no kernel
    region). The call runs; its result is dropped."""
    _, cost = count_cost(fn, *args, **kwargs)
    if cost.flops <= 0.0 and cost.bytes <= 0.0:
        return None
    return cost


# ---------------------------------------------------------------------------
# Session roofline: the measured achievable bound (falls back to the peaks)
# ---------------------------------------------------------------------------
_session_lock = threading.Lock()
_session: Dict[str, Optional[float]] = {"hbm_gbps": None, "tflops": None}


def set_session_roofline(hbm_gbps: Optional[float] = None,
                         tflops: Optional[float] = None,
                         registry=None) -> None:
    """Install the session's measured achievable bounds as the roofline
    denominator, and publish them as gauges so every scrape shows what
    "100%" meant."""
    from analytics_zoo_tpu_torch.observability.registry import get_registry
    reg = registry if registry is not None else get_registry()
    with _session_lock:
        if hbm_gbps is not None:
            _session["hbm_gbps"] = float(hbm_gbps)
        if tflops is not None:
            _session["tflops"] = float(tflops)
    if hbm_gbps is not None:
        reg.gauge("roofline_session_hbm_gbps",
                  "measured achievable HBM GB/s this session (the "
                  "utilization denominator; published peak when unset)"
                  ).set(float(hbm_gbps))
    if tflops is not None:
        reg.gauge("roofline_session_tflops",
                  "measured achievable bf16 TFLOP/s this session (the "
                  "MFU denominator; published peak when unset)"
                  ).set(float(tflops))


def session_roofline(device=None) -> Tuple[float, float]:
    """(HBM bytes/s, FLOP/s) roofline denominators: the installed session
    bounds, else the published peaks of `device` (default: the current
    card; the H100's for an unknown device or the CPU)."""
    from analytics_zoo_tpu_torch.utils.roofline import peak_flops, peak_hbm
    with _session_lock:
        hbm_gbps = _session["hbm_gbps"]
        tflops = _session["tflops"]
    return (hbm_gbps * 1e9 if hbm_gbps is not None else peak_hbm(device),
            tflops * 1e12 if tflops is not None else peak_flops(device))


# ---------------------------------------------------------------------------
# The accountant
# ---------------------------------------------------------------------------
class RooflineAccountant:
    """Per-kind (flops, bytes, busy-seconds) accumulation → registry.

    `account(kind, flops, bytes, seconds)` is the single entry point (the
    trainer calls it once per epoch, with the epoch's device time; serving
    once per materialized batch). `int8_flops`, the part of `flops` int8
    GEMMs did, is charged at the int8 rate in MFU (`_mfu`).
    Counters accumulate forever; the derived gauges are computed from
    THIS call's window, so a cold first epoch depresses only its own
    reading. `snapshot(kind)` reports the accumulation since the last
    `reset(kind)`. Never raises out of `account`."""

    def __init__(self, registry=None):
        from analytics_zoo_tpu_torch.observability.registry import \
            get_registry
        self._registry = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        # kind -> [flops, bytes, seconds, devices, stall s, int8 flops]
        self._acc: Dict[str, list] = {}

    def _reg(self):
        reg = self._registry
        return (
            reg.counter("roofline_flops_total",
                        "FLOPs executed, per the operator count plus the "
                        "kernels' declared costs, by kind"),
            reg.counter("roofline_hbm_bytes_total",
                        "HBM bytes accessed, per the operator count plus "
                        "the kernels' declared costs, by kind"),
            reg.counter("roofline_busy_seconds_total",
                        "measured busy wall seconds the flops/bytes "
                        "counters were accumulated over, by kind"),
            reg.gauge("roofline_achieved_tflops",
                      "achieved TFLOP/s over the latest window"),
            reg.gauge("roofline_achieved_hbm_gbps",
                      "achieved HBM GB/s over the latest window"),
            reg.gauge("roofline_mfu",
                      "achieved FLOP/s over the session FLOP roofline "
                      "(counted MFU; no flops_per_step needed)"),
            reg.gauge("roofline_hbm_utilization",
                      "achieved HBM bytes/s over the session HBM "
                      "roofline"),
        )

    def account(self, kind: str, flops: float, bytes_: float,
                seconds: float, device=None, n_devices: int = 1,
                int8_flops: float = 0.0) -> None:
        try:
            if seconds <= 0.0 or (flops <= 0.0 and bytes_ <= 0.0):
                return
            with self._lock:
                acc = self._acc.setdefault(kind, _new_acc())
                acc[0] += flops
                acc[1] += bytes_
                acc[2] += seconds
                acc[3] = max(acc[3], max(1, int(n_devices)))
                acc[5] += int8_flops
            (c_flops, c_bytes, c_secs, g_tflops, g_gbps, g_mfu,
             g_hbm) = self._reg()
            c_flops.inc(flops, kind=kind)
            c_bytes.inc(bytes_, kind=kind)
            c_secs.inc(seconds, kind=kind)
            g_tflops.set(flops / seconds / 1e12, kind=kind)
            g_gbps.set(bytes_ / seconds / 1e9, kind=kind)
            hbm_roof, flops_roof = session_roofline(device)
            n = max(1, int(n_devices))
            if flops_roof > 0:
                g_mfu.set(_mfu(flops, int8_flops, seconds, flops_roof, n,
                               device), kind=kind)
            if hbm_roof > 0:
                g_hbm.set(bytes_ / seconds / (hbm_roof * n), kind=kind)
        except Exception as e:  # noqa: BLE001 — telemetry must not raise
            log.debug("roofline accounting failed: %s: %s",
                      type(e).__name__, e)

    def account_stall(self, kind: str, stall_seconds: float) -> None:
        """Wall seconds the kind's loop sat blocked on its input pipeline
        inside the busy window (`snapshot`'s `input_stall_*`)."""
        try:
            if stall_seconds <= 0.0:
                return
            with self._lock:
                acc = self._acc.setdefault(kind, _new_acc())
                acc[4] += stall_seconds
        except Exception as e:  # noqa: BLE001 — telemetry must not raise
            log.debug("roofline stall accounting failed: %s: %s",
                      type(e).__name__, e)

    def reset(self, kind: Optional[str] = None) -> None:
        with self._lock:
            if kind is None:
                self._acc.clear()
            else:
                self._acc.pop(kind, None)

    def snapshot(self, kind: str) -> Dict[str, float]:
        with self._lock:
            f, b, s, n, stall, i8 = self._acc.get(kind, _new_acc())
        out: Dict[str, Any] = {"flops": f, "bytes": b, "seconds": s,
                               "devices": n, "input_stall_seconds": stall}
        if s > 0:
            out["achieved_tflops"] = f / s / 1e12
            out["achieved_hbm_gbps"] = b / s / 1e9
            out["input_stall_fraction"] = min(1.0, stall / s)
            hbm_roof, flops_roof = session_roofline()
            out["mfu"] = _mfu(f, i8, s, flops_roof, n)
            out["hbm_utilization"] = b / s / (hbm_roof * n)
        return out


def _new_acc() -> list:
    return [0.0, 0.0, 0.0, 1, 0.0, 0.0]


def _mfu(flops: float, int8_flops: float, seconds: float,
         flops_roof: float, n: int, device=None) -> float:
    """Model FLOPs utilization over `n` devices against the session
    roofline `flops_roof`: the time the work takes at peak over the time
    it took. The int8 part runs at that roofline times the card's
    published int8 : bf16 ratio (2 on the H100), so it counts as that
    ratio's inverse in bf16 FLOPs, and a measured bound scales both."""
    from analytics_zoo_tpu_torch.utils.roofline import peak_flops
    ratio = peak_flops(device) / peak_flops(device, dtype=torch.int8)
    return (flops - int8_flops + int8_flops * ratio) / seconds \
        / (flops_roof * n)


_default_accountant: Optional[RooflineAccountant] = None
_default_lock = threading.Lock()


def get_accountant() -> RooflineAccountant:
    """The process-wide accountant on the default registry."""
    global _default_accountant
    with _default_lock:
        if _default_accountant is None:
            _default_accountant = RooflineAccountant()
        return _default_accountant
