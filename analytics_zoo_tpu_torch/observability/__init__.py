"""Unified observability layer: one metrics registry, one tracer, one
exposition path for serving AND training, plus the profiling layer that
makes the stack self-measuring.

Exports what `analytics_zoo_tpu/observability/__init__.py` (L26-64)
exports, from the port's modules:

- `MetricsRegistry` / `get_registry()` — labeled Counter/Gauge/Histogram
  families; the Histogram is the log-bucketed streaming histogram from
  `serving/timer.py`, generalized.
- `render_prometheus(registry)` — Prometheus 0.0.4 text, served by the
  HTTP frontend's `GET /metrics` under `Accept: text/plain`.
- `Tracer` — request-scoped spans with Chrome trace-event JSON export
  (Perfetto-viewable), threaded through the serving pipeline.
- `MetricsReporter` — periodic one-line digest thread (optionally
  evaluating an `SLOTracker` each report).
- `RooflineAccountant` / `cost_of` / `set_session_roofline` — hardware
  utilization (achieved TFLOP/s, MFU, HBM GB/s against the session
  roofline) from counted operator and kernel costs.
- `ProfileCapture` / `StackSampler` — bounded on-demand `torch.profiler`
  captures (`POST /profile`, `fit_keras(profile_steps=...)`) and a
  host-side stack-sampling profiler for the pipeline threads.
- `DeviceMemoryWatcher` / `leak_check` — per-device live/peak memory
  gauges and a leak assertion for tests.
- `SLOObjectives` / `SLOTracker` — declarative latency/availability
  objectives with burn-rate gauges and the `/healthz` readiness input.
"""

from analytics_zoo_tpu_torch.observability.capture import (
    CaptureActiveError, ProfileCapture, StackSampler, load_trace_events)
from analytics_zoo_tpu_torch.observability.memwatch import (
    DeviceMemoryLeak, DeviceMemoryWatcher, device_memory_snapshot,
    leak_check)
from analytics_zoo_tpu_torch.observability.prometheus import (
    CONTENT_TYPE, render_prometheus)
from analytics_zoo_tpu_torch.observability.registry import (
    Counter, Gauge, Histogram, LogHistogram, MetricsRegistry, get_registry)
from analytics_zoo_tpu_torch.observability.reporter import (MetricsReporter,
                                                            digest)
from analytics_zoo_tpu_torch.observability.roofline import (
    ExecCost, RooflineAccountant, cost_of, get_accountant, session_roofline,
    set_session_roofline)
from analytics_zoo_tpu_torch.observability.slo import (SLOObjectives,
                                                       SLOTracker)
from analytics_zoo_tpu_torch.observability.tracing import (Span, Tracer,
                                                           span_coverage,
                                                           span_from_dict,
                                                           span_to_dict)

__all__ = [
    "CONTENT_TYPE", "CaptureActiveError", "Counter", "DeviceMemoryLeak",
    "DeviceMemoryWatcher", "ExecCost", "Gauge", "Histogram",
    "LogHistogram", "MetricsRegistry", "MetricsReporter",
    "ProfileCapture", "RooflineAccountant", "SLOObjectives", "SLOTracker",
    "Span", "StackSampler", "Tracer", "cost_of", "device_memory_snapshot",
    "digest", "get_accountant", "get_registry", "leak_check",
    "load_trace_events", "render_prometheus", "session_roofline",
    "set_session_roofline", "span_coverage", "span_from_dict",
    "span_to_dict",
]
