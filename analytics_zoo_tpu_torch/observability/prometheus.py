"""Prometheus text-format (0.0.4) exposition for a `MetricsRegistry`.

Copied from `analytics_zoo_tpu/observability/prometheus.py` as it is (the
JAX package's HTTP frontend serves it at `GET /metrics` under
`Accept: text/plain`; the port has no HTTP frontend yet). Rendering rules:

- `# HELP` / `# TYPE` per family, series lines `name{label="v"} value`.
- Counters/gauges render their value directly.
- Histograms render the Prometheus cumulative-bucket triplet:
  `name_bucket{le="<upper>"}` for every NON-EMPTY log bucket (the
  geometry has 107 buckets; emitting only occupied ones keeps scrape
  payloads proportional to observed spread, and cumulative counts stay
  valid on any bucket subset as long as `+Inf` closes the series),
  plus `name_sum` and `name_count`.

Label values escape `\\`, `"` and newlines per the exposition spec.
"""

from __future__ import annotations

from typing import Dict, List

from analytics_zoo_tpu_torch.observability.registry import (
    Counter, Gauge, Histogram, MetricsRegistry)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def render_prometheus(registry: MetricsRegistry) -> str:
    """The full registry as Prometheus 0.0.4 text. Ends with the
    spec-required trailing newline."""
    lines: List[str] = []
    for fam in registry.families():
        help_text = _escape(fam.description) if fam.description else fam.name
        lines.append(f"# HELP {fam.name} {help_text}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        if isinstance(fam, (Counter, Gauge)):
            for s in fam._series_snapshot():
                lines.append(f"{fam.name}{_fmt_labels(s['labels'])} "
                             f"{_fmt_value(s['value'])}")
        elif isinstance(fam, Histogram):
            for key in fam.label_keys():
                labels = dict(key)
                # freeze bucket counts under the family lock so the
                # cumulative series can't go non-monotonic mid-render
                with fam._lock:
                    h = fam._series[key]
                    counts = list(h.counts)
                    total, count = h.total, h.count
                    uppers = [h.bucket_upper(i) for i in range(len(counts))]
                cum = 0
                for i, c in enumerate(counts):
                    if not c:
                        continue
                    cum += c
                    le = 'le="%s"' % _fmt_value(uppers[i])
                    lines.append(f"{fam.name}_bucket"
                                 f"{_fmt_labels(labels, le)} {cum}")
                inf = 'le="+Inf"'
                lines.append(f"{fam.name}_bucket"
                             f"{_fmt_labels(labels, inf)} {count}")
                lines.append(f"{fam.name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(total)}")
                lines.append(f"{fam.name}_count{_fmt_labels(labels)} "
                             f"{count}")
    return "\n".join(lines) + "\n"
