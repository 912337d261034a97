"""Self-contained TensorBoard event writer (no TF dependency).

Copied from `analytics_zoo_tpu/utils/tensorboard.py` (`SummaryWriter`,
`write_metrics_snapshot`, `read_scalars`, `InferenceSummary`), on the
port's `utils/crc.masked_crc32c`. The reference ships its own TF-event
writer on the JVM (`zoo/.../tensorboard/FileWriter.scala:32`,
`EventWriter.scala`, `Summary.scala`) so training summaries work without
TensorFlow; this is the same idea in pure Python: hand-encoded
`Event`/`Summary` protobufs framed as TFRecords (length + masked-crc32c).
Readable by TensorBoard and by `read_scalars` (mirroring
`get_train_summary` read-back, `Topology.scala:224`); a file written by
either package reads in the other.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

from analytics_zoo_tpu_torch.utils.crc import crc32c  # noqa: F401 (re-export)
from analytics_zoo_tpu_torch.utils.crc import masked_crc32c as _masked_crc


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding
# ---------------------------------------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _pb_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _pb_int64(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _pb_string(field: int, value: str) -> bytes:
    return _pb_bytes(field, value.encode("utf-8"))


def _encode_event(wall_time: float, step: Optional[int] = None,
                  summary: Optional[bytes] = None,
                  file_version: Optional[str] = None) -> bytes:
    # Event: wall_time=1(double), step=2(int64), file_version=3(string),
    #        summary=5(message)
    out = _pb_double(1, wall_time)
    if step is not None:
        out += _pb_int64(2, step)
    if file_version is not None:
        out += _pb_string(3, file_version)
    if summary is not None:
        out += _pb_bytes(5, summary)
    return out


def _encode_scalar_summary(tag: str, value: float) -> bytes:
    # Summary.Value: tag=1(string), simple_value=2(float); Summary: value=1
    v = _pb_string(1, tag) + _pb_float(2, value)
    return _pb_bytes(1, v)


def _frame_record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header)) + data
            + struct.pack("<I", _masked_crc(data)))


# ---------------------------------------------------------------------------
# Writer / reader
# ---------------------------------------------------------------------------
class SummaryWriter:
    """`FileWriter.scala:32` equivalent: append scalar events to an
    `events.out.tfevents.*` file."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(log_dir, fname)
        self._fh = open(self.path, "ab")
        self._write_event(_encode_event(time.time(),
                                        file_version="brain.Event:2"))

    def _write_event(self, event: bytes):
        self._fh.write(_frame_record(event))
        self._fh.flush()

    def scalar(self, tag: str, value: float, step: int):
        summary = _encode_scalar_summary(tag, float(value))
        self._write_event(_encode_event(time.time(), step=step,
                                        summary=summary))

    def close(self):
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_metrics_snapshot(writer: "SummaryWriter",
                           snapshot: Dict[str, dict], step: int):
    """Mirror a `MetricsRegistry.snapshot()` into TensorBoard scalars:
    counters/gauges write their value, histograms write count/p50/p99.
    Label sets become tag suffixes (`serving_stage_ms/decode/p50`), so
    the TB run shows the same numbers a Prometheus scrape would."""
    for name, fam in snapshot.items():
        for s in fam.get("series", []):
            tag = name + "".join(
                f"/{v}" for _, v in sorted(s["labels"].items()))
            if fam["kind"] in ("counter", "gauge"):
                v = s["value"]
                if v == v:                       # skip NaN gauge reads
                    writer.scalar(tag, v, step)
            else:
                if not s["count"]:
                    continue
                writer.scalar(tag + "/count", s["count"], step)
                writer.scalar(tag + "/p50", s["p50"], step)
                writer.scalar(tag + "/p99", s["p99"], step)


def read_scalars(path_or_dir: str) -> Dict[str, List[Tuple[int, float]]]:
    """Read back scalars: tag -> [(step, value)]. Mirrors the reference's
    `FileReader` used by `get_train_summary`."""
    paths = []
    if os.path.isdir(path_or_dir):
        for f in sorted(os.listdir(path_or_dir)):
            if "tfevents" in f:
                paths.append(os.path.join(path_or_dir, f))
    else:
        paths = [path_or_dir]
    out: Dict[str, List[Tuple[int, float]]] = {}
    for p in paths:
        with open(p, "rb") as fh:
            data = fh.read()
        off = 0
        while off + 12 <= len(data):
            (length,) = struct.unpack_from("<Q", data, off)
            payload = data[off + 12:off + 12 + length]
            off += 12 + length + 4
            step, scalars = _decode_event(payload)
            for tag, value in scalars:
                out.setdefault(tag, []).append((step, value))
    return out


def _decode_event(buf: bytes) -> Tuple[int, List[Tuple[str, float]]]:
    step = 0
    scalars: List[Tuple[str, float]] = []
    for field, wire, value in _iter_fields(buf):
        if field == 2 and wire == 0:
            step = value
        elif field == 5 and wire == 2:
            for f2, w2, v2 in _iter_fields(value):
                if f2 == 1 and w2 == 2:  # Summary.Value
                    tag, sval = None, None
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode("utf-8", "replace")
                        elif f3 == 2 and w3 == 5:
                            (sval,) = struct.unpack("<f", v3)
                    if tag is not None and sval is not None:
                        scalars.append((tag, sval))
    return step, scalars


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, off = _read_varint(buf, off)
        elif wire == 1:
            value = buf[off:off + 8]
            off += 8
        elif wire == 5:
            value = buf[off:off + 4]
            off += 4
        elif wire == 2:
            length, off = _read_varint(buf, off)
            value = buf[off:off + length]
            off += length
        else:
            return
        yield field, wire, value


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


class InferenceSummary:
    """Serving-side TensorBoard summaries
    (`pipeline/inference/InferenceSummary.scala:24`): throughput and
    latency scalars written per serving window."""

    def __init__(self, log_dir: str, app_name: str = "serving"):
        self._writer = SummaryWriter(f"{log_dir.rstrip('/')}/{app_name}")
        self._step = 0

    def record(self, records: int, window_s: float,
               p50_ms: float = None, p99_ms: float = None):
        self._step += 1
        if window_s > 0:
            self._writer.scalar("Throughput", records / window_s,
                                self._step)
        if p50_ms is not None:
            self._writer.scalar("LatencyP50", p50_ms, self._step)
        if p99_ms is not None:
            self._writer.scalar("LatencyP99", p99_ms, self._step)

    def close(self):
        self._writer.close()
