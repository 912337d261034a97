"""TFRecord ingestion: wire-format reader/writer + tf.train.Example codec.

Copied from `analytics_zoo_tpu/data/tfrecord.py` as it is (L1-452): the
native scanner (`_native_lib` L57, `_raise_located` L96, `_native_scan`
L115), the framing (`TFRecordWriter` L148, `write_tfrecord` L172,
`_python_frame_walk` L181, `read_records` L230, `scan_index` L247,
`read_payloads_at` L268, `count_records` L278), the Example codec
(`decode_example` L349, `decode_example_batch` L357, `encode_example`
L394) and the corpus
helpers (`expand_files` L425, `iter_examples` L445). It runs on the
port's copies of `onnx/wire.py` and `utils/crc.py`; the scanner is the
repo's `native/tfrecord_scanner.cpp`, built by `data/native_loader.py`
into the port's build directory. One departure: the writer takes a
payload's CRC from the scanner's `tfr_crc32c` where the scanner is built
(`_payload_crc`; the same bytes, without the Python table's per-byte
loop), where the JAX writer runs the Python CRC.

The reference feeds training from TFRecord corpora through its TFDataset
family (`pyzoo/zoo/tfpark/tf_dataset.py:593` `from_tf_data_dataset`, `:911`
`TFBytesDataset`; the inception example trains from ImageNet TFRecords).
This module is the TPU-native path from a record-file corpus to the
trainer, with no tensorflow dependency:

- the TFRecord framing (little-endian u64 length, masked crc32c of the
  length, payload, masked crc32c of the payload) is decoded directly;
- `tf.train.Example` protobuf payloads are decoded with the same minimal
  wire codec the ONNX importer uses (`analytics_zoo_tpu/onnx/wire.py`) —
  the Example schema is tiny and frozen;
- `TPUDataset.from_tfrecord` (in `data/dataset.py`) streams shards through
  a shuffle buffer into the static-shape batch contract.

CRC32C (Castagnoli) is table-driven pure Python. Integrity checks default
to on for the 12-byte frame header (catches truncation/misalignment
cheaply) and off for payloads — pass `verify_payload=True` to check those
too.
"""

from __future__ import annotations

import glob as _glob
import os
import struct
from typing import (Any, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np

from analytics_zoo_tpu_torch.onnx import wire

from analytics_zoo_tpu_torch.utils.crc import crc32c, masked_crc32c  # noqa: F401

# ---------------------------------------------------------------------------
# Native fast path (`native/tfrecord_scanner.cpp`): frame walk + CRC32C at
# memory bandwidth; built on demand like the zoo_loader, python fallback
# when no compiler is present.
# ---------------------------------------------------------------------------
import ctypes as _ctypes
import logging as _logging
import threading as _threading

_log = _logging.getLogger("analytics_zoo_tpu_torch.tfrecord")
_NATIVE_NAME = "tfrecord_scanner"
_native = None
_native_lock = _threading.Lock()
_native_failed = False


def _native_lib():
    """Build (once) and load the scanner via the shared native-build
    contract (ZOO_DISABLE_NATIVE, stale-.so recovery); None → python
    fallback."""
    global _native, _native_failed
    if _native is not None or _native_failed:
        return _native
    with _native_lock:
        if _native is not None or _native_failed:
            return _native
        from analytics_zoo_tpu_torch.data.native_loader import (
            build_native_lib, native_paths)
        lib = build_native_lib(*native_paths(_NATIVE_NAME))
        if lib is None:
            _native_failed = True
            return None
        lib.tfr_scan.restype = _ctypes.c_long
        lib.tfr_scan.argtypes = [
            _ctypes.c_char_p, _ctypes.c_int,
            _ctypes.POINTER(_ctypes.c_int64),
            _ctypes.POINTER(_ctypes.c_int64), _ctypes.c_long]
        lib.tfr_count.restype = _ctypes.c_long
        lib.tfr_count.argtypes = [_ctypes.c_char_p]
        lib.tfr_crc32c.restype = _ctypes.c_uint32
        lib.tfr_crc32c.argtypes = [_ctypes.c_char_p, _ctypes.c_long]
        _native = lib
    return _native


_NATIVE_ERRORS = {
    -1: "cannot open/read",
    -2: "truncated record",
    -3: "corrupt record length CRC",
    -4: "record count grew during scan",
    -5: "corrupt record payload CRC",
}

# one pass covers files with up to 4M records (2 × 32 MB index arrays);
# only bigger corpora pay an extra exact-count pass
_SCAN_CAP = 1 << 22


def _raise_located(path: str, verify_payload: bool, code: int):
    """Turn a native scan error code into an actionable error NAMING
    THE OFFSET: re-walk the frames pythonically (error path only — the
    file is already known bad) so a torn tail or a flipped bit reports
    `file + byte offset` instead of a bare error code. If the python
    walk disagrees (file changed under us), fall back to the coded
    message."""
    try:
        for _ in _python_frame_walk(path, verify_payload,
                                    read_payloads=verify_payload):
            pass
    except ValueError:
        raise
    except Exception:  # noqa: BLE001 — diagnosis only; keep coded error
        pass
    raise ValueError(
        f"{path}: {_NATIVE_ERRORS.get(code, f'scan error {code}')}")


def _native_scan(path: str, verify_payload: bool):
    """Native frame walk → (offsets, lengths) numpy arrays, or None when
    the native path is unavailable."""
    lib = _native_lib()
    if lib is None:
        return None

    def scan(cap):
        offsets = np.empty(cap, np.int64)
        lengths = np.empty(cap, np.int64)
        n = lib.tfr_scan(
            path.encode(), int(verify_payload),
            offsets.ctypes.data_as(_ctypes.POINTER(_ctypes.c_int64)),
            lengths.ctypes.data_as(_ctypes.POINTER(_ctypes.c_int64)), cap)
        return n, offsets, lengths

    # bounded first pass; on overflow (huge corpus or a writer appending
    # between passes) retry once with the exact count
    cap = max(1, min(os.path.getsize(path) // 16, _SCAN_CAP))
    n, offsets, lengths = scan(cap)
    if n == -4:
        count = lib.tfr_count(path.encode())
        if count < 0:
            _raise_located(path, verify_payload, int(count))
        n, offsets, lengths = scan(max(1, int(count)))
    if n < 0:
        _raise_located(path, verify_payload, int(n))
    return offsets[:n], lengths[:n]


# shorter payloads stay on the Python table, where the ctypes call's
# fixed cost would outweigh the bytes
_NATIVE_CRC_MIN = 256


def _payload_crc(record: bytes) -> int:
    """`masked_crc32c(record)`, by the native scanner's `tfr_crc32c` where
    it is built (the same value, without the interpreter lock: writer
    threads run in parallel) and the record is long enough."""
    lib = _native_lib() if len(record) >= _NATIVE_CRC_MIN else None
    if lib is None:
        return masked_crc32c(record)
    return lib.tfr_crc32c(bytes(record), len(record))


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------
class TFRecordWriter:
    """Writes the TFRecord framing; records are arbitrary bytes."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", masked_crc32c(header)))
        self._fh.write(record)
        self._fh.write(struct.pack("<I", _payload_crc(record)))

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_tfrecord(path: str, records: Iterable[bytes]) -> int:
    with TFRecordWriter(path) as w:
        n = 0
        for r in records:
            w.write(r)
            n += 1
    return n


def _python_frame_walk(path: str, verify_payload: bool,
                       read_payloads: bool = True):
    """Pure-python frame walk yielding (record_offset, payload|None).
    Every integrity error names the file AND the byte offset of the
    torn/corrupt frame — a mid-stream failure must be actionable (which
    shard, where) rather than a bare 'truncated'. With
    `read_payloads=False` payloads are seeked over, not read (the
    count_records fast path)."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        pos = 0
        while pos < size:
            header = fh.read(8)
            if len(header) < 8:
                raise ValueError(
                    f"{path}: truncated record header at offset {pos} "
                    f"(file ends {size - pos} bytes into a frame)")
            (length,) = struct.unpack("<Q", header)
            len_crc_raw = fh.read(4)
            if len(len_crc_raw) < 4:
                raise ValueError(
                    f"{path}: truncated record header at offset {pos}")
            if struct.unpack("<I", len_crc_raw)[0] != masked_crc32c(header):
                raise ValueError(
                    f"{path}: corrupt record length CRC at offset {pos}")
            payload = None
            if read_payloads or verify_payload:
                payload = fh.read(length)
                got = len(payload)
            else:
                end = min(pos + 12 + length, size)
                fh.seek(end)
                got = end - pos - 12
            if got < length:
                raise ValueError(
                    f"{path}: truncated record payload at offset {pos} "
                    f"(payload needs {length} bytes, file has {got})")
            crc_raw = fh.read(4)
            if len(crc_raw) < 4:
                raise ValueError(
                    f"{path}: truncated record payload at offset {pos}")
            if verify_payload and struct.unpack("<I", crc_raw)[0] \
                    != masked_crc32c(payload):
                raise ValueError(
                    f"{path}: corrupt record payload CRC at offset {pos}")
            yield pos, payload, length
            pos += 12 + length + 4


def read_records(path: str, verify_payload: bool = False
                 ) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file. The 12-byte frame
    header CRC is always verified (cheap, catches corruption/misalignment
    immediately); payload CRC only under `verify_payload`. Uses the native
    C++ scanner when buildable (frame walk + CRC at memory bandwidth),
    python frame walk otherwise. Integrity errors name file + offset
    on both paths."""
    scanned = _native_scan(path, verify_payload)
    if scanned is not None:
        offsets, lengths = scanned
        yield from read_payloads_at(path, offsets, lengths)
        return
    for _pos, payload, _len in _python_frame_walk(path, verify_payload):
        yield payload


def scan_index(path: str, verify_payload: bool = False):
    """Header-only record index: (payload_offsets, payload_lengths)
    int64 arrays for every record in the file — what the sub-shard
    pipeline seeks by (`data/dataset.py` splits big files into bounded
    record ranges so a worker never holds more than a range, not the
    file). Native scan when buildable; python frame walk otherwise.
    Integrity errors name file + offset like every other entry point.
    With `verify_payload` the payload CRCs are checked during the scan
    (the later seek-reads trust the scanned index)."""
    scanned = _native_scan(path, verify_payload)
    if scanned is not None:
        return scanned
    offs: List[int] = []
    lens: List[int] = []
    for pos, _payload, length in _python_frame_walk(
            path, verify_payload, read_payloads=verify_payload):
        offs.append(pos + 12)
        lens.append(length)
    return np.asarray(offs, np.int64), np.asarray(lens, np.int64)


def read_payloads_at(path: str, offsets, lengths) -> Iterator[bytes]:
    """Yield payloads by (offset, length) pairs from a `scan_index` —
    the seek-read back half shared by `read_records`' native path and
    the sub-shard range reader."""
    with open(path, "rb") as fh:
        for off, ln in zip(offsets, lengths):
            fh.seek(int(off))
            yield fh.read(int(ln))


def count_records(path: str) -> int:
    """Count records by walking frame headers only (no payload decode).
    Header CRCs are verified and truncation detected, so a corrupt or
    non-TFRecord file raises here the same way `read_records` would."""
    lib = _native_lib()
    if lib is not None:
        n = lib.tfr_count(path.encode())
        if n < 0:
            _raise_located(path, False, int(n))
        return int(n)
    return sum(1 for _ in _python_frame_walk(path, False,
                                             read_payloads=False))


# ---------------------------------------------------------------------------
# tf.train.Example codec (schema frozen in tensorflow/core/example/*.proto)
# ---------------------------------------------------------------------------
_BYTES_LIST = {1: ("value", "bytes")}
_FLOAT_LIST = {1: ("value", "float")}
_INT64_LIST = {1: ("value", "varint")}
_FEATURE = {
    1: ("bytes_list", ("msg", _BYTES_LIST)),
    2: ("float_list", ("msg", _FLOAT_LIST)),
    3: ("int64_list", ("msg", _INT64_LIST)),
}
_MAP_ENTRY = {1: ("key", "string"), 2: ("value", ("msg", _FEATURE))}
_FEATURES = {1: ("feature", ("msg", _MAP_ENTRY))}
_EXAMPLE = {1: ("features", ("msg", _FEATURES))}

_U64 = 1 << 64
_I64_MAX = (1 << 63) - 1


def _raw_features(payload: bytes) -> Dict[str, Tuple[str, list]]:
    """Decode the Example wire message to {name: (kind, raw values)}
    without building per-feature numpy arrays — the shared front half
    of `decode_example` (per-sample arrays) and `decode_example_batch`
    (ONE array per feature column across the whole frame batch)."""
    msg = wire.decode(payload, _EXAMPLE)
    out: Dict[str, Tuple[str, list]] = {}
    for features in msg.get("features", []):
        for entry in features.get("feature", []):
            key = entry["key"][0]
            feat = entry["value"][0]
            if "bytes_list" in feat:
                out[key] = ("bytes",
                            list(feat["bytes_list"][0].get("value", [])))
            elif feat.get("float_list"):
                out[key] = ("float",
                            feat["float_list"][0].get("value", []))
            elif feat.get("int64_list"):
                out[key] = ("int", feat["int64_list"][0].get("value", []))
            else:  # empty feature of unknown kind
                out[key] = ("empty", [])
    return out


def _feature_array(kind: str, vals: list):
    """One feature's decoded value, matching the decode_example
    contract exactly (int64/float32 ndarrays, list of bytes)."""
    if kind == "bytes":
        return list(vals)
    if kind == "float":
        return np.asarray(vals, np.float32)
    if kind == "int":
        # stored unsigned; uint64→int64 bit view is exactly v - 2^64
        # for values past I64_MAX
        return np.asarray(vals, np.uint64).view(np.int64)
    return np.asarray([], np.float32)


def decode_example(payload: bytes) -> Dict[str, Any]:
    """tf.train.Example bytes → {name: np.ndarray | list[bytes]}.
    int64 features come back as int64 ndarrays, float features as float32
    ndarrays, bytes features as a list of bytes objects."""
    return {key: _feature_array(kind, vals)
            for key, (kind, vals) in _raw_features(payload).items()}


def decode_example_batch(payloads: Sequence[bytes]) -> List[Dict[str, Any]]:
    """Vectorized frame-batch decode: decode a BATCH of
    `tf.train.Example` payloads into per-sample dicts whose arrays are
    rows of ONE `(B, n)` array per feature column — one numpy
    construction per (feature, batch) instead of one per (feature,
    record), and the int64 sign fixup becomes a single uint64→int64
    bit view over the whole column instead of a per-value python
    branch. Columns that are ragged across the batch (or missing from
    some records) fall back to the per-sample build. Values are
    bitwise-identical to `decode_example` per record — parity-tested."""
    raws = [_raw_features(p) for p in payloads]
    n = len(raws)
    if n == 0:
        return []
    out: List[Dict[str, Any]] = [{} for _ in range(n)]
    for key in list(raws[0]):
        col = [r.get(key) for r in raws]
        kind, width = col[0][0], len(col[0][1])
        uniform = kind in ("float", "int") and width > 0 and all(
            c is not None and c[0] == kind and len(c[1]) == width
            for c in col)
        if uniform:
            vals = [c[1] for c in col]
            if kind == "float":
                stacked = np.asarray(vals, np.float32)
            else:
                stacked = np.asarray(vals, np.uint64).view(np.int64)
            for i in range(n):
                out[i][key] = stacked[i]
            for r in raws:
                r.pop(key, None)
    for i, r in enumerate(raws):     # non-uniform / leftover features
        for key, (kind, vals) in r.items():
            out[i][key] = _feature_array(kind, vals)
    return out


def encode_example(features: Dict[str, Any]) -> bytes:
    """{name: value} → tf.train.Example bytes. Value kinds: bytes/str (or
    lists of them) → bytes_list; float arrays → float_list; int arrays →
    int64_list."""
    entries = []
    for key, value in features.items():
        if isinstance(value, (bytes, str)):
            feat = {"bytes_list": {"value": [
                value.encode() if isinstance(value, str) else value]}}
        elif isinstance(value, (list, tuple)) and value \
                and isinstance(value[0], (bytes, str)):
            feat = {"bytes_list": {"value": [
                v.encode() if isinstance(v, str) else v for v in value]}}
        else:
            arr = np.asarray(value)
            flat = arr.ravel()
            if np.issubdtype(arr.dtype, np.integer):
                feat = {"int64_list": {"value": [
                    int(v) + _U64 if v < 0 else int(v) for v in flat]}}
            elif np.issubdtype(arr.dtype, np.floating):
                feat = {"float_list": {"value": [float(v) for v in flat]}}
            else:
                raise TypeError(
                    f"Feature {key!r}: unsupported dtype {arr.dtype}")
        entries.append({"key": [key], "value": [feat]})
    return wire.encode({"features": [{"feature": entries}]}, _EXAMPLE)


# ---------------------------------------------------------------------------
# Corpus helpers
# ---------------------------------------------------------------------------
def expand_files(paths) -> List[str]:
    """Glob pattern / directory / explicit list → sorted file list. An
    explicitly-listed path that doesn't exist raises (a typo'd shard must
    not silently train on a partial corpus)."""
    if isinstance(paths, str):
        if os.path.isdir(paths):
            paths = sorted(
                os.path.join(paths, f) for f in os.listdir(paths)
                if not f.startswith("."))
        else:
            paths = sorted(_glob.glob(paths)) or [paths]
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing:
        raise FileNotFoundError(
            f"TFRecord shard(s) not found: {missing!r}")
    if not paths:
        raise FileNotFoundError("Empty TFRecord file list")
    return list(paths)


def iter_examples(paths, parse_fn=None, verify_payload: bool = False
                  ) -> Iterator[Any]:
    """Stream decoded Examples (or `parse_fn(example_dict)` results) across
    a shard list in order."""
    for path in expand_files(paths):
        for payload in read_records(path, verify_payload=verify_payload):
            ex = decode_example(payload)
            yield parse_fn(ex) if parse_fn is not None else ex
