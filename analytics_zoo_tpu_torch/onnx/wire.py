"""Minimal protobuf wire-format decoder for ONNX ModelProto.

Copied from `analytics_zoo_tpu/onnx/wire.py` as it is (L1-234): the
schema-driven `decode` and `encode` that the TFRecord Example codec
(`data/tfrecord.py`) runs on. The ONNX loader itself is not ported
(ROADMAP.md queue 1, item 8).

The environment carries no `onnx` package, so the loader decodes the wire
format directly against a hand-written schema of the (stable, frozen)
field numbers from onnx.proto. Only what the op mapper needs is modelled;
unknown fields are skipped per the protobuf spec, so models produced by any
exporter remain readable.

Schema entries: {field_number: (name, kind)} with kind one of
  "varint"   — int (also used for enums/bools; zigzag not needed for ONNX)
  "float"    — 32-bit float (wire type 5)
  "double"   — 64-bit float (wire type 1)
  "bytes"    — raw bytes
  "string"   — utf-8 string
  ("msg", schema) — nested message decoded recursively
Repeated fields simply accumulate into lists (the decoder always returns
lists; callers take [0] for singular fields). Packed repeated numerics are
detected by wire type 2 on a numeric kind.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def decode(buf, schema: Dict[int, Tuple[str, Any]]) -> Dict[str, List]:
    """Decode one message; returns {field_name: [values...]}."""
    buf = memoryview(buf)
    out: Dict[str, List] = {}
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field_no = tag >> 3
        wire_type = tag & 7
        entry = schema.get(field_no)

        if wire_type == 0:
            val, pos = _read_varint(buf, pos)
            if entry is not None:
                out.setdefault(entry[0], []).append(val)
        elif wire_type == 1:
            raw = bytes(buf[pos:pos + 8])
            pos += 8
            if entry is not None:
                out.setdefault(entry[0], []).append(
                    struct.unpack("<d", raw)[0]
                    if entry[1] == "double" else
                    int.from_bytes(raw, "little"))
        elif wire_type == 5:
            raw = bytes(buf[pos:pos + 4])
            pos += 4
            if entry is not None:
                out.setdefault(entry[0], []).append(
                    struct.unpack("<f", raw)[0]
                    if entry[1] == "float" else
                    int.from_bytes(raw, "little"))
        elif wire_type == 2:
            length, pos = _read_varint(buf, pos)
            chunk = buf[pos:pos + length]
            pos += length
            if entry is None:
                continue
            name, kind = entry
            if kind == "bytes":
                out.setdefault(name, []).append(bytes(chunk))
            elif kind == "string":
                out.setdefault(name, []).append(
                    bytes(chunk).decode("utf-8", "replace"))
            elif kind == "varint":                    # packed ints
                vals = []
                p = 0
                while p < len(chunk):
                    v, p = _read_varint(chunk, p)
                    vals.append(v)
                out.setdefault(name, []).extend(vals)
            elif kind == "float":                     # packed floats
                n = len(chunk) // 4
                out.setdefault(name, []).extend(
                    struct.unpack(f"<{n}f", bytes(chunk)))
            elif kind == "double":
                n = len(chunk) // 8
                out.setdefault(name, []).extend(
                    struct.unpack(f"<{n}d", bytes(chunk)))
            elif isinstance(kind, tuple) and kind[0] == "msg":
                out.setdefault(name, []).append(decode(chunk, kind[1]))
            else:
                raise ValueError(f"Bad schema kind for field {field_no}")
        else:
            raise ValueError(f"Unsupported wire type {wire_type}")
    return out


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def encode(msg: Dict[str, Any], schema: Dict[int, Tuple[str, Any]]) -> bytes:
    """Inverse of `decode`: {field_name: [values...]} → wire bytes. Used by
    the test fixtures (the environment has no onnx package to produce
    reference files) and by `save_onnx`-style exports."""
    by_name = {name: (no, kind) for no, (name, kind) in schema.items()}
    out = bytearray()
    for name, values in msg.items():
        if name not in by_name:
            raise KeyError(f"Field {name!r} not in schema")
        field_no, kind = by_name[name]
        if not isinstance(values, (list, tuple)):
            values = [values]
        for v in values:
            if kind == "varint":
                _write_varint(out, field_no << 3 | 0)
                _write_varint(out, int(v))
            elif kind == "float":
                _write_varint(out, field_no << 3 | 5)
                out += struct.pack("<f", float(v))
            elif kind == "double":
                _write_varint(out, field_no << 3 | 1)
                out += struct.pack("<d", float(v))
            elif kind in ("bytes", "string"):
                data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
                _write_varint(out, field_no << 3 | 2)
                _write_varint(out, len(data))
                out += data
            elif isinstance(kind, tuple) and kind[0] == "msg":
                data = encode(v, kind[1])
                _write_varint(out, field_no << 3 | 2)
                _write_varint(out, len(data))
                out += data
            else:
                raise ValueError(f"Bad schema kind for field {name!r}")
    return bytes(out)


# ---------------------------------------------------------------------------
# ONNX schemas (field numbers from onnx/onnx.proto, frozen by the spec)
# ---------------------------------------------------------------------------
TENSOR = {
    1: ("dims", "varint"),
    2: ("data_type", "varint"),
    4: ("float_data", "float"),
    5: ("int32_data", "varint"),
    7: ("int64_data", "varint"),
    8: ("name", "string"),
    9: ("raw_data", "bytes"),
    10: ("double_data", "double"),
}

ATTRIBUTE: Dict[int, Tuple[str, Any]] = {
    1: ("name", "string"),
    2: ("f", "float"),
    3: ("i", "varint"),
    4: ("s", "bytes"),
    5: ("t", ("msg", TENSOR)),
    7: ("floats", "float"),
    8: ("ints", "varint"),
    9: ("strings", "bytes"),
    20: ("type", "varint"),
}

NODE = {
    1: ("input", "string"),
    2: ("output", "string"),
    3: ("name", "string"),
    4: ("op_type", "string"),
    5: ("attribute", ("msg", ATTRIBUTE)),
    7: ("domain", "string"),
}

DIM = {
    1: ("dim_value", "varint"),
    2: ("dim_param", "string"),
}

TENSOR_SHAPE = {
    1: ("dim", ("msg", DIM)),
}

TENSOR_TYPE = {
    1: ("elem_type", "varint"),
    2: ("shape", ("msg", TENSOR_SHAPE)),
}

TYPE = {
    1: ("tensor_type", ("msg", TENSOR_TYPE)),
}

VALUE_INFO = {
    1: ("name", "string"),
    2: ("type", ("msg", TYPE)),
}

GRAPH = {
    1: ("node", ("msg", NODE)),
    2: ("name", "string"),
    5: ("initializer", ("msg", TENSOR)),
    11: ("input", ("msg", VALUE_INFO)),
    12: ("output", ("msg", VALUE_INFO)),
    13: ("value_info", ("msg", VALUE_INFO)),
}

OPERATOR_SET_ID = {
    1: ("domain", "string"),
    2: ("version", "varint"),
}

MODEL = {
    1: ("ir_version", "varint"),
    2: ("producer_name", "string"),
    7: ("graph", ("msg", GRAPH)),
    8: ("opset_import", ("msg", OPERATOR_SET_ID)),
}
