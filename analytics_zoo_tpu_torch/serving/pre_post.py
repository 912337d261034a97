"""Serving pre/post processing parity pieces.

Copied from `analytics_zoo_tpu/serving/pre_post.py` as it is (L1-129): the
arrow codec (L24-53, `pyarrow` imported inside each function),
`decode_record_field` (L56), `record_meta` (L76), `decode_record_into`
(L90), `top_n` (L106), `format_top_n` (L115) and `apply_filter` (L122).
The ``image_b64`` payload decodes through the port's `data/image.py`
`load_image`.

Reference: `zoo/.../serving/preprocessing/PreProcessing.scala:127` (base64
image decode, arrow tensor decode), `postprocessing/PostProcessing.scala:174`
(top-N filter over class scores), `arrow/ArrowSerializer.scala:162` (tensor
(data, shape) arrow encoding).

The arrow codec uses pyarrow IPC with a two-column record batch
(data: float32 list, shape: int32 list) — the same logical layout the
reference serializes, readable from any arrow client.
"""

from __future__ import annotations

import base64
from typing import Dict, List, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# Arrow tensor codec (`ArrowSerializer.scala:162`)
# ---------------------------------------------------------------------------
def arrow_encode(arr: np.ndarray) -> bytes:
    import pyarrow as pa
    arr = np.ascontiguousarray(np.asarray(arr, np.float32))
    batch = pa.record_batch(
        [pa.array([arr.reshape(-1)], pa.list_(pa.float32())),
         pa.array([np.asarray(arr.shape, np.int32)],
                  pa.list_(pa.int32()))],
        names=["data", "shape"])
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as writer:
        writer.write_batch(batch)
    return sink.getvalue().to_pybytes()


def arrow_decode(blob: Union[bytes, str]) -> np.ndarray:
    import pyarrow as pa
    if isinstance(blob, str):
        blob = base64.b64decode(blob)
    with pa.ipc.open_stream(pa.BufferReader(blob)) as reader:
        batch = reader.read_next_batch()
    data = np.asarray(batch.column("data")[0].values, np.float32)
    shape = np.asarray(batch.column("shape")[0].values, np.int32)
    return data.reshape(tuple(shape))


def arrow_encode_b64(arr: np.ndarray) -> str:
    return base64.b64encode(arrow_encode(arr)).decode("ascii")


# ---------------------------------------------------------------------------
# PreProcessing (`PreProcessing.scala:127`)
# ---------------------------------------------------------------------------
def decode_record_field(value) -> np.ndarray:
    """Accept any of the serving payload encodings: the b64 raw codec dict
    (`broker.encode_ndarray`), an arrow blob ({"arrow": b64} dict or raw
    bytes), a b64 JPEG/PNG image ({"image_b64": ...}), or a nested list."""
    from analytics_zoo_tpu_torch.serving.broker import decode_ndarray
    if isinstance(value, dict):
        if "b64" in value:
            return decode_ndarray(value)
        if "arrow" in value:
            return arrow_decode(value["arrow"])
        if "image_b64" in value:
            from analytics_zoo_tpu_torch.data.image import load_image
            raw = base64.b64decode(value["image_b64"])
            return load_image(raw).astype(np.float32)
        raise ValueError(f"Unknown record encoding: {sorted(value)}")
    if isinstance(value, (bytes, bytearray)):
        return arrow_decode(bytes(value))
    return np.asarray(value, np.float32)


def record_meta(value) -> Union[Tuple[Tuple[int, ...], str], None]:
    """(shape, dtype) read off a raw-b64 codec HEADER without touching
    the payload — what lets the decode stage size its batch buffer
    before decoding a single record. None for codecs whose shape only a
    full decode reveals (arrow/image/list), which then take the
    decode-then-copy fallback."""
    if isinstance(value, dict) and "b64" in value:
        # np.dtype(...).str canonicalizes the spelling ('float32' and
        # '<f4' must group into the same batch buffer)
        return (tuple(int(s) for s in value.get("shape", ())),
                np.dtype(value.get("dtype", "float32")).str)
    return None


def decode_record_into(value, out_row: np.ndarray) -> None:
    """Decode a raw-b64 codec record DIRECTLY into `out_row` (one row of
    a preallocated batch buffer): the payload is viewed zero-copy via
    `np.frombuffer` and written ONCE into its final batch slot — the
    per-record `.copy()` of `broker.decode_ndarray` plus the separate
    np.stack pass the dispatch stage used to run both disappear from
    the hot path."""
    data = base64.b64decode(value["b64"])
    view = np.frombuffer(data, dtype=np.dtype(value["dtype"])).reshape(
        value["shape"])
    np.copyto(out_row, view)


# ---------------------------------------------------------------------------
# PostProcessing (`PostProcessing.scala:174`)
# ---------------------------------------------------------------------------
def top_n(pred: np.ndarray, n: int) -> List[Tuple[int, float]]:
    """Top-N (class_index, score) rows, highest first."""
    flat = np.asarray(pred).reshape(-1)
    n = min(n, flat.size)
    idx = np.argpartition(-flat, n - 1)[:n]
    idx = idx[np.argsort(-flat[idx])]
    return [(int(i), float(flat[i])) for i in idx]


def format_top_n(pred: np.ndarray, n: int) -> str:
    """The reference's serving result string: `[class:prob,...]`
    (PostProcessing topN output shape)."""
    rows = top_n(pred, n)
    return "[" + ",".join(f"{i}:{p:.8f}" for i, p in rows) + "]"


def apply_filter(pred: np.ndarray, filter_str: str):
    """Parse and apply a serving filter spec (`topN(5)` supported, matching
    the reference's filter grammar in PostProcessing.scala)."""
    filter_str = filter_str.strip()
    if filter_str.startswith("topN(") and filter_str.endswith(")"):
        n = int(filter_str[len("topN("):-1])
        return format_top_n(pred, n)
    raise ValueError(f"Unsupported serving filter: {filter_str!r}")
