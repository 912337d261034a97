"""Parquet dataset writer/readers for image-style records.

Copied from `analytics_zoo_tpu/data/parquet_dataset.py` as it is
(L1-177): `_NdarraySchema` / `SchemaField` (L21-30), `ParquetDataset`
(L33: `write`, `_decode_table`, `read_as_xshards`, `read_as_dataset`),
`write_ndarrays` (L140) and `write_mnist` (L153); pyarrow is imported
inside the calls.

Reference: `pyzoo/zoo/orca/data/image/parquet_dataset.py:30-186`
(ParquetDataset.write from a record generator + schema, read back as
XShards / tf.data / torch; `write_mnist`, `write_ndarrays` helpers).
Here pyarrow writes the blocks and the readers hand back XShards or a
TPUDataset.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data.shards import XShards


class _NdarraySchema:
    """Marks a field as an ndarray (stored as bytes + shape columns)."""

    def __init__(self, shape: Optional[Sequence[int]] = None,
                 dtype=np.float32):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = np.dtype(dtype)


SchemaField = _NdarraySchema  # public alias


class ParquetDataset:
    @staticmethod
    def write(path: str, generator: Iterable[Dict],
              schema: Dict[str, Any], block_size: int = 1000,
              write_mode: str = "overwrite"):
        """Write records from `generator` (dicts of field → value) into
        parquet blocks under `path`. ndarray-typed fields (schema value is
        a SchemaField) serialize as raw bytes + shape."""
        import pyarrow as pa
        import pyarrow.parquet as pq
        if os.path.exists(path):
            if write_mode == "overwrite":
                shutil.rmtree(path)
            elif write_mode == "error":
                raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)

        def flush(rows, idx):
            if not rows:
                return
            cols: Dict[str, list] = {}
            for r in rows:
                for k, v in r.items():
                    cols.setdefault(k, []).append(v)
            arrays, names = [], []
            for k, vals in cols.items():
                field_schema = schema.get(k)
                if isinstance(field_schema, _NdarraySchema):
                    # NOT ascontiguousarray: it promotes 0-d to (1,)
                    arrs = [np.asarray(v, field_schema.dtype)
                            for v in vals]
                    arrays.append(pa.array([a.tobytes() for a in arrs]))
                    names.append(k)
                    arrays.append(pa.array([list(a.shape) for a in arrs],
                                           pa.list_(pa.int32())))
                    names.append(k + "__shape")
                    arrays.append(pa.array(
                        [str(field_schema.dtype)] * len(arrs)))
                    names.append(k + "__dtype")
                else:
                    arrays.append(pa.array(vals))
                    names.append(k)
            table = pa.table(arrays, names=names)
            pq.write_table(table,
                           os.path.join(path, f"part-{idx:05d}.parquet"))

        rows, idx = [], 0
        for rec in generator:
            rows.append(rec)
            if len(rows) >= block_size:
                flush(rows, idx)
                rows, idx = [], idx + 1
        flush(rows, idx)
        return path

    @staticmethod
    def _decode_table(table) -> Dict[str, np.ndarray]:
        cols = table.column_names
        out: Dict[str, np.ndarray] = {}
        for name in cols:
            if name.endswith("__shape") or name.endswith("__dtype"):
                continue
            if name + "__shape" in cols:
                blobs = table.column(name).to_pylist()
                shapes = table.column(name + "__shape").to_pylist()
                dtypes = table.column(name + "__dtype").to_pylist()
                out[name] = np.stack([
                    np.frombuffer(b, dtype=np.dtype(d)).reshape(s)
                    for b, s, d in zip(blobs, shapes, dtypes)])
            else:
                out[name] = np.asarray(table.column(name).to_pylist())
        return out

    @staticmethod
    def read_as_xshards(path: str,
                        pipeline_workers: Optional[int] = None) -> XShards:
        """One shard per parquet block (`_read_as_xshards`). Blocks
        read+decode concurrently on the input-pipeline worker pool
        (shard order preserved; a bad part file raises one error
        naming it)."""
        import pyarrow.parquet as pq
        from analytics_zoo_tpu_torch.data.pipeline import parallel_read
        parts = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".parquet"))
        shards = parallel_read(
            parts, lambda p: ParquetDataset._decode_table(pq.read_table(p)),
            workers=pipeline_workers)
        return XShards(shards)

    @staticmethod
    def read_as_dataset(path: str, feature_col: str = "image",
                        label_col: Optional[str] = "label",
                        batch_size: int = -1, batch_per_thread: int = -1):
        """Straight to a TPUDataset (`read_as_tf` analogue)."""
        from analytics_zoo_tpu_torch.data.dataset import TPUDataset
        merged: Dict[str, list] = {}
        for shard in ParquetDataset.read_as_xshards(path).collect():
            for k, v in shard.items():
                merged.setdefault(k, []).append(v)
        data = {k: np.concatenate(v) for k, v in merged.items()}
        x = data[feature_col]
        y = data.get(label_col) if label_col else None
        return TPUDataset.from_ndarrays((x, y) if y is not None else x,
                                        batch_size, batch_per_thread)


def write_ndarrays(images: np.ndarray, labels: np.ndarray, output_path: str,
                   **kwargs) -> str:
    """`_write_ndarrays` (parquet_dataset.py:166)."""
    schema = {"image": _NdarraySchema(images.shape[1:], images.dtype),
              "label": _NdarraySchema(labels.shape[1:], labels.dtype)}

    def gen():
        for i in range(len(images)):
            yield {"image": images[i], "label": labels[i]}

    return ParquetDataset.write(output_path, gen(), schema, **kwargs)


def write_mnist(image_file: str, label_file: str, output_path: str,
                **kwargs) -> str:
    """IDX-format MNIST → parquet (`write_mnist`, parquet_dataset.py:186)."""
    import gzip

    def _open(p):
        return gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")

    def _read32(f):
        return int.from_bytes(f.read(4), "big")

    with _open(image_file) as f:
        magic = _read32(f)
        if magic != 2051:
            raise ValueError(f"Bad MNIST image magic {magic}")
        n, rows, cols = _read32(f), _read32(f), _read32(f)
        images = np.frombuffer(f.read(n * rows * cols), np.uint8).reshape(
            n, rows, cols, 1)
    with _open(label_file) as f:
        magic = _read32(f)
        if magic != 2049:
            raise ValueError(f"Bad MNIST label magic {magic}")
        n2 = _read32(f)
        labels = np.frombuffer(f.read(n2), np.uint8)
    return write_ndarrays(images, labels, output_path, **kwargs)
