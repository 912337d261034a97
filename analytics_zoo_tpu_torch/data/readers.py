"""File readers producing XShards — orca's `zoo.orca.data.pandas` surface.

Copied from `analytics_zoo_tpu/data/readers.py` as it is (L1-110):
`_expand` (L25), `_read_shards` (L39), `read_csv` (L47), `read_json`
(L61) and `read_parquet` (L73); pandas and pyarrow are imported inside
the calls.

`read_csv`/`read_json` mirror `orca/data/pandas/preprocessing.py:26-120`
(file-or-directory paths, per-file shards, pandas backend per the
`OrcaContext.pandas_read_backend` flag); `read_parquet` covers the parquet
image-dataset reader (`orca/data/image/parquet_dataset.py`). Each file (or
row-group) becomes one shard so preprocessing parallelizes like the
reference's per-partition reads — and the reads themselves run on the
shared input-pipeline worker pool (`data/pipeline.py`): a
64-file directory is 64 concurrent `pd.read_csv` calls instead of 64
sequential ones, results in deterministic file order, and a per-file
failure surfaces as ONE error naming the file. `pipeline_workers`
defaults to the environment's `ZOO_PIPELINE_WORKERS`.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, List, Optional, Sequence

from analytics_zoo_tpu_torch.data.shards import XShards


def _expand(file_path: str, extensions: Sequence[str]) -> List[str]:
    if os.path.isdir(file_path):
        files = sorted(
            f for f in glob.glob(os.path.join(file_path, "*"))
            if f.rsplit(".", 1)[-1].lower() in extensions)
    elif any(ch in file_path for ch in "*?["):
        files = sorted(glob.glob(file_path))
    else:
        files = [file_path]
    if not files:
        raise FileNotFoundError(f"No input files under {file_path}")
    return files


def _read_shards(files: List[str], read_one: Callable[[str], Any],
                 pipeline_workers: Optional[int],
                 label_fn: Callable[[Any], str] = str) -> List[Any]:
    from analytics_zoo_tpu_torch.data.pipeline import parallel_read
    return parallel_read(files, read_one, workers=pipeline_workers,
                         label_fn=label_fn)


def read_csv(file_path: str, num_shards: Optional[int] = None,
             pipeline_workers: Optional[int] = None, **kwargs) -> XShards:
    """Read csv file/dir/glob into XShards of pandas DataFrames
    (`zoo.orca.data.pandas.read_csv`), one concurrent read per file."""
    import pandas as pd
    files = _expand(file_path, ("csv",))
    shards = _read_shards(files, lambda f: pd.read_csv(f, **kwargs),
                          pipeline_workers)
    out = XShards(shards)
    if num_shards and num_shards != out.num_partitions():
        out = out.repartition(num_shards)
    return out


def read_json(file_path: str, num_shards: Optional[int] = None,
              pipeline_workers: Optional[int] = None, **kwargs) -> XShards:
    import pandas as pd
    files = _expand(file_path, ("json", "jsonl"))
    shards = _read_shards(files, lambda f: pd.read_json(f, **kwargs),
                          pipeline_workers)
    out = XShards(shards)
    if num_shards and num_shards != out.num_partitions():
        out = out.repartition(num_shards)
    return out


def read_parquet(file_path: str, columns: Optional[Sequence[str]] = None,
                 num_shards: Optional[int] = None,
                 pipeline_workers: Optional[int] = None) -> XShards:
    """Parquet → XShards, one shard per row-group/file
    (`orca/data/image/parquet_dataset.py` read side). Row-group
    metadata is listed sequentially (cheap footer reads), then the
    row-group DECODE — the expensive part — fans out over the worker
    pool with the (file, row-group) order preserved."""
    import threading

    import pyarrow.parquet as pq
    files = _expand(file_path, ("parquet", "pq"))
    units: List[tuple] = []
    for f in files:
        pf = pq.ParquetFile(f)
        units.extend((f, rg) for rg in range(pf.num_row_groups))

    # one footer parse per (file, thread), not per row-group: a
    # 1000-row-group file must not pay 1000 redundant metadata reads
    # (ParquetFile handles are not thread-safe, hence per-thread)
    tls = threading.local()

    def read_unit(unit):
        f, rg = unit
        cache = getattr(tls, "files", None)
        if cache is None:
            cache = tls.files = {}
        pf = cache.get(f)
        if pf is None:
            pf = cache[f] = pq.ParquetFile(f)
        return pf.read_row_group(rg, columns=columns).to_pandas()

    shards = _read_shards(units, read_unit, pipeline_workers,
                          label_fn=lambda u: f"{u[0]} row-group {u[1]}")
    out = XShards(shards)
    if num_shards and num_shards != out.num_partitions():
        out = out.repartition(num_shards)
    return out
