"""XShards — the partitioned-data abstraction.

Copied from `analytics_zoo_tpu/data/shards.py` (L1-152): `XShards` (L24)
with `partition` (L35), the transforms, `_concat_rows` (L105), `len`,
`save_pickle` / `load_pickle` (L136-143) and `SparkXShards` (L152); the
`jax.tree_util` calls (L41, L53, L111-115, L129) are the port's
`common/tree.py`, and `partition`'s default shard count reads
`data/pipeline.process_topology` where the JAX package reads
`jax.process_count()` (L39).

TPU-native analogue of orca's `XShards`/`SparkXShards`
(`pyzoo/zoo/orca/data/shard.py:25,171`): a collection of data shards (pandas
DataFrames, numpy arrays, or `{"x": ..., "y": ...}` dicts) with functional
per-shard transforms. Where the reference partitions across Spark executors,
here shards map to *host input slices* feeding the device mesh: shard i of a
global batch lands on mesh batch-axis slice i (the
`jax.make_array_from_process_local_data` model). On a single host the shards
parallelize preprocessing via a process pool; across hosts each process owns
`len(shards) / process_count` shards.
"""

from __future__ import annotations

import concurrent.futures
import math
import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from analytics_zoo_tpu_torch.common.tree import tree_flatten, tree_unflatten


class XShards:
    """A list of in-memory shards with per-shard transforms
    (`shard.py:25` surface: transform_shard/collect/num_partitions)."""

    def __init__(self, shards: Sequence[Any]):
        if not shards:
            raise ValueError("XShards needs at least one shard")
        self.shards: List[Any] = list(shards)

    # -- construction ------------------------------------------------------
    @staticmethod
    def partition(data, num_shards: Optional[int] = None) -> "XShards":
        """Split ndarray / dict-of-ndarray / list into shards
        (`XShards.partition`, `shard.py:40`)."""
        from analytics_zoo_tpu_torch.data.pipeline import process_topology
        n_shards = num_shards or max(process_topology()[1], 1) * 2

        leaves, treedef = tree_flatten(data)
        if not leaves:
            raise ValueError("Cannot partition empty data")
        n = len(leaves[0])
        for l in leaves:
            if len(l) != n:
                raise ValueError("All arrays must share the leading dim")
        n_shards = min(n_shards, n)
        bounds = np.linspace(0, n, n_shards + 1, dtype=int)
        shards = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            shard_leaves = [np.asarray(l[lo:hi]) for l in leaves]
            shards.append(tree_unflatten(treedef, shard_leaves))
        return XShards(shards)

    # -- transforms --------------------------------------------------------
    def transform_shard(self, fn: Callable, *args,
                        parallel: bool = False) -> "XShards":
        """Apply fn to every shard (`SparkXShards.transform_shard`,
        `shard.py:185`). `parallel=True` uses a thread pool (numpy/pandas
        release the GIL for the heavy parts)."""
        if parallel and len(self.shards) > 1:
            with concurrent.futures.ThreadPoolExecutor() as ex:
                out = list(ex.map(lambda s: fn(s, *args), self.shards))
        else:
            out = [fn(s, *args) for s in self.shards]
        return XShards(out)

    def collect(self) -> List[Any]:
        return list(self.shards)

    def num_partitions(self) -> int:
        return len(self.shards)

    def repartition(self, num_partitions: int) -> "XShards":
        """Re-split preserving order (`shard.py` repartition). DataFrame
        shards keep their schema (row-range split, not pytree split)."""
        import pandas as pd
        rows = self._concat_rows()
        if isinstance(rows, pd.DataFrame):
            parts = np.array_split(np.arange(len(rows)), num_partitions)
            return XShards([rows.iloc[idx].reset_index(drop=True)
                            for idx in parts])
        return XShards.partition(rows, num_partitions)

    def partition_by(self, cols: str, num_partitions: Optional[int] = None
                     ) -> "XShards":
        """Hash-partition DataFrame shards by a column
        (`SparkXShards.partition_by`)."""
        import pandas as pd
        df = pd.concat(self.shards, ignore_index=True)
        n = num_partitions or self.num_partitions()
        codes = pd.util.hash_array(df[cols].to_numpy()) % n
        return XShards([df[codes == i].reset_index(drop=True)
                        for i in range(n)])

    def zip(self, other: "XShards") -> "XShards":
        """Pair shards elementwise (`SparkXShards.zip`); shard row counts
        must line up."""
        if self.num_partitions() != other.num_partitions():
            raise ValueError("zip needs equal partition counts")
        return XShards(list(zip(self.shards, other.shards)))

    # -- materialization ---------------------------------------------------
    def _concat_rows(self):
        import pandas as pd
        first = self.shards[0]
        if isinstance(first, pd.DataFrame):
            return pd.concat(self.shards, ignore_index=True)
        leaves_list = [tree_flatten(s)[0] for s in self.shards]
        treedef = tree_flatten(first)[1]
        merged = [np.concatenate([ls[i] for ls in leaves_list])
                  for i in range(len(leaves_list[0]))]
        return tree_unflatten(treedef, merged)

    def to_numpy(self):
        """Concatenate all shards into one structure."""
        return self._concat_rows()

    def len(self) -> int:
        import pandas as pd
        total = 0
        for s in self.shards:
            if isinstance(s, pd.DataFrame):
                total += len(s)
            else:
                leaves = tree_flatten(s)[0]
                total += len(leaves[0]) if leaves else 0
        return total

    __len__ = len

    # -- persistence (`XShards.save/load` pickle semantics) ---------------
    def save_pickle(self, path: str) -> "XShards":
        with open(path, "wb") as fh:
            pickle.dump(self.shards, fh)
        return self

    @staticmethod
    def load_pickle(path: str) -> "XShards":
        with open(path, "rb") as fh:
            return XShards(pickle.load(fh))

    def __repr__(self):
        return f"XShards({self.num_partitions()} partitions)"


# The reference's name for the concrete Spark-backed implementation; identical
# surface here (no Spark), kept for source compatibility.
SparkXShards = XShards
