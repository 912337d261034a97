"""tf.data-style Dataset API over XShards.

Copied from `analytics_zoo_tpu/data/tf_style.py` (L1-55): `Dataset` (L18),
its `_apply` (L38) on the port's `common/tree.py` in place of
`jax.tree_util`.

Reference: `pyzoo/zoo/orca/data/tf/data.py:124-221` — `Dataset` wraps
XShards with lazily-composed per-shard transforms (`from_tensor_slices`,
`map`), consumed by the estimators. Here the composed pipeline resolves to
a TPUDataset at fit/predict time.
"""

from __future__ import annotations

from typing import Callable

from analytics_zoo_tpu_torch.common.tree import stack_trees, tree_flatten
from analytics_zoo_tpu_torch.data.shards import XShards


class Dataset:
    """Lazy per-element transform pipeline over sharded data."""

    def __init__(self, xshards: XShards, transforms=None):
        self.xshards = xshards
        self.transforms = list(transforms or [])

    @staticmethod
    def from_tensor_slices(xshards: XShards) -> "Dataset":
        """`Dataset.from_tensor_slices` (data.py:190): elements are rows of
        the shards' arrays/dicts/tuples."""
        if not isinstance(xshards, XShards):
            xshards = XShards.partition(xshards)
        return Dataset(xshards)

    def map(self, map_func: Callable) -> "Dataset":
        """`map` (data.py:193): per-element transform, applied lazily."""
        return Dataset(self.xshards, self.transforms + [map_func])

    # -- materialization ---------------------------------------------------
    def _apply(self, shard):
        leaves, treedef = tree_flatten(shard)
        rows = []
        for i in range(len(leaves[0])):
            row = treedef.unflatten([a[i] for a in leaves])
            for fn in self.transforms:
                row = fn(row)
            rows.append(row)
        return stack_trees(rows)

    def to_xshards(self) -> XShards:
        return self.xshards.transform_shard(self._apply)

    def to_dataset(self, batch_size: int = -1, batch_per_thread: int = -1):
        from analytics_zoo_tpu_torch.data.dataset import TPUDataset
        return TPUDataset.from_xshards(self.to_xshards(), batch_size,
                                       batch_per_thread)
