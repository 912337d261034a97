"""FeatureSet — cached training data with pluggable memory tiers.

Copied from `analytics_zoo_tpu/data/feature_set.py` (L1-215):
`FeatureSet` (L27) with its tiers, `take` (L74), the native disk tier
(`_native_loader` L89 on `data/native_loader.NativeBatchLoader`),
`close`, `iter_batches` (L152) and `to_dataset` (L200); the
`jax.tree_util` calls (L32-37, L76-87, L167-175) are the port's
`common/tree.py`.

The reference's `FeatureSet` (`zoo/.../feature/FeatureSet.scala:643`)
caches the training RDD in DRAM, PMEM (via a JNI memkind allocator,
`pmem/PersistentMemoryAllocator.java:37`), or DISK_AND_DRAM with a
configurable DRAM slice (`FeatureSet.scala:662-692`). The TPU-host analogue:

- DRAM        — plain numpy arrays in host RAM (default);
- DISK        — numpy memmaps spilled to a cache dir; the OS page cache is
                the "DRAM portion" (this also covers the PMEM tier: memkind
                PMEM is exactly a file-backed mmap on fsdax);
- DISK_AND_DRAM(n) — first `n` percent pinned in RAM, rest memmapped
                (`DISK_AND_DRAM.numSlice` semantics).

Shuffle is index-level per epoch (cheap) rather than data movement.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.common.tree import tree_flatten, tree_unflatten


class FeatureSet:
    def __init__(self, data, memory_type: str = "DRAM",
                 cache_dir: Optional[str] = None):
        """data: pytree of ndarrays with a shared leading dim (or an XShards
        of such)."""
        from analytics_zoo_tpu_torch.data.shards import XShards
        if isinstance(data, XShards):
            data = data.to_numpy()
        self.memory_type = memory_type.upper()
        leaves, self._treedef = tree_flatten(data)
        if not leaves:
            raise ValueError("Empty FeatureSet")
        self._n = len(leaves[0])
        dram_fraction = 1.0
        if self.memory_type.startswith("DISK_AND_DRAM"):
            # DISK_AND_DRAM(n) → n percent DRAM (numSlice analogue)
            inside = self.memory_type[len("DISK_AND_DRAM"):].strip("()")
            dram_fraction = (int(inside) / 100.0) if inside else 0.5
        elif self.memory_type == "DISK":
            dram_fraction = 0.0
        elif self.memory_type in ("DRAM", "PMEM"):
            dram_fraction = 1.0
        else:
            raise ValueError(f"Unsupported memory_type: {memory_type}")

        self._split = int(self._n * dram_fraction)
        if self._split < self._n:
            # always a fresh private subdir: two FeatureSets sharing a
            # cache_dir must not truncate each other's live memmaps
            self._cache_dir = tempfile.mkdtemp(
                prefix="zoo_featureset_", dir=cache_dir)
            self._leaves = []
            for i, leaf in enumerate(leaves):
                arr = np.asarray(leaf)
                head = arr[:self._split].copy()
                path = os.path.join(self._cache_dir, f"leaf_{i}.npy")
                np.save(path, arr[self._split:])
                tail = np.load(path, mmap_mode="r")
                self._leaves.append((head, tail))
        else:
            self._leaves = [(np.asarray(l), None) for l in leaves]

    # -- data access -------------------------------------------------------
    def __len__(self):
        return self._n

    def take(self, idx: np.ndarray):
        """Gather rows by (possibly shuffled) indices into a pytree batch."""
        out = []
        for head, tail in self._leaves:
            if tail is None:
                out.append(head[idx])
            else:
                in_head = idx < self._split
                rows = np.empty((len(idx),) + head.shape[1:], head.dtype)
                rows[in_head] = head[idx[in_head]]
                rows[~in_head] = tail[idx[~in_head] - self._split]
                out.append(rows)
        return tree_unflatten(self._treedef, out)

    def _native_loader(self, batch_size: int, drop_remainder: bool,
                       ordered: bool):
        """C++ threaded loader for this batch geometry. The dataset is
        packed ONCE per FeatureSet (streamed in chunks — never a full-RAM
        copy); per-geometry loaders share that file via mmap. `ordered`
        uses a single worker so batches arrive in index order (threaded
        delivery is completion-ordered)."""
        from analytics_zoo_tpu_torch.data import native_loader as nl
        if not nl.available():
            return None
        if getattr(self, "_packed", None) is None:
            # stream the (possibly memmapped) leaves: head then tail chunks
            class _Concat:
                def __init__(self, head, tail):
                    self.head, self.tail = head, tail
                    self.shape = (len(head) + len(tail),) + head.shape[1:]
                    self.dtype = head.dtype

                def __len__(self):
                    return self.shape[0]

                def __getitem__(self, sl):
                    lo, hi = sl.start or 0, sl.stop
                    h = len(self.head)
                    if hi <= h:
                        return self.head[lo:hi]
                    if lo >= h:
                        return self.tail[lo - h:hi - h]
                    return np.concatenate(
                        [self.head[lo:], self.tail[:hi - h]])

            leaves = [head if tail is None else _Concat(head, tail)
                      for head, tail in self._leaves]
            self._packed = nl.NativeBatchLoader.pack_file(
                leaves, cache_dir=getattr(self, "_cache_dir", None))
        path, n, specs = self._packed
        key = (batch_size, drop_remainder, ordered)
        cache = getattr(self, "_native_cache", None)
        if cache is None:
            cache = self._native_cache = {}
        if key not in cache:
            cache[key] = nl.NativeBatchLoader(
                path, n, specs, batch_size,
                n_threads=1 if ordered else 2,
                drop_remainder=drop_remainder)
        return cache[key]

    def close(self):
        """Release native loaders and the packed record file."""
        for loader in getattr(self, "_native_cache", {}).values():
            loader.close()
        self._native_cache = {}
        packed = getattr(self, "_packed", None)
        if packed is not None and os.path.exists(packed[0]):
            os.unlink(packed[0])
        self._packed = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def iter_batches(self, batch_size: int, shuffle: bool = True,
                     seed: int = 0, drop_remainder: bool = True,
                     native: Optional[bool] = None,
                     pipeline_workers: Optional[int] = None):
        """`native=None` auto-selects: spilled tiers go through the C++
        threaded loader (batch assembly off the GIL, overlapping the TPU
        step); DRAM stays on the numpy fast path. shuffle=False keeps the
        sequential-order contract (single-worker native delivery).
        `pipeline_workers` (default: env ZOO_PIPELINE_WORKERS) assembles
        the python-path batches on the shared input-pipeline worker pool
        instead: the per-epoch index
        permutation is fixed up front by `seed`, each index-batch
        gathers on a worker, and the reorder buffer emits batches in
        permutation order — identical batches at any worker count,
        bounded to `workers + 1` resident gathers."""
        if native is None:
            native = self._split < self._n
        if native:
            loader = self._native_loader(batch_size, drop_remainder,
                                         ordered=not shuffle)
            if loader is not None:
                for leaves in loader.iter_epoch(seed=seed, shuffle=shuffle):
                    yield tree_unflatten(self._treedef, leaves)
                return
        idx = np.arange(self._n)
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        nb = self._n // batch_size if drop_remainder \
            else -(-self._n // batch_size)
        sels = [idx[b * batch_size:(b + 1) * batch_size] for b in range(nb)]
        sels = [s for s in sels
                if len(s) == batch_size or not drop_remainder]
        from analytics_zoo_tpu_torch.data.pipeline import (ShardPipeline,
                                                           resolve_workers)
        workers = resolve_workers(pipeline_workers)
        if workers > 1 and len(sels) > 1:
            pipe = ShardPipeline(sels, lambda sel: [self.take(sel)],
                                 workers=workers,
                                 label_fn=lambda s: "featureset batch")
            try:
                yield from pipe.samples()
            finally:
                pipe.close()
            return
        for sel in sels:
            yield self.take(sel)

    def to_dataset(self, batch_size: int = -1, batch_per_thread: int = -1):
        """DRAM tier materializes; spilled tiers wrap lazily so the DISK
        design survives the dataset bridge (no full-RAM gather)."""
        from analytics_zoo_tpu_torch.data.dataset import (TPUDataset,
                                                          _FeatureSetDataset)
        if self._split == self._n:
            full = self.take(np.arange(self._n))
            if isinstance(full, dict) and "x" in full:
                return TPUDataset(full["x"], full.get("y"), batch_size,
                                  batch_per_thread)
            return TPUDataset(full, None, batch_size, batch_per_thread)
        return _FeatureSetDataset(self, batch_size, batch_per_thread)

    def __repr__(self):
        return (f"FeatureSet(n={self._n}, memory_type={self.memory_type}, "
                f"dram_rows={self._split})")
