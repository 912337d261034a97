"""Pytree artifacts in the JAX package's on-disk format.

Port of the part of `analytics_zoo_tpu/learn/checkpoint.py` that model
persistence needs: `CorruptCheckpointError` (L40), `_walk` (L86),
`save_pytree` (L108), `_struct_path` (L146), `load_pytree` (L170) and
`_insert` (L206). An artifact is a numpy `.npz` of the tree's leaves
(`leaf_<i>`) and a `.structure.json` sidecar of every node's path, with
empty containers kept (a parameterless layer's `{}` survives the round
trip). Writes go to a same-directory temporary file that is renamed into
place, the npz first and the sidecar last: the sidecar records the npz's
CRC32C (`utils/crc.py`) and byte count, so it is the commit marker, and
`load_pytree` refuses torn bytes with `CorruptCheckpointError`. A tree
written by either package loads in the other.

The leaves are numpy arrays (a tensor is copied to the host first;
bfloat16 as float32, which numpy lacks). Training checkpoints, their
version directories, auto-resume and `model_dir` are not ported yet
(ROADMAP.md queue 1, 'The rest of training').
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, List

import numpy as np
import torch

from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.utils.crc import crc32c


class CorruptCheckpointError(RuntimeError):
    """A checkpoint artifact failed its integrity check (missing
    sidecar, truncated npz, CRC mismatch)."""


def _host_leaf(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _walk(tree: Any, path: List[List[Any]], paths: List[Any],
          leaves: List[np.ndarray]) -> None:
    """Record every node: leaves carry data; empty containers carry a marker
    so parameterless layers ({} in params) survive the round trip."""
    if isinstance(tree, dict):
        if not tree:
            paths.append({"path": path, "empty": "dict"})
            return
        for k in tree:  # insertion order
            _walk(tree[k], path + [["k", k]], paths, leaves)
    elif isinstance(tree, (list, tuple)):
        if not tree:
            paths.append({"path": path, "empty": "list"})
            return
        for i, v in enumerate(tree):
            _walk(v, path + [["i", i]], paths, leaves)
    else:
        paths.append({"path": path, "leaf": len(leaves)})
        leaves.append(_host_leaf(tree))


def save_pytree(path: str, tree: Any) -> None:
    """Write a pytree to `<path>` (npz + structure json), atomically: both
    files go through write-temp-then-rename, the npz first and the
    CRC-bearing sidecar last (the commit marker)."""
    paths: List[Any] = []
    leaves: List[np.ndarray] = []
    _walk(tree, [], paths, leaves)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    flat = {f"leaf_{i}": l for i, l in enumerate(leaves)}
    npz_path = path if path.endswith(".npz") else path + ".npz"
    tmp_npz = npz_path + f".tmp-{os.getpid()}"
    tmp_struct = _struct_path(path) + f".tmp-{os.getpid()}"
    try:
        with open(tmp_npz, "wb") as fh:
            np.savez(fh, **flat)
        # the CRC of the bytes on disk, read back before the commit point:
        # a crash or a truncation between here and the rename leaves an
        # artifact whose CRC cannot match
        with open(tmp_npz, "rb") as fh:
            crc = crc32c(fh.read())
        nbytes = os.path.getsize(tmp_npz)
        faults.fire("checkpoint.write", path=tmp_npz)
        os.replace(tmp_npz, npz_path)
        with open(tmp_struct, "w") as fh:
            json.dump({"nodes": paths, "npz_crc32c": crc,
                       "npz_bytes": nbytes}, fh)
        os.replace(tmp_struct, _struct_path(path))
    except BaseException:
        for tmp in (tmp_npz, tmp_struct):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise


def _struct_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".structure.json"


def load_pytree(path: str, verify: bool = True) -> Any:
    """Load a pytree written by `save_pytree` (of either package): nested
    dicts and lists (tuples come back as lists) of numpy arrays. With
    `verify` the npz's recorded CRC and size are checked against one read
    of its bytes, which `np.load` then parses; a mismatch raises
    `CorruptCheckpointError`."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    with open(_struct_path(path)) as fh:
        meta = json.load(fh)
    if verify and "npz_crc32c" in meta:
        with open(npz_path, "rb") as fh:
            raw = fh.read()
        if len(raw) != meta.get("npz_bytes") \
                or crc32c(raw) != meta["npz_crc32c"]:
            raise CorruptCheckpointError(
                f"checkpoint artifact {path} is corrupt or truncated")
        npz = np.load(io.BytesIO(raw))
    else:
        npz = np.load(npz_path)
    root: Any = None
    for node in meta["nodes"]:
        if "leaf" in node:
            value: Any = npz[f"leaf_{node['leaf']}"]
        else:
            value = {} if node["empty"] == "dict" else []
        root = _insert(root, node["path"], value)
    return root if root is not None else {}


def _insert(root, parts, value):
    if not parts:
        return value
    kind, key = parts[0]
    if kind == "i":
        key = int(key)
        if root is None:
            root = []
        while len(root) <= key:
            root.append(None)
        root[key] = _insert(root[key], parts[1:], value)
        return root
    if root is None:
        root = {}
    root[key] = _insert(root.get(key), parts[1:], value)
    return root
