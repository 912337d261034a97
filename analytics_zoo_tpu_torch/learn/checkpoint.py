"""Pytree artifacts and training checkpoints in the JAX package's on-disk
format.

Port of `analytics_zoo_tpu/learn/checkpoint.py`: `gather_leaf` (L49),
which gathers a leaf sharded over the mesh's fsdp axis (this rank's
block along a dim) into the whole array, a collective of the axis where
the JAX function assembles a sharded `jax.Array` (the trainer gathers a
sharded fit's whole state with its `ShardLayout`, and only rank 0 writes
and publishes); `CorruptCheckpointError` (L40), `_walk` (L86), `save_pytree` (L108),
`_struct_path` (L146), `verify_pytree` (L151), `load_pytree` (L170),
`_insert` (L206), `CheckpointManager` (L225), `list_checkpoints` (L281),
`checkpoint_intact` (L300), `latest_checkpoint` (L313),
`read_checkpoint_meta` (L329), `find_resume_checkpoint` (L340), the
publish markers (`write_publish_marker` L377, `read_publish_marker`,
`verify_publish_marker`, `_publish_stat_key`, `published_intact`,
`latest_published_checkpoint`, L443-555), `resolve_checkpoint` (L556),
`load_checkpoint` (L579) and `restore_opt_state` (L608). `save_pytree`
takes an optimizer state's records (tuples) and tensors as they are, so
the JAX package's `_optstate_to_tree` (L600), a host gather, has no
counterpart.

An artifact is a numpy `.npz` of the tree's leaves
(`leaf_<i>`) and a `.structure.json` sidecar of every node's path, with
empty containers kept (a parameterless layer's `{}` survives the round
trip). Writes go to a same-directory temporary file that is renamed into
place, the npz first and the sidecar last: the sidecar records the npz's
CRC32C (`utils/crc.py`) and byte count, so it is the commit marker, and
`load_pytree` refuses torn bytes with `CorruptCheckpointError`. A tree
written by either package loads in the other.

The leaves are numpy arrays (a tensor is copied to the host first;
bfloat16 as float32, which numpy lacks). A None leaf (a table's place in
the lazy-embedding optimizer state) is written as an empty node and loads
as `{}`, which holds no leaf in either package; the JAX package writes it
as an object array that neither package can load back.

A training checkpoint is the reference's layout
(`InternalDistriOptimizer` + `tf_optimizer.py:398-413`):

    <ckptDir>/<yyyyMMdd_HHmmss>/model.<iteration>{.npz,.structure.json}
    <ckptDir>/<yyyyMMdd_HHmmss>/model.<iteration>.meta.json
    <ckptDir>/<yyyyMMdd_HHmmss>/optimMethod-<name>.<iteration>{...}
    <ckptDir>/<yyyyMMdd_HHmmss>/model.<iteration>.published.json

with the JAX package's file names and meta keys (`epoch`, `iteration`,
`epoch_finished`, `opt_state_layout`, `emergency`), so a directory written
by either package resumes in the other. The model tree is the JAX
parameter tree (`convert.model_params_to_jax`); the optimizer tree is the
optax state layout (`convert.opt_layout_to_jax`). The set commits in
order: optimizer artifact and meta first, the model artifact last (the
set's commit marker), and the publish marker after every artifact. The
run directory's stamp has one-second resolution: two managers started in
the same second share a directory, in the JAX package too.
"""

from __future__ import annotations

import datetime
import io
import json
import logging
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.utils.crc import crc32c

log = logging.getLogger("analytics_zoo_tpu_torch.checkpoint")


class CorruptCheckpointError(RuntimeError):
    """A checkpoint artifact failed its integrity check (missing
    sidecar, truncated npz, CRC mismatch)."""


def _host_leaf(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def gather_leaf(a: Any, mesh=None, dim: Optional[int] = None) -> np.ndarray:
    """Host copy of one checkpoint leaf. A tensor that is this rank's
    block, along `dim`, of a leaf sharded over `mesh`'s fsdp axis is
    gathered whole first (a collective: every rank of the axis calls it);
    a replicated tensor, a numpy array or a scalar converts as it is."""
    if isinstance(a, torch.Tensor) and mesh is not None and dim is not None:
        a = mesh.all_gather(a, "fsdp", dim=dim)
    return _host_leaf(a)


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
    elif tree is None:
        paths.append({"path": path, "empty": "dict"})
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


def verify_pytree(path: str) -> bool:
    """True when `<path>` is a complete, CRC-intact artifact. Legacy
    artifacts without a recorded CRC pass on existence alone."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    try:
        with open(_struct_path(path)) as fh:
            meta = json.load(fh)
        if not os.path.exists(npz_path):
            return False
        if "npz_crc32c" not in meta:
            return True
        if os.path.getsize(npz_path) != meta.get("npz_bytes"):
            return False
        with open(npz_path, "rb") as fh:
            return crc32c(fh.read()) == meta["npz_crc32c"]
    except (OSError, ValueError):
        return False


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


# ---------------------------------------------------------------------------
# Reference-layout training checkpoints
# ---------------------------------------------------------------------------
_STAMP_FMT = "%Y%m%d_%H%M%S"


class CheckpointManager:
    """Writes `model.<iter>` + `optimMethod-<name>.<iter>` into a
    timestamped subdir (created once per training run,
    `Topology.scala:1245-1252`)."""

    def __init__(self, root: str, optim_name: str = "default", keep: int = 3):
        self.root = root
        self.optim_name = optim_name
        self.keep = keep
        stamp = datetime.datetime.now().strftime(_STAMP_FMT)
        self.run_dir = os.path.join(root, stamp)
        os.makedirs(self.run_dir, exist_ok=True)
        self._saved: List[int] = []

    def save(self, iteration: int, params: Any, opt_state: Any = None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """The commit order makes the checkpoint set atomic: optimizer
        state and metadata land first, the model artifact (whose CRC
        sidecar `checkpoint_intact` keys on) lands last, so a crash before
        its rename leaves a set that `latest_checkpoint` and resume never
        see."""
        mpath = os.path.join(self.run_dir, f"model.{iteration}")
        if opt_state is not None:
            opath = os.path.join(self.run_dir,
                                 f"optimMethod-{self.optim_name}.{iteration}")
            save_pytree(opath, opt_state)
        if extra:
            tmp = mpath + f".meta.json.tmp-{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(extra, fh)
            os.replace(tmp, mpath + ".meta.json")
        save_pytree(mpath, params)
        self._saved.append(iteration)
        self._gc()
        return mpath

    def _gc(self):
        """Keep the newest `keep` versions; a retired version takes its
        int8 sidecar and its publish marker with it."""
        while len(self._saved) > self.keep:
            it = self._saved.pop(0)
            for pat in (f"model.{it}", f"optimMethod-{self.optim_name}.{it}"):
                for suffix in (".npz", ".structure.json", ".meta.json",
                               ".int8.npz", ".int8.structure.json",
                               ".published.json"):
                    p = os.path.join(self.run_dir, pat + suffix)
                    if os.path.exists(p):
                        os.remove(p)


def list_checkpoints(root: str) -> List[Tuple[str, int]]:
    """Every (run_dir, version) under root, newest first (version desc,
    then run-dir stamp desc for ties across run dirs)."""
    found: List[Tuple[str, int]] = []
    if not os.path.isdir(root):
        return found
    candidates = [root] + [os.path.join(root, d)
                           for d in sorted(os.listdir(root))
                           if os.path.isdir(os.path.join(root, d))]
    for run_dir in candidates:
        for f in os.listdir(run_dir):
            m = re.match(r"model\.(\d+)\.npz$", f)
            if m:
                found.append((run_dir, int(m.group(1))))
    return sorted(found, key=lambda rv: (rv[1], rv[0]), reverse=True)


def checkpoint_intact(run_dir: str, version: int) -> bool:
    """The model artifact and (when present) its optimizer artifacts all
    verify."""
    if not verify_pytree(os.path.join(run_dir, f"model.{version}")):
        return False
    for f in os.listdir(run_dir):
        if re.match(rf"optimMethod-.+\.{version}\.npz$", f):
            if not verify_pytree(os.path.join(run_dir, f)):
                return False
    return True


def latest_checkpoint(root: str,
                      verify: bool = True) -> Optional[Tuple[str, int]]:
    """(run_dir, version) of the newest intact model.<iter> under root; a
    corrupt or truncated newest version is skipped (with a warning) in
    favor of the newest version that verifies. `verify=False` is the raw
    newest-by-number scan."""
    for run_dir, version in list_checkpoints(root):
        if not verify or checkpoint_intact(run_dir, version):
            return (run_dir, version)
        log.warning(
            "checkpoint model.%d in %s is corrupt/truncated; falling "
            "back to an earlier version", version, run_dir)
    return None


def read_checkpoint_meta(run_dir: str, version: int) -> Dict[str, Any]:
    """The extra-metadata sidecar of one checkpoint ({} when absent or
    unreadable)."""
    mpath = os.path.join(run_dir, f"model.{version}.meta.json")
    try:
        with open(mpath) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def find_resume_checkpoint(root: str) -> Optional[Tuple[str, int,
                                                        Dict[str, Any]]]:
    """The checkpoint `fit_keras(auto_resume=True)` continues from: the
    newest intact epoch-boundary checkpoint (mid-epoch and emergency saves
    are skipped: resuming from one would replay part of an epoch). Falls
    back to the newest intact checkpoint of any kind, with a warning, when
    no boundary checkpoint survives. Returns (run_dir, version, meta) or
    None."""
    fallback = None
    for run_dir, version in list_checkpoints(root):
        if not checkpoint_intact(run_dir, version):
            continue
        meta = read_checkpoint_meta(run_dir, version)
        # checkpoints older than the flag count as boundaries
        if meta.get("epoch_finished", True):
            return (run_dir, version, meta)
        if fallback is None:
            fallback = (run_dir, version, meta)
    if fallback is not None:
        log.warning(
            "no epoch-boundary checkpoint under %s; resuming from "
            "mid-epoch model.%d (continuation will replay the partial "
            "epoch from its start)", root, fallback[1])
    return fallback


# ---------------------------------------------------------------------------
# Publish markers: the rollout contract between trainer and fleet
# ---------------------------------------------------------------------------
def _marker_path(run_dir: str, version: int) -> str:
    return os.path.join(run_dir, f"model.{version}.published.json")


def write_publish_marker(run_dir: str, version: int,
                         extra: Optional[Dict[str, Any]] = None) -> str:
    """Commit the publish marker of one checkpoint version, after every
    artifact of the version is durable. It records a CRC manifest of every
    artifact it vouches for; an npz that does not match the CRC its
    structure sidecar committed refuses publication
    (`CorruptCheckpointError`). Atomic write-then-rename."""
    manifest: Dict[str, Dict[str, Any]] = {}
    prefix = f"model.{version}."
    optim_re = re.compile(rf"optimMethod-.+\.{version}\.")
    for f in sorted(os.listdir(run_dir)):
        if f.endswith(".published.json") or ".tmp-" in f:
            continue
        if not (f.startswith(prefix) or optim_re.match(f)):
            continue
        p = os.path.join(run_dir, f)
        with open(p, "rb") as fh:
            raw = fh.read()
        crc = crc32c(raw)
        if f.endswith(".npz"):
            try:
                with open(_struct_path(os.path.join(run_dir, f))) as sh:
                    meta = json.load(sh)
            except (OSError, ValueError):
                raise CorruptCheckpointError(
                    f"refusing to publish model.{version} in "
                    f"{run_dir}: {f} has no readable structure "
                    "sidecar") from None
            if "npz_crc32c" in meta and (
                    meta.get("npz_bytes") != len(raw)
                    or meta["npz_crc32c"] != crc):
                raise CorruptCheckpointError(
                    f"refusing to publish model.{version} in "
                    f"{run_dir}: {f} does not match its CRC sidecar")
        manifest[f] = {"bytes": len(raw), "crc32c": crc}
    if f"model.{version}.npz" not in manifest:
        raise FileNotFoundError(
            f"cannot publish model.{version} in {run_dir}: the model "
            "artifact is not on disk")
    marker = _marker_path(run_dir, version)
    tmp = marker + f".tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            json.dump({"version": version, "manifest": manifest,
                       "extra": extra or {}}, fh)
        os.replace(tmp, marker)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return marker


def read_publish_marker(run_dir: str,
                        version: int) -> Optional[Dict[str, Any]]:
    """The marker payload, or None when absent or unparseable (an
    unpublished version, never an error)."""
    try:
        with open(_marker_path(run_dir, version)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def verify_publish_marker(run_dir: str, version: int) -> bool:
    """True when the version carries a marker and every artifact its
    manifest vouches for still exists with matching bytes and CRC."""
    marker = read_publish_marker(run_dir, version)
    if marker is None:
        return False
    for f, meta in (marker.get("manifest") or {}).items():
        p = os.path.join(run_dir, f)
        try:
            if os.path.getsize(p) != meta.get("bytes"):
                return False
            with open(p, "rb") as fh:
                if crc32c(fh.read()) != meta.get("crc32c"):
                    return False
        except OSError:
            return False
    return True


def _publish_stat_key(run_dir: str, version: int) -> Optional[tuple]:
    """Cache key of a version's publish verdict: (mtime_ns, size) of the
    marker and of every file its manifest vouches for; None when any is
    absent."""
    marker = read_publish_marker(run_dir, version)
    if marker is None:
        return None
    stats = []
    try:
        m = os.stat(_marker_path(run_dir, version))
        stats.append(("", m.st_mtime_ns, m.st_size))
        for f in sorted(marker.get("manifest") or {}):
            st = os.stat(os.path.join(run_dir, f))
            stats.append((f, st.st_mtime_ns, st.st_size))
    except OSError:
        return None
    return (run_dir, version, tuple(stats))


def published_intact(run_dir: str, version: int,
                     verify_cache: Optional[Dict] = None) -> bool:
    """The rollout watcher's admission check in one read pass; with
    `verify_cache` (a caller-owned dict) the verdict is memoized per stat
    key."""
    if verify_cache is None:
        return verify_publish_marker(run_dir, version)
    key = _publish_stat_key(run_dir, version)
    if key is None:
        return False
    verdict = verify_cache.get(key)
    if verdict is None:
        verdict = verify_publish_marker(run_dir, version)
        verify_cache[key] = verdict
    return verdict


def latest_published_checkpoint(
        root: str, skip_versions=(),
        verify_cache: Optional[Dict] = None) -> Optional[Tuple[str, int]]:
    """(run_dir, version) of the newest published checkpoint under `root`
    not in `skip_versions`; a version without an intact publish marker is
    invisible. `verify_cache` memoizes the CRC verdicts; entries of
    versions no longer listed are pruned."""
    skip = {int(v) for v in skip_versions}
    listed = list_checkpoints(root)
    if verify_cache is not None:
        live = {(rd, v) for rd, v in listed}
        for key in [k for k in verify_cache if (k[0], k[1]) not in live]:
            verify_cache.pop(key, None)
    for run_dir, version in listed:
        if version in skip:
            continue
        if published_intact(run_dir, version, verify_cache=verify_cache):
            return (run_dir, version)
    return None


def resolve_checkpoint(path: str,
                       version: Optional[int] = None) -> Tuple[str, int]:
    """Root-vs-run-dir resolution: `version=None` → the newest intact
    checkpoint anywhere under `path`; an explicit version → `path` itself
    when it holds `model.<version>`, else the newest run dir under `path`
    that does. Raises FileNotFoundError."""
    if version is None:
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"No checkpoint under {path}")
        return found
    if os.path.exists(os.path.join(path, f"model.{version}.npz")):
        return path, version
    found = latest_checkpoint(path)
    if found and os.path.exists(
            os.path.join(found[0], f"model.{version}.npz")):
        return found[0], version
    raise FileNotFoundError(f"No model.{version} under {path}")


def load_checkpoint(path: str, version: Optional[int] = None,
                    optim_name: str = "default", verify: bool = True):
    """(params, opt_tree, meta) of a checkpoint. `path` may be the root or
    a run dir; `version=None` → latest. `verify=False` skips the CRC pass,
    for callers (auto-resume) that ran `checkpoint_intact` on this exact
    version moments earlier."""
    run_dir, version = resolve_checkpoint(path, version)
    params = load_pytree(os.path.join(run_dir, f"model.{version}"),
                         verify=verify)
    opt_tree = None
    opath = os.path.join(run_dir, f"optimMethod-{optim_name}.{version}")
    if os.path.exists(opath + ".npz"):
        opt_tree = load_pytree(opath, verify=verify)
    meta = {}
    mpath = os.path.join(run_dir, f"model.{version}.meta.json")
    if os.path.exists(mpath):
        with open(mpath) as fh:
            meta = json.load(fh)
    return params, opt_tree, meta


def _leaves(tree: Any) -> List[Any]:
    """Leaves in `jax.tree_util` order: dict keys sorted, sequences in
    order, None and empty containers contributing none."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _unflatten(template: Any, leaves) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves)
                for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        parts = [_unflatten(v, leaves) for v in template]
        return type(template)(*parts) if hasattr(template, "_fields") \
            else type(template)(parts)
    return None if template is None else next(leaves)


def restore_opt_state(template: Any, tree: Any) -> Any:
    """Pour saved leaves back into a state template (the optax layout of a
    fresh `init`) by leaf order, as the JAX package does; each leaf takes
    the template leaf's dtype. A different leaf count, or a leaf of
    another shape, raises ValueError."""
    leaves_saved = _leaves(tree)
    leaves_tmpl = _leaves(template)
    if len(leaves_saved) != len(leaves_tmpl):
        raise ValueError(
            f"Optimizer state mismatch: saved {len(leaves_saved)} leaves, "
            f"template has {len(leaves_tmpl)}")
    cast = []
    for s, t in zip(leaves_saved, leaves_tmpl):
        t = np.asarray(t)
        s = np.asarray(s, dtype=t.dtype)
        if s.shape != t.shape:
            raise ValueError(
                f"Optimizer state mismatch: a saved leaf of shape {s.shape} "
                f"where the template has {t.shape}")
        cast.append(s)
    return _unflatten(template, iter(cast))
