"""ctypes bridge to the native C++ batch loader (`native/zoo_loader.cpp`).

Copied from `analytics_zoo_tpu/data/native_loader.py` (L1-226):
`build_native_lib` (L37) with its contract (`ZOO_DISABLE_NATIVE=1`, a
rebuild when the source is newer, one recovery from a stale or truncated
`.so`, a logged fall back to the Python path when `g++` is absent),
`available` (L110) and `NativeBatchLoader` (L114). The sources are the
repo's `native/*.cpp` as they are; `native_paths` puts each library in the
port's build directory (`analytics_zoo_tpu_torch/_build/`, or
`$AZT_KERNEL_BUILD_DIR`), never beside the sources. These are host
helpers: no device kernel is built here.

The reference's data-cache native layer is JNI into memkind/PMEM
(`PersistentMemoryAllocator.java:37`, `pmem/FeatureSet.scala:151`); here the
native side is a threaded mmap gather: samples are packed into one
fixed-record binary file, C++ workers assemble shuffled batches off the GIL
into a bounded queue, Python drains ready batches and splits each record
back into the pytree leaves. Falls back cleanly when no compiler is present
(`available()` gates every use).

Build: compiled on demand with g++ -O3 into the package dir; rebuilt when
the source is newer (no pip, no cmake — the image bakes the toolchain).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("analytics_zoo_tpu_torch.native")

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def build_native_lib(src: str, lib_path: str) -> Optional[ctypes.CDLL]:
    """Shared native-build contract for every on-demand C++ helper:
    honors ZOO_DISABLE_NATIVE=1, rebuilds when the source is newer, and
    recovers once from a stale/truncated .so (a killed build). Returns a
    loaded CDLL or None (caller falls back to the python path)."""
    if os.environ.get("ZOO_DISABLE_NATIVE") == "1":
        return None

    def compile_() -> Optional[str]:
        if os.path.exists(lib_path) and \
                os.path.getmtime(lib_path) >= os.path.getmtime(src):
            return lib_path
        # compile to a private temp file and rename: concurrent processes
        # (multi-process fit on one host) must never dlopen a half-written
        # .so or unlink each other's output
        tmp = f"{lib_path}.tmp.{os.getpid()}"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               src, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, lib_path)       # atomic publication
            return lib_path
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native build of %s failed (%s); using python "
                        "path", os.path.basename(src), e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None

    path = compile_()
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        # stale/truncated artifact (e.g. a killed build): rebuild once
        try:
            os.unlink(path)
            path = compile_()
            if path:
                return ctypes.CDLL(path)
        except OSError:
            pass
        log.warning("native .so %s unloadable; using python path",
                    os.path.basename(lib_path))
        return None


def native_paths(name: str) -> Tuple[str, str]:
    """(source, library) of the repo's `native/<name>.cpp`: the library
    goes to the port's build directory, which is created here."""
    from analytics_zoo_tpu_torch.kernels._build import BUILD_DIR
    os.makedirs(BUILD_DIR, exist_ok=True)
    return (os.path.join(_NATIVE_DIR, f"{name}.cpp"),
            os.path.join(str(BUILD_DIR), f"_{name}.so"))


def _get_lib():
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        lib = build_native_lib(*native_paths("zoo_loader"))
        if lib is None:
            _build_failed = True
            return None
        lib.zoo_loader_create.restype = ctypes.c_void_p
        lib.zoo_loader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.zoo_loader_start_epoch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
        lib.zoo_loader_next.restype = ctypes.c_int64
        lib.zoo_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.zoo_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _get_lib() is not None


class NativeBatchLoader:
    """Packed-record file + native threaded batch assembly.

    from_arrays packs a pytree-flattened list of arrays (shared leading dim)
    row-wise into one binary file; iter_epoch yields per-batch leaf lists.
    """

    def __init__(self, path: str, n: int, specs: List[Tuple[Tuple[int, ...],
                                                            np.dtype]],
                 batch_size: int, n_threads: int = 2,
                 queue_capacity: int = 4, drop_remainder: bool = True,
                 _owns_file: bool = False):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self.path, self.n, self.specs = path, n, specs
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self._owns_file = _owns_file
        self._row_bytes = [int(np.prod(shape)) * np.dtype(dt).itemsize
                           for shape, dt in specs]
        self.record_bytes = sum(self._row_bytes)
        self._handle = lib.zoo_loader_create(
            path.encode(), n, self.record_bytes, batch_size,
            n_threads, queue_capacity, int(drop_remainder))
        if not self._handle:
            raise RuntimeError(f"zoo_loader_create failed for {path}")
        self._buf = np.empty(batch_size * self.record_bytes, np.uint8)
        self._lock = threading.Lock()
        self._epoch_token = 0

    @staticmethod
    def pack_file(leaves: List[np.ndarray], cache_dir: Optional[str] = None,
                  chunk_rows: int = 8192
                  ) -> Tuple[str, int, List[Tuple[Tuple[int, ...],
                                                  np.dtype]]]:
        """Stream leaves (ndarrays or memmaps) into a packed record file in
        chunks — peak RAM is chunk_rows * record_bytes, never the dataset
        (the DISK tier's whole point). Returns (path, n, specs)."""
        n = len(leaves[0])
        if any(len(a) != n for a in leaves):
            raise ValueError("leaves must share the leading dim")
        specs = [(a.shape[1:], np.dtype(a.dtype)) for a in leaves]
        fd, path = tempfile.mkstemp(suffix=".zoorec", dir=cache_dir)
        with os.fdopen(fd, "wb") as fh:
            for s in range(0, n, chunk_rows):
                e = min(s + chunk_rows, n)
                rows = [np.ascontiguousarray(a[s:e]) for a in leaves]
                packed = np.concatenate(
                    [r.reshape(e - s, -1).view(np.uint8)
                     .reshape(e - s, -1) for r in rows], axis=1)
                packed.tofile(fh)
        return path, n, specs

    @classmethod
    def from_arrays(cls, leaves: List[np.ndarray], batch_size: int,
                    cache_dir: Optional[str] = None,
                    **kw) -> "NativeBatchLoader":
        path, n, specs = cls.pack_file(leaves, cache_dir)
        return cls(path, n, specs, batch_size, _owns_file=True, **kw)

    def _split_record_batch(self, raw: np.ndarray, rows: int):
        """[rows, record_bytes] uint8 -> list of leaf batches."""
        out = []
        off = 0
        for (shape, dt), nb in zip(self.specs, self._row_bytes):
            # .copy() (never ascontiguousarray): the staging buffer is
            # reused next iteration, so yielded batches must own their data
            chunk = raw[:rows, off:off + nb].copy()
            out.append(chunk.view(dt).reshape((rows,) + tuple(shape)))
            off += nb
        return out

    def iter_epoch(self, seed: int = 0, shuffle: bool = True):
        """Yield lists of leaf batches. Starting a new epoch supersedes any
        half-read one (the abandoned generator just stops) — the lock is
        only held per batch, never across the epoch, so an abandoned
        generator can never deadlock a later one."""
        with self._lock:
            self._epoch_token += 1
            token = self._epoch_token
            self._lib.zoo_loader_start_epoch(self._handle, seed,
                                             int(shuffle))
        raw2d = self._buf.reshape(self.batch_size, self.record_bytes)
        while True:
            with self._lock:
                if token != self._epoch_token:
                    return                      # superseded by a new epoch
                if self._handle is None:
                    raise RuntimeError("loader closed during iteration")
                rows = self._lib.zoo_loader_next(
                    self._handle,
                    self._buf.ctypes.data_as(ctypes.c_void_p))
                if rows == 0:
                    return
                if rows < 0:
                    raise RuntimeError("native loader shut down")
                batch = self._split_record_batch(raw2d, int(rows))
            yield batch

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.zoo_loader_destroy(self._handle)
            self._handle = None
        if self._owns_file and os.path.exists(self.path):
            os.unlink(self.path)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
