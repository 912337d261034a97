"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each source has a plain C interface and is compiled on its own into a
shared library for `sm_90a` (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o <lib>.so csrc/<source>.cu

The build runs at first use, into `analytics_zoo_tpu_torch/_build/`, under
a name keyed on a hash of the source, the headers it includes from `csrc/`
(`#include "x.cuh"`, followed recursively) and the flags, so an edited
source or header rebuilds and an unchanged one loads at once. ptxas's
report (registers, shared memory, spills per kernel) is kept beside each
library as `.log`.

With a persistent compile cache (`compile_cache.CompileCache`, given to
`load` or made the process's with `library_cache`), each library is also
an entry of the cache: its key is the library's name (the hash above),
the nvcc version and the card (`compile_cache.key.make_key`, which adds
the compute capability, the card's name and the torch and CUDA runtime
versions), its payload the `.so` and its ptxas `.log`. A library missing
from the build directory is then written from the cache and loaded with
no nvcc run; one that is built is put. `build_events` counts both, so a
warm restart shows `compiles` 0. The build directory is
`analytics_zoo_tpu_torch/_build/`, or `$AZT_KERNEL_BUILD_DIR` where that
is set (a second process with an empty build directory of its own).
Nothing here runs at import: this module imports on hosts without nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import logging
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Set

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = Path(os.environ.get("AZT_KERNEL_BUILD_DIR")
                 or PACKAGE_DIR / "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_log = logging.getLogger("analytics_zoo_tpu_torch.kernels")
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_compiles = 0        # nvcc runs that produced a library, in this process
_cache_loads = 0     # libraries written from the compile cache instead
_cache = None        # the process's library cache (`library_cache`)
_put_checked: Set[tuple] = set()   # (cache dir, source) known stored


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's usual home."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and the default "
        "toolkit location); the CUDA kernels cannot be built")


def source_files(source: str) -> List[str]:
    """`source` and every header under csrc/ it includes, directly or
    through another header, in a fixed order."""
    seen: List[str] = []
    todo = [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        text = (CSRC_DIR / name).read_bytes()
        todo.extend(m.decode() for m in _INCLUDE.findall(text))
    return seen


def library_path(source: str) -> Path:
    """Where `source` (a file name under csrc/) builds to."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in source_files(source):
        digest.update(name.encode() + b"\0" + (CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


_nvcc_version: Optional[str] = None


def nvcc_version() -> str:
    """The toolkit's nvcc version, from its `version.json` (no nvcc run),
    else from `nvcc --version`."""
    global _nvcc_version
    if _nvcc_version is None:
        nvcc = Path(nvcc_path()).resolve()
        info = nvcc.parent.parent / "version.json"
        try:
            _nvcc_version = json.loads(info.read_text())["cuda_nvcc"][
                "version"]
        except (OSError, ValueError, KeyError, TypeError):
            out = subprocess.run([str(nvcc), "--version"], check=True,
                                 capture_output=True, text=True).stdout
            _nvcc_version = out.strip().splitlines()[-1]
    return _nvcc_version


def library_key(source: str):
    """The compile-cache key of `source`'s library: its name (the hash of
    the source, its headers and the flags), the nvcc version and, through
    `make_key`, the current card's compute capability and name."""
    from analytics_zoo_tpu_torch.compile_cache.key import make_key
    return make_key("kernel",
                    f"{library_path(source).name} nvcc {nvcc_version()}",
                    (source, ()))


def _pack_library(out: Path) -> bytes:
    so = out.read_bytes()
    log = out.with_suffix(".log")
    return (len(so).to_bytes(8, "little") + so
            + (log.read_bytes() if log.exists() else b""))


def _unpack_library(payload: bytes, out: Path) -> None:
    """Write a cached library (and its ptxas log) to `out`, atomically."""
    n = int.from_bytes(payload[:8], "little")
    if len(payload) < 8 + n:
        raise ValueError("truncated library payload")
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    with os.fdopen(fd, "wb") as fh:
        fh.write(payload[8:8 + n])
    out.with_suffix(".log").write_bytes(payload[8 + n:])
    os.replace(tmp, out)


def _fetch(sources: Sequence[str], cache) -> None:
    """Write the libraries of `sources` from `cache` where it holds them."""
    global _cache_loads
    for src in sources:
        out = library_path(src)
        t0 = time.perf_counter()
        payload = cache.load(library_key(src))
        if payload is None:
            continue
        try:
            _unpack_library(payload, out)
        except (OSError, ValueError) as e:
            _log.warning("cached library of %s unusable (%s); building "
                         "it", src, e)
            continue
        _cache_loads += 1
        _put_checked.add((cache.path, src))
        _log.info("%s: library from the compile cache in %.3fs", src,
                  time.perf_counter() - t0)


def _store(sources: Sequence[str], cache, seconds: Dict[str, float]) -> None:
    """Put the built libraries of `sources` that `cache` lacks."""
    for src in sources:
        if (cache.path, src) in _put_checked:
            continue
        out = library_path(src)
        key = library_key(src)
        if out.exists() and not cache.contains(key):
            cache.put(key, _pack_library(out),
                      compile_ms=seconds.get(src, 0.0) * 1e3 or None)
        _put_checked.add((cache.path, src))


@contextlib.contextmanager
def library_cache(cache) -> Iterator[None]:
    """Make `cache` the process's library cache for the block (None: no
    cache), whichever thread loads a library meanwhile."""
    global _cache
    with _lock:
        prev, _cache = _cache, cache
    try:
        yield
    finally:
        with _lock:
            _cache = prev


def build(sources: Sequence[str], cache=None) -> Dict[str, float]:
    """Compile every source not yet built, one nvcc per source, all started
    together, after taking what `cache` (default: the process's library
    cache) holds. Returns the seconds each build took (0.0 if it was
    already built or came from the cache). Raises KernelBuildError with
    nvcc's output if any build fails."""
    global _compiles
    cache = _cache if cache is None else cache
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {s: 0.0 for s in sources}
    if cache is not None:
        _fetch([s for s in sources if not library_path(s).exists()], cache)
    todo = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in todo.items() if not p.exists()}
    if not todo:
        if cache is not None:
            _store(sources, cache, seconds)
        return seconds
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for src, out in todo.items():
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failures = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
        _compiles += 1
    if failures:
        raise KernelBuildError("CUDA build failed:\n" + "\n".join(failures))
    if cache is not None:
        _store(sources, cache, seconds)
    return seconds


def build_events() -> Dict[str, int]:
    """How many sources this process compiled with nvcc, how many
    libraries it wrote from the compile cache instead and how many it has
    loaded: a serving run reads these before and after its request path
    to show that no kernel was built there, and a warm restart reads
    `compiles` 0."""
    with _lock:
        return {"compiles": _compiles, "cached": _cache_loads,
                "loaded": len(_libs)}


def build_log(source: str) -> str:
    """ptxas's report from the build of `source` ('' before it is built)."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(source: str, cache=None) -> ctypes.CDLL:
    """The loaded library of `source`, taken from `cache` (default: the
    process's library cache) or built first if needed; with a cache, a
    library loaded before it was set is put in it too."""
    with _lock:
        cache = _cache if cache is None else cache
        lib = _libs.get(source)
        if lib is None:
            build([source], cache)
            lib = ctypes.CDLL(str(library_path(source)))
            _libs[source] = lib
        elif cache is not None and (cache.path, source) not in _put_checked:
            _store([source], cache, {})
        return lib


def bind(source: str, name: str, argtypes: Sequence) -> Callable:
    """The C function `name` of `source`'s library with its ctypes
    signature set; it returns the launch's cudaError_t."""
    lib = load(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        lib.azt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.azt_cuda_error_string.restype = ctypes.c_char_p
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    return fn


def check_launch(source: str, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = load(source).azt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} "
                           f"(cudaError {rc})")
