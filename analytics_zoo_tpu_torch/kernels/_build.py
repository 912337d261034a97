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
Nothing here runs at import: this module imports on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_compiles = 0        # nvcc runs that produced a library, in this process


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


def build(sources: Sequence[str]) -> Dict[str, float]:
    """Compile every source not yet built, one nvcc per source, all started
    together. Returns the seconds each build took (0.0 if it was cached).
    Raises KernelBuildError with nvcc's output if any build fails."""
    global _compiles
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in todo.items() if not p.exists()}
    seconds = {s: 0.0 for s in sources}
    if not todo:
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
    return seconds


def build_events() -> Dict[str, int]:
    """How many sources this process compiled with nvcc and how many
    libraries it has loaded: a serving run reads these before and after
    its request path to show that no kernel was built there."""
    with _lock:
        return {"compiles": _compiles, "loaded": len(_libs)}


def build_log(source: str) -> str:
    """ptxas's report from the build of `source` ('' before it is built)."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, building it first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _libs[source] = lib
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
