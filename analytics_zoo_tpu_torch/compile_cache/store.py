"""The disk store: CRC-checked, size-bounded, atomically written.

Copied from `analytics_zoo_tpu/compile_cache/store.py` (L1-370):
`write_entry` (L51), `read_entry` (L75), `read_header` (L103),
`scan_dir` (L118), `prune_dir` (L146), `dir_bytes` (L175),
`CompileCache` (L179) with its five registry families under the JAX
names (L210-223), and `get_cache` (L350). The payload is opaque bytes:
in the port a kernel library (`kernels/_build.py`) or a capture record
(`compile_cache/graphs.py`), never an executable — a CUDA graph cannot
be written to disk. So `load` returns the payload and `put` takes it,
where the JAX store (de)serializes an executable around them.
`enable_jax_persistent_cache` (L373) has no twin: there is no compiler
cache beneath the port's to fall back to.

Entry file layout (`<digest>.aotc`):

    magic  b"AZCC"                      (4 bytes)
    format version                      (u32 LE)
    header length                       (u32 LE)
    header JSON (utf-8)                 — key fields + created + payload
                                          crc32c/length
    payload                             — opaque bytes

The header is self-describing, so the maintenance tool
(`compile_cache/tool.py`) can `ls`/`stats`/`prune` a cache dir with
nothing but this module: the directory IS the index, scanned on demand.

Durability rules:

- writes go to a same-directory temp file then `os.replace` — a reader
  never sees a half-written entry, and a crashed writer leaves only a
  temp file that the next prune sweeps;
- reads verify magic, format version, header shape, payload length and
  CRC32C (`utils/crc.py`); ANY failure — truncation, corruption, a
  different format version — deletes the entry and reports a miss. The
  load path cannot raise;
- LRU is file mtime: a hit touches the entry (`os.utime`); eviction
  removes oldest-touched first until the byte budget holds.

Telemetry (process-wide registry unless one is given):
`compile_cache_hits_total`, `compile_cache_misses_total`,
`compile_cache_load_ms`, `compile_cache_compile_ms`,
`compile_cache_bytes`.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.compile_cache.key import (FORMAT_VERSION,
                                                       CacheKey)
from analytics_zoo_tpu_torch.utils.crc import crc32c

log = logging.getLogger("analytics_zoo_tpu_torch.compile_cache")

MAGIC = b"AZCC"
ENTRY_SUFFIX = ".aotc"
_HDR = struct.Struct("<4sII")       # magic, format version, header length


def write_entry(path: str, key_fields: Dict[str, Any],
                payload: bytes) -> int:
    """Atomic write-then-rename of one entry; returns bytes written."""
    header = dict(key_fields)
    header["created"] = time.time()
    header["payload_len"] = len(payload)
    header["payload_crc32c"] = crc32c(payload)
    hjson = json.dumps(header, sort_keys=True, default=str).encode()
    blob = _HDR.pack(MAGIC, FORMAT_VERSION, len(hjson)) + hjson + payload
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tmp-", suffix=ENTRY_SUFFIX + ".part")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(blob)


def _read_head(fh) -> Tuple[int, Dict[str, Any]]:
    head = fh.read(_HDR.size)
    if len(head) != _HDR.size:
        raise ValueError("truncated entry header")
    magic, version, hlen = _HDR.unpack(head)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}")
    hjson = fh.read(hlen)
    if len(hjson) != hlen:
        raise ValueError("truncated entry header json")
    return version, json.loads(hjson)


def read_entry(path: str) -> Tuple[Dict[str, Any], bytes]:
    """Parse + verify one entry file; raises on ANY defect (magic,
    version, truncation, CRC). Callers on the load path catch and treat
    it as a miss."""
    with open(path, "rb") as fh:
        version, header = _read_head(fh)
        if version != FORMAT_VERSION:
            raise ValueError(f"format version {version} != "
                             f"{FORMAT_VERSION}")
        payload = fh.read()
    if len(payload) != header.get("payload_len"):
        raise ValueError(f"payload length {len(payload)} != recorded "
                         f"{header.get('payload_len')}")
    if crc32c(payload) != header.get("payload_crc32c"):
        raise ValueError("payload CRC32C mismatch")
    return header, payload


def read_header(path: str) -> Dict[str, Any]:
    """Header only (for `ls`/`stats` — skips the payload CRC)."""
    with open(path, "rb") as fh:
        version, header = _read_head(fh)
    header["format_version"] = version
    return header


def scan_dir(path: str) -> List[Dict[str, Any]]:
    """The on-demand index: one dict per entry file (corrupt headers
    included, flagged) sorted oldest-touched first."""
    out = []
    try:
        names = sorted(os.listdir(path))
    except OSError:
        return out
    for name in names:
        if not name.endswith(ENTRY_SUFFIX):
            continue
        fp = os.path.join(path, name)
        try:
            st = os.stat(fp)
        except OSError:
            continue
        info = {"file": name, "digest": name[:-len(ENTRY_SUFFIX)],
                "bytes": st.st_size, "last_used": st.st_mtime}
        try:
            hdr = read_header(fp)
            info["header"] = hdr
            info["created"] = hdr.get("created")
        except Exception as e:  # noqa: BLE001 — tool must list anyway
            info["corrupt"] = str(e)
        out.append(info)
    out.sort(key=lambda i: i["last_used"])
    return out


def prune_dir(path: str, max_bytes: int) -> Tuple[int, int]:
    """Evict oldest-touched entries until the directory holds
    <= max_bytes; returns (entries removed, entry bytes freed). Stray
    temp files from crashed writers are swept too but NOT counted."""
    removed = freed = 0
    try:
        names = os.listdir(path)
    except OSError:
        return 0, 0
    for name in names:                      # crashed writers' leftovers
        if name.startswith(".tmp-"):
            try:
                os.unlink(os.path.join(path, name))
            except OSError:
                pass
    entries = scan_dir(path)
    total = sum(e["bytes"] for e in entries)
    for e in entries:
        if total <= max_bytes:
            break
        try:
            os.unlink(os.path.join(path, e["file"]))
        except OSError:
            continue
        total -= e["bytes"]
        removed += 1
        freed += e["bytes"]
    return removed, freed


def dir_bytes(path: str) -> int:
    return sum(e["bytes"] for e in scan_dir(path))


class CompileCache:
    """Disk-backed cache of opaque payloads. Thread-safe; every public
    method is exception-free on the load path (corruption → miss, full
    disk → skip persist) — a cache problem must never take serving
    down."""

    def __init__(self, path: str, max_bytes: Optional[int] = None,
                 registry=None):
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError(
                f"compile cache max_bytes={max_bytes} must be positive")
        self.path = os.path.abspath(os.path.expanduser(path))
        if os.path.exists(self.path) and not os.path.isdir(self.path):
            raise ValueError(
                f"compile cache path {self.path!r} exists and is not a "
                "directory")
        os.makedirs(self.path, exist_ok=True)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self.registry = registry
        self._hits = registry.counter(
            "compile_cache_hits_total",
            "kernel libraries and capture records loaded from the "
            "persistent compile cache")
        self._misses = registry.counter(
            "compile_cache_misses_total",
            "persistent compile cache lookups that fell back to a fresh "
            "build or capture")
        self._load_ms = registry.histogram(
            "compile_cache_load_ms",
            "wall time to read + verify one cache entry")
        self._compile_ms = registry.histogram(
            "compile_cache_compile_ms",
            "wall time of fresh nvcc builds and captures the cache then "
            "persisted")
        self._bytes = registry.gauge(
            "compile_cache_bytes",
            "bytes of cache entries on disk in the cache dir")
        # in-memory dir accounting, maintained incrementally: stats() sits
        # on the /metrics scrape path, which must not rescan the directory
        entries = scan_dir(self.path)
        self._n_entries = len(entries)
        self._n_bytes = sum(e["bytes"] for e in entries)
        self._bytes.set(self._n_bytes)

    def _account(self, d_entries: int, d_bytes: int):
        """Adjust the in-memory dir accounting (callers hold _lock);
        floor at zero against drift."""
        self._n_entries = max(0, self._n_entries + d_entries)
        self._n_bytes = max(0, self._n_bytes + d_bytes)
        self._bytes.set(self._n_bytes)

    # -- load/store --------------------------------------------------------
    def _entry_path(self, key: CacheKey) -> str:
        return os.path.join(self.path, key.digest + ENTRY_SUFFIX)

    def contains(self, key: CacheKey) -> bool:
        return os.path.exists(self._entry_path(key))

    def load(self, key: CacheKey) -> Optional[bytes]:
        """Hit → the payload bytes; miss/corrupt/version-mismatch → None.
        Never raises."""
        fp = self._entry_path(key)
        t0 = time.perf_counter()
        try:
            _, payload = read_entry(fp)
        except FileNotFoundError:
            self._misses.inc()
            return None
        except Exception as e:  # noqa: BLE001 — degrade to a rebuild
            log.warning("compile cache entry %s unusable (%s: %s); "
                        "falling back to a fresh build",
                        os.path.basename(fp), type(e).__name__, e)
            with self._lock:
                try:
                    size = os.path.getsize(fp)
                    os.unlink(fp)
                except OSError:
                    pass
                else:
                    self._account(-1, -size)
            self._misses.inc()
            return None
        try:
            os.utime(fp)            # LRU touch
        except OSError:
            pass
        self._hits.inc()
        self._load_ms.observe((time.perf_counter() - t0) * 1e3)
        return payload

    def put(self, key: CacheKey, payload: bytes,
            compile_ms: Optional[float] = None) -> bool:
        """Persist one payload; evict LRU past the byte budget. False
        (never an exception) when the disk write fails."""
        if compile_ms is not None:
            self._compile_ms.observe(compile_ms)
        try:
            with self._lock:
                fp = self._entry_path(key)
                try:
                    old = os.path.getsize(fp)      # overwrite: replace,
                    d_entries = 0                  # don't double-count
                except OSError:
                    old, d_entries = 0, 1
                written = write_entry(fp, key.fields, bytes(payload))
                self._account(d_entries, written - old)
                if self.max_bytes is not None:
                    removed, freed = prune_dir(self.path, self.max_bytes)
                    self._account(-removed, -freed)
        except Exception as e:  # noqa: BLE001 — full/readonly disk
            log.warning("compile cache write failed (%s: %s)",
                        type(e).__name__, e)
            return False
        return True

    # -- maintenance (shared with compile_cache/tool.py) -------------------
    def index(self) -> List[Dict[str, Any]]:
        return scan_dir(self.path)

    def total_bytes(self) -> int:
        return dir_bytes(self.path)

    def stats(self) -> Dict[str, Any]:
        """Cheap (in-memory) counters — this sits on the /metrics scrape
        path, so it must not rescan the directory. The maintenance tool's
        `stats` command scans for ground truth."""
        with self._lock:
            return {"path": self.path,
                    "entries": self._n_entries,
                    "bytes": self._n_bytes,
                    "hits": self._hits.value(),
                    "misses": self._misses.value(),
                    "max_bytes": self.max_bytes}

    def prune(self, max_bytes: int) -> Tuple[int, int]:
        with self._lock:
            removed, freed = prune_dir(self.path, max_bytes)
            self._account(-removed, -freed)
        return removed, freed

    def clear(self) -> int:
        with self._lock:
            n, freed = prune_dir(self.path, -1)
            self._account(-n, -freed)
        return n


_CACHES: Dict[str, "CompileCache"] = {}
_CACHES_LOCK = threading.Lock()


def get_cache(path: str, max_bytes: Optional[int] = None) -> CompileCache:
    """Process-level memo: one `CompileCache` per directory, so every
    model of a process shares hit/miss accounting and skips re-scanning
    the dir."""
    key = os.path.abspath(os.path.expanduser(path))
    with _CACHES_LOCK:
        cc = _CACHES.get(key)
        if cc is None:
            cc = _CACHES[key] = CompileCache(key, max_bytes=max_bytes)
        elif max_bytes is not None:
            cc.max_bytes = max_bytes
        return cc
