"""On-demand profiler capture and host stack sampling.

Port of `analytics_zoo_tpu/observability/capture.py` (L58-323), both
instruments zero-cost while idle:

- `ProfileCapture` — bounded, rotated `torch.profiler` captures (CPU
  activity, and the card's kernels and copies when there is a card). One
  capture at a time, process-wide (the profiler's session is global):
  an overlapping request raises `CaptureActiveError`. Artifact
  directories rotate under a root so a forgotten capture loop cannot fill
  the disk. Each artifact holds the profiler's Chrome trace as
  `torch.trace.json.gz`, which `load_trace_events` reads back and
  Perfetto or `chrome://tracing` open. Drives
  `fit_keras(profile_steps=(start, stop))`.
- `StackSampler` — copied as it is: a host-side stack-sampling profiler
  for named threads (`sys._current_frames()` sampled at `interval_s`,
  aggregated per (thread, innermost frame)).

Neither installs hooks or threads while inactive.
"""

from __future__ import annotations

import collections
import gzip
import json
import logging
import os
import shutil
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

log = logging.getLogger("analytics_zoo_tpu_torch.observability")

# serving pipeline thread-name prefixes (server.py start() specs)
SERVING_THREAD_PREFIXES = ("serving-", "infer-replica-")

TRACE_FILE = "torch.trace.json.gz"

MAX_CAPTURE_SECONDS = 120.0

# torch.profiler's session is PROCESS-global, so the single-flight guard
# must be too: two ProfileCapture instances (a serving capture and a
# fit_keras(profile_steps=...) window) must see one lock, or the loser
# gets an opaque profiler error instead of the documented
# CaptureActiveError
_capture_lock = threading.Lock()


class CaptureActiveError(RuntimeError):
    """A capture is already running; the profiler is single-flight (two
    concurrent profiler sessions would corrupt each other)."""


class ProfileCapture:
    """Bounded, rotated `torch.profiler` captures under one root.

    `start(tag)` begins a capture into a fresh artifact dir and returns
    its path; `stop()` ends it and returns a manifest (dir, files,
    seconds). `capture(seconds)` is the blocking convenience (the JAX
    package's HTTP endpoint uses it). At most `max_artifacts` capture dirs are kept —
    oldest deleted first."""

    def __init__(self, root: str, max_artifacts: int = 8,
                 registry=None):
        if max_artifacts < 1:
            raise ValueError(
                f"max_artifacts must be >= 1, got {max_artifacts}")
        self.root = os.path.abspath(os.path.expanduser(root))
        self.max_artifacts = int(max_artifacts)
        self._lock = _capture_lock           # process-wide single-flight
        self._active_dir: Optional[str] = None
        self._prof = None
        self._t0 = 0.0
        self._seq = 0
        from analytics_zoo_tpu_torch.observability.registry import \
            get_registry
        reg = registry if registry is not None else get_registry()
        self._captures = reg.counter(
            "profile_captures_total",
            "profiler captures taken, by how they ended (ok, error)")
        self._active_gauge = reg.gauge(
            "profile_capture_active",
            "1 while a profiler capture is running")
        # seed the series only while no capture runs anywhere: the gauge
        # (like the lock and the profiler session) is process-global,
        # and constructing a second instance mid-capture (a fit's
        # profile_steps window while the frontend traces) must not
        # report the live capture as finished
        if not _capture_lock.locked():
            self._active_gauge.set(0)

    @property
    def active(self) -> bool:
        return self._active_dir is not None

    def start(self, tag: str = "capture") -> str:
        """Begin a capture; returns the artifact dir. Raises
        `CaptureActiveError` when one is already running."""
        if not self._lock.acquire(blocking=False):
            raise CaptureActiveError(
                "a profiler capture is already running")
        try:
            os.makedirs(self.root, exist_ok=True)
            self._seq += 1
            safe_tag = "".join(c if c.isalnum() or c in "-_" else "-"
                               for c in tag)[:48] or "capture"
            art = os.path.join(
                self.root,
                time.strftime("%Y%m%d-%H%M%S") + f"-{self._seq:03d}-"
                + safe_tag)
            os.makedirs(art, exist_ok=True)
            self._prof = _start_profiler()
        except Exception:
            self._lock.release()
            self._captures.inc(outcome="error")
            raise
        self._active_dir = art
        self._t0 = time.perf_counter()
        self._active_gauge.set(1)
        return art

    def stop(self) -> Dict[str, object]:
        """End the running capture; returns {dir, files, seconds}. The
        rotation pass runs here, so the bound holds without a janitor."""
        if self._active_dir is None:
            raise RuntimeError("no capture is running")
        art, self._active_dir = self._active_dir, None
        seconds = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        try:
            _stop_profiler(prof, os.path.join(art, TRACE_FILE))
            self._captures.inc(outcome="ok")
        except Exception as e:  # noqa: BLE001 — a dead profiler session
            # must still release the single-flight lock
            self._captures.inc(outcome="error")
            log.warning("profiler stop failed: %s: %s", type(e).__name__, e)
        finally:
            self._active_gauge.set(0)
            self._lock.release()
        files = sorted(
            os.path.relpath(os.path.join(dp, f), art)
            for dp, _dirs, fs in os.walk(art) for f in fs)
        self._rotate()
        return {"dir": art, "files": files,
                "seconds": round(seconds, 4)}

    def capture(self, seconds: float, tag: str = "capture",
                sample_threads: Optional[Sequence[str]] =
                SERVING_THREAD_PREFIXES,
                sample_interval_s: float = 0.005) -> Dict[str, object]:
        """Blocking bounded capture: start, sleep, stop. When
        `sample_threads` is given, a `StackSampler` runs alongside and
        its report lands in the manifest under "host_stacks" — one
        request answers both "what did the device do" (the trace
        artifact) and "where did the host threads spin" (the stacks)."""
        seconds = min(float(seconds), MAX_CAPTURE_SECONDS)
        if seconds <= 0:
            raise ValueError(f"seconds must be > 0, got {seconds}")
        sampler = None
        self.start(tag)
        try:
            if sample_threads:
                sampler = StackSampler(interval_s=sample_interval_s,
                                       thread_prefixes=sample_threads)
                sampler.start()
            time.sleep(seconds)
        finally:
            if sampler is not None:
                stacks = sampler.stop()
            manifest = self.stop()
        if sampler is not None:
            manifest["host_stacks"] = stacks
        return manifest

    def artifacts(self) -> List[str]:
        """Capture dirs under the root, oldest first."""
        if not os.path.isdir(self.root):
            return []
        return sorted(
            os.path.join(self.root, d) for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d)))

    def _rotate(self):
        arts = self.artifacts()
        for stale in arts[:max(0, len(arts) - self.max_artifacts)]:
            shutil.rmtree(stale, ignore_errors=True)


def _start_profiler():
    """A started `torch.profiler` session: CPU activity, and the card's
    kernels and copies when there is a card."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profiler(prof, path: str) -> None:
    """End the session (after the card's queued work, so its kernels are
    in the trace) and write its Chrome trace, gzipped, to `path`."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    raw = path[:-len(".gz")]
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as src, gzip.open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(raw)


def load_trace_events(artifact_dir: str) -> List[dict]:
    """Parse the trace-event JSON out of a capture artifact (its
    `*.trace.json.gz`) — the "loadable" check tests and tools use without
    standing up Perfetto."""
    for dp, _dirs, files in os.walk(artifact_dir):
        for f in files:
            if f.endswith(".trace.json.gz"):
                with gzip.open(os.path.join(dp, f), "rt") as fh:
                    blob = json.load(fh)
                return blob.get("traceEvents", [])
    raise FileNotFoundError(
        f"no *.trace.json.gz under {artifact_dir}")


class StackSampler:
    """Low-overhead host-side stack sampling for named threads.

    A daemon thread snapshots `sys._current_frames()` every
    `interval_s` and, for each live thread whose name starts with one of
    `thread_prefixes`, counts the innermost application frame (and the
    full collapsed stack for flame-style aggregation). Threads outside
    the prefix set cost nothing; sampled threads cost one frame walk per
    tick — there are NO tracing hooks, so the sampled code runs at full
    speed between ticks.

    `stop()` (or `report()`) returns, per thread name, the top frames
    with sample counts and percentages — the attribution below the
    serving spans' granularity."""

    def __init__(self, interval_s: float = 0.005,
                 thread_prefixes: Sequence[str] = SERVING_THREAD_PREFIXES,
                 max_seconds: float = MAX_CAPTURE_SECONDS,
                 top: int = 10):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = float(interval_s)
        self.thread_prefixes = tuple(thread_prefixes)
        self.max_seconds = float(max_seconds)
        self.top = int(top)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # thread name -> Counter of "fn (file:line)" innermost frames
        self._frames: Dict[str, collections.Counter] = {}
        # thread name -> Counter of collapsed "a;b;c" stacks
        self._stacks: Dict[str, collections.Counter] = {}
        self._samples = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StackSampler":
        if self._thread is not None:
            raise RuntimeError("sampler already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="stack-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> Dict[str, object]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        return self.report()

    def __enter__(self) -> "StackSampler":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- sampling ----------------------------------------------------------
    def _loop(self):
        deadline = time.monotonic() + self.max_seconds
        while not self._stop.wait(self.interval_s):
            if time.monotonic() > deadline:
                return                     # bounded: never sample forever
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 — a torn frame snapshot
                continue       # (threads die mid-walk) is expected

    def _sample_once(self):
        names = {t.ident: t.name for t in threading.enumerate()
                 if t.name.startswith(self.thread_prefixes)}
        if not names:
            return
        frames = sys._current_frames()
        with self._lock:
            self._samples += 1
            for ident, name in names.items():
                frame = frames.get(ident)
                if frame is None:
                    continue
                stack = []
                f = frame
                while f is not None and len(stack) < 24:
                    code = f.f_code
                    stack.append(f"{code.co_name} "
                                 f"({os.path.basename(code.co_filename)}"
                                 f":{f.f_lineno})")
                    f = f.f_back
                self._frames.setdefault(
                    name, collections.Counter())[stack[0]] += 1
                self._stacks.setdefault(
                    name, collections.Counter())[";".join(
                        reversed(stack))] += 1

    # -- views -------------------------------------------------------------
    def report(self) -> Dict[str, object]:
        """{thread: {samples, top: [{frame, count, pct}]}} plus the
        total tick count — percentages are of that thread's samples."""
        with self._lock:
            out: Dict[str, object] = {"samples": self._samples,
                                      "interval_s": self.interval_s,
                                      "threads": {}}
            for name, ctr in sorted(self._frames.items()):
                n = sum(ctr.values())
                out["threads"][name] = {
                    "samples": n,
                    "top": [{"frame": fr, "count": c,
                             "pct": round(100.0 * c / n, 1)}
                            for fr, c in ctr.most_common(self.top)],
                }
            return out

    def top_stacks(self, thread: str, n: int = 5) -> List[Tuple[str, int]]:
        with self._lock:
            ctr = self._stacks.get(thread)
            return list(ctr.most_common(n)) if ctr else []
