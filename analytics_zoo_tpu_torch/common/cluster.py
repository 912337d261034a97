"""Multi-process cluster bootstrap — the RayOnSpark-role launcher.

Port of `analytics_zoo_tpu/common/cluster.py` (L1-190): `ProcessMonitor`
(L78), `launch_local_cluster` (L132), `wait_all` and the `--worker`
entry (`_worker_main`, L159).

JAX gives one process several CPU devices (`force_cpu_devices`, L40),
which has no counterpart: in the port one process is one rank, so
`devices_per_process` other than 1 raises. `platform="cpu"` spawns gloo
ranks on the CPU; `platform="cuda"` puts every rank on one of the visible
cards (`rank % cards`), sharing a card when there are fewer cards than
ranks (the context then picks gloo: NCCL refuses two ranks on one
device). Rendezvous goes through a `FileStore` in a fresh temporary
directory, not a port: groups spawned at once by parallel test workers
cannot race for one. The directory is removed when the monitor's wait
returns or it terminates the group.

    # run fn on 2 CPU ranks:
    wait_all(launch_local_cluster("my_module:main", num_processes=2))

Worker side (any real deployment):
    python -m analytics_zoo_tpu_torch.common.cluster \\
        --worker my_module:main --coordinator host0:29500 \\
        --num-processes 8 --process-id $RANK
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["launch_local_cluster", "wait_all", "ProcessMonitor"]


class ProcessMonitor:
    """Tracks spawned workers; kills the whole group on exit/failure
    (`ProcessMonitor`/`JVMGuard` semantics, `ray/process.py:90`)."""

    def __init__(self, procs: Sequence[subprocess.Popen],
                 cleanup: Sequence[str] = ()):
        self.procs = list(procs)
        self.cleanup = list(cleanup)

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        """Wait for all; on any nonzero exit, terminate the rest (fail
        fast like a barrier job). Returns exit codes."""
        deadline = None if timeout is None else time.time() + timeout
        codes: Dict[int, int] = {}
        try:
            while len(codes) < len(self.procs):
                for i, p in enumerate(self.procs):
                    if i in codes:
                        continue
                    rc = p.poll()
                    if rc is not None:
                        codes[i] = rc
                        if rc != 0:
                            self.terminate()
                            raise RuntimeError(
                                f"worker {i} exited with {rc}; cluster "
                                "terminated")
                if deadline and time.time() > deadline:
                    self.terminate()
                    raise TimeoutError("cluster wait timed out")
                time.sleep(0.05)
        except BaseException:
            self.terminate()
            raise
        self._remove()
        return [codes[i] for i in range(len(self.procs))]

    def terminate(self):
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        t0 = time.time()
        while time.time() - t0 < 5:
            if all(p.poll() is not None for p in self.procs):
                break
            time.sleep(0.05)
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.kill()
                    p.wait(5)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        self._remove()

    def _remove(self):
        for path in self.cleanup:
            shutil.rmtree(path, ignore_errors=True)
        self.cleanup = []


def rendezvous_dir() -> str:
    """A fresh directory for one group's `FileStore`."""
    return tempfile.mkdtemp(prefix="zoo-rdzv-")


def launch_local_cluster(worker: str, num_processes: int,
                         devices_per_process: int = 1,
                         worker_args: Sequence[str] = (),
                         env: Optional[Dict[str, str]] = None,
                         platform: str = "cpu") -> ProcessMonitor:
    """Spawn `num_processes` local worker processes, one rank each, that
    rendezvous through a `FileStore` — an N-host cluster on one machine.
    `worker` is "module:function"; it runs after `init_zoo_context(...,
    cluster_mode="multi-host")` and before `stop_orca_context()`."""
    if devices_per_process != 1:
        raise ValueError(
            "devices_per_process must be 1: a torch process is one rank on "
            "one device (the JAX package gives one process several CPU "
            "devices); ask for more processes instead")
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"platform must be 'cpu' or 'cuda', got "
                         f"{platform!r}")
    rdzv = rendezvous_dir()
    coordinator = "file://" + os.path.join(rdzv, "store")
    procs = []
    for pid in range(num_processes):
        cmd = [sys.executable, "-m", "analytics_zoo_tpu_torch.common.cluster",
               "--worker", worker, "--coordinator", coordinator,
               "--num-processes", str(num_processes),
               "--process-id", str(pid),
               "--platform", platform, "--", *worker_args]
        penv = dict(os.environ)
        penv["ZOO_LOCAL_PROCESSES"] = str(num_processes)
        if platform == "cpu":
            penv["ZOO_DEVICE"] = "cpu"
        else:
            penv.pop("ZOO_DEVICE", None)
        penv.update(env or {})
        procs.append(subprocess.Popen(cmd, env=penv))
    return ProcessMonitor(procs, cleanup=[rdzv])


def wait_all(monitor: ProcessMonitor, timeout: Optional[float] = None):
    return monitor.wait(timeout)


def _worker_main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--worker", required=True, help="module:function")
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--platform", default=None)
    p.add_argument("rest", nargs="*")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch.common.config import ZooConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        stop_orca_context)
    cfg = ZooConfig()
    cfg.coordinator_address = args.coordinator
    cfg.num_processes = args.num_processes
    cfg.process_id = args.process_id
    if args.platform == "cpu":
        cfg.device = "cpu"
    init_zoo_context(cfg, cluster_mode="multi-host")
    try:
        mod_name, _, fn_name = args.worker.partition(":")
        fn = getattr(importlib.import_module(mod_name), fn_name or "main")
        result = fn(*args.rest)
    finally:
        stop_orca_context()
    return int(result) if isinstance(result, int) else 0


if __name__ == "__main__":
    sys.exit(_worker_main())
