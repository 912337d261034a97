"""Kernels written by hand for Hopper, one module per Pallas kernel of the
JAX package (`analytics_zoo_tpu/pallas/`), sources under `../csrc/`.

Each kernel module keeps the plain PyTorch version of its function beside
the wrapper. The wrapper takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises. Every launch adds
one to the kernel's count in `LAUNCHES`, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import threading
from typing import Dict


class LaunchCounter:
    """Per-kernel launch counts (plain integers), safe to bump from the
    serving threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts = {}


LAUNCHES = LaunchCounter()
