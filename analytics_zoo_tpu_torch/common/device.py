"""Device resolution shared by the port's entry points.

The port runs on the card: `device=None` means `cuda`. The CPU is used only
when the caller names it (the tests do). Asking for `cuda` on a host without
a GPU raises; nothing continues silently on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` → `cuda`; a CUDA device without a GPU raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev
