"""Per-card peak numbers for roofline and MFU accounting.

The port's counterpart of `analytics_zoo_tpu/utils/roofline.py`, which
lists TPU generations: this table lists NVIDIA cards only, keyed by a
substring of `torch.cuda.get_device_name()`. The figures are the
published dense peaks of the H100 SXM (NVIDIA's H100 data sheet, dense
rates without sparsity, at the full 700 W power limit): 989 TFLOP/s in
bf16 on the tensor cores, 1,979 TOP/s in int8 on the tensor cores, 67
TFLOP/s in float32 on the CUDA cores, 3.35 TB/s of HBM. An unknown card,
the CPU included, takes the H100 figures, as the JAX table takes v5e's for
an unknown TPU; a ratio read on such a device is against the H100.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

# name substring -> (bf16 FLOP/s, float32 FLOP/s, HBM bytes/s, int8 OP/s)
PEAKS = [
    ("H100", 989e12, 67e12, 3.35e12, 1979e12),
]
_DEFAULT = PEAKS[0]

DeviceLike = Union[None, str, torch.device]


def device_name(device: DeviceLike = None) -> str:
    """The card's name for a CUDA device (`None` is the current one when
    there is a card), "cpu" otherwise."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device                        # already a name
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _row(device: DeviceLike):
    name = device_name(device)
    for row in PEAKS:
        if row[0] in name:
            return row
    return _DEFAULT


def peak_flops(device: DeviceLike = None,
               dtype: Optional[torch.dtype] = torch.bfloat16) -> float:
    """Peak FLOP/s: bf16 tensor-core rate by default (the MFU
    denominator, as in the JAX package), the float32 rate for
    `dtype=torch.float32`, the dense int8 rate for `dtype=torch.int8`."""
    row = _row(device)
    if dtype == torch.int8:
        return row[4]
    return row[2] if dtype == torch.float32 else row[1]


def peak_hbm(device: DeviceLike = None) -> float:
    """Peak HBM bytes/s."""
    return _row(device)[3]
