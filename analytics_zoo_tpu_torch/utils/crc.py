"""CRC32C (Castagnoli) and TFRecord's masked CRC.

`crc32c` and `masked_crc32c` give the values of
`analytics_zoo_tpu/utils/crc.py`'s (L26, L33; the JAX package cannot be
imported without jax). The port's checkpoints (`learn/checkpoint.py`)
record an npz's CRC32C in its structure sidecar, as the JAX package's do,
so the values must be the same. The masked form frames TensorBoard
records (`utils/tensorboard.py`) and checks TF checkpoint entries
(`utils/tf_checkpoint.py`).

Short inputs take the table loop of that module byte by byte. A long one
(an image model's artifact is tens of MB) is cut into `lanes` equal
chunks whose CRCs numpy steps together, one byte of every chunk a step;
the chunk CRCs are then folded into one through the linear map of
`length` zero bytes (`_zeros_operator`), as zlib's `crc32_combine`
does."""

from __future__ import annotations

from typing import List

import numpy as np


def _build_table() -> List[int]:
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _build_table()
_NP_TABLE = np.array(_TABLE, np.uint32)
_SHORT = 1 << 16          # bytes below which the byte loop is quicker


def _gf2_apply(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _zeros_operator(length: int) -> List[int]:
    """The CRC register's map over `length` zero bytes, as 32 columns of
    a GF(2) matrix (the register update is linear in the register)."""
    tbl = _TABLE
    op = [tbl[(1 << i) & 0xFF] ^ ((1 << i) >> 8) for i in range(32)]
    result = [1 << i for i in range(32)]
    while length:
        if length & 1:
            result = [_gf2_apply(op, c) for c in result]
        op = [_gf2_apply(op, c) for c in op]
        length >>= 1
    return result


def _crc_bytes(data, reg: int) -> int:
    tbl = _TABLE
    for b in data:
        reg = tbl[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _crc_lanes(data: bytes, reg: int) -> int:
    """The register after `data`, the chunks' CRCs stepped together."""
    lanes = 1 << max(6, min(16, (len(data) // 256).bit_length() - 1))
    length = len(data) // lanes
    body = np.frombuffer(data, np.uint8, lanes * length)
    cols = np.ascontiguousarray(body.reshape(lanes, length).T)
    regs = np.zeros(lanes, np.uint32)
    for row in cols:
        regs = _NP_TABLE[(regs ^ row) & 0xFF] ^ (regs >> 8)
    shift = _zeros_operator(length)
    for r in regs.tolist():
        reg = _gf2_apply(shift, reg) ^ r
    return _crc_bytes(memoryview(data)[lanes * length:], reg)


def crc32c(data: bytes, crc: int = 0) -> int:
    reg = crc ^ 0xFFFFFFFF
    if len(data) < _SHORT:
        reg = _crc_bytes(data, reg)
    else:
        reg = _crc_lanes(bytes(data), reg)
    return reg ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15, add a constant."""
    crc = crc32c(data)
    return ((crc >> 15) | ((crc << 17) & 0xFFFFFFFF)) \
        + 0xA282EAD8 & 0xFFFFFFFF
