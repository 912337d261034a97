"""Decode attention — single-token queries against the pooled KV cache, the
CUDA kernels and their plain versions.

Port of `analytics_zoo_tpu/pallas/decode_attention.py`: `_attend_window`
(L42), `_reference_decode_attention` (L59), `gather_kv_window` (L67),
`_reference_paged_decode_attention` (L80), the wrappers `decode_attention`
(L149) and `paged_decode_attention` (L265), and the kernels
`_decode_kernel` (L113) and `_paged_kernel` (L225), which become the one
template of `csrc/decode_attention.cu` (its note says what bounds it on an
H100 and how its design answers that).

Each generative decode step asks one question per slot: "given this
slot's ONE new query vector, attend over the first `lengths[s]` cached
positions of that slot's KV rows". The kernels read the pool in place: only
the first `kv_bucket` positions of each slot are visited, and of those only
the live ones.

Routing is static, as in the JAX package:
- a CPU tensor takes the plain version;
- a CUDA tensor launches the kernel, for any `kv_bucket` in [1, L]; a
  build or launch failure raises, and nothing falls back to the plain
  version. (The JAX wrapper sends a bucket its 128-key tiling does not
  divide to its exact path, L172-177; the CUDA kernel walks each slot's
  live positions and masks its last tile by the live length, so no bucket
  needs to divide.)

Within the port, paged equals contiguous bit for bit on the same logical
bytes: the plain versions gather the paged window and run the same
`_attend_window` on identically laid-out windows, and the two kernels are
one template that differs only in the address of a position.

Layouts are the JAX package's: q is `[S, H, D]`; the contiguous pools are
`[S, H, L, D]`; the block pools `[num_blocks, H, block_len, D]`; lengths
and tables are int32 `[S]` and `[S, T]`. `lengths` must be >= 1 per slot
(the engine passes dead slots length 1 and discards their rows); the
kernels leave a slot below 1 undefined.

Where a bucket would give one block a long walk, a launch splits each
(slot, head)'s live positions over a thread-block cluster of `n_split`
blocks (`_split_plan`, a function of the bucket alone, never of
`lengths`), and the cluster merges its blocks' softmax states in a fixed
order inside the launch: one launch a call, the same bits on every call,
and no host read of device data, so a CUDA graph can capture it. A plan
whose cluster does not fit on the card raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build, kernel_region

KERNEL_NAME = "decode_attention"
PAGED_NAME = "paged_decode_attention"
SOURCE = "decode_attention.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 128
# The split plan (csrc/decode_attention.cu): a block stages tiles of 64
# positions, and a walk of more than 8 tiles a block sets the launch's
# tail; a cluster holds at most 8 blocks (the portable cluster size).
_TILE = 64
_MAX_WALK = 8 * _TILE
_MAX_SPLIT = 8


def _attend_window(q, k, v, lengths, kv_bucket: int):
    """The shared exact-attention core: q [S, H, D] against a materialized
    window k/v [S, H, kv_bucket, D], masked past `lengths`. Scores are
    formed in q's dtype and divided by √D, softmaxed in f32 after masking
    with -1e30, and the weights cast back to q's dtype before the PV
    product (JAX L42-56)."""
    D = q.shape[-1]
    scores = torch.einsum("shd,shld->shl", q, k) / math.sqrt(D)
    scores = scores.float()
    pos = torch.arange(kv_bucket, dtype=torch.int32, device=q.device)
    mask = pos[None, None, :] < lengths[:, None, None]
    scores = torch.where(mask, scores, -1e30)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("shl,shld->shd", weights, v)


def _reference_decode_attention(q, k_pool, v_pool, lengths, kv_bucket: int):
    """Exact decode attention over the first `kv_bucket` pool positions.
    q: [S, H, D]; k_pool/v_pool: [S, H, L, D]; lengths: int32 [S]. The
    window is made contiguous so that it is laid out as the paged path's
    gathered window is, and the two give the same bits."""
    k = k_pool[:, :, :kv_bucket].contiguous()
    v = v_pool[:, :, :kv_bucket].contiguous()
    return _attend_window(q, k, v, lengths, kv_bucket)


def gather_kv_window(pool, tables, kv_bucket: int):
    """The logical [S, H, kv_bucket, D] window of a block pool
    [num_blocks, H, block_len, D] through per-sequence block tables
    [S, >= kv_bucket // block_len]: a pure gather, the blocks' bytes in
    logical position order."""
    _, H, block_len, D = pool.shape
    n_kb = kv_bucket // block_len
    tb = tables[:, :n_kb].long()                # [S, n_kb]
    g = pool[tb]                                # [S, n_kb, H, bl, D]
    g = g.movedim(2, 1)                         # [S, H, n_kb, bl, D]
    return g.reshape(g.shape[0], H, kv_bucket, D)


def _reference_paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                      kv_bucket: int):
    """Exact paged decode attention: gather the block window, then the
    same math as the contiguous plain version."""
    k = gather_kv_window(k_pool, tables, kv_bucket)
    v = gather_kv_window(v_pool, tables, kv_bucket)
    return _attend_window(q, k, v, lengths, kv_bucket)


def _check_q(q):
    if q.dim() != 3:
        raise ValueError(f"decode_attention: q must be [S, H, D], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.shape[-1] > _MAX_DIM:
        raise ValueError(f"decode_attention kernel takes a head dim up to "
                         f"{_MAX_DIM}, got {q.shape[-1]}")


def _check_pools(q, k_pool, v_pool, want_shape):
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if (tuple(t.shape) != tuple(want_shape) or t.dtype != q.dtype
                or t.device != q.device):
            raise ValueError(
                f"decode_attention: {name} {tuple(t.shape)} {t.dtype} "
                f"{t.device} must be {tuple(want_shape)} {q.dtype} "
                f"{q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention kernel needs {name} "
                             "contiguous and 16-byte aligned")


def _check_index(name, t, shape, device):
    if (t.dtype != torch.int32 or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"decode_attention kernel needs {name} contiguous "
                         f"int32 {tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} {t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _split_plan(kv_bucket: int) -> int:
    """The blocks of one (slot, head)'s cluster, `n_split`. On the card
    the cluster splits the slot's live positions [0, n) evenly: block r
    takes [r*c, min((r+1)*c, n)), with c the least multiple of 16 that is
    at least n / n_split, so a block of 16 (the engine's block_len) never
    straddles two blocks' spans.

    A split adds a block's fixed cost and the cluster's merge, so it pays
    only where one block would walk a long chain of tiles alone: on an
    H100 at the serving engine's 32 slots x 12 heads (PERF.md, rows 8-9)
    one block a (slot, head) was fastest up to kv 512 and two splits at
    kv 1024. So: as many splits as keep each block's walk to 512
    positions, at most 8. A function of the bucket alone: the lengths
    stay on the device."""
    return max(1, min(_MAX_SPLIT, -(-kv_bucket // _MAX_WALK)))


def _vec(q) -> int:
    """1 when a row of D elements is a whole number of 16-byte pieces."""
    return int(q.shape[-1] * q.element_size() % 16 == 0)


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_PAGED_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launch(q, k_pool, v_pool, lengths, kv_bucket: int) -> torch.Tensor:
    _check_q(q)
    S, H, D = q.shape
    L = k_pool.shape[2] if k_pool.dim() == 4 else -1
    _check_pools(q, k_pool, v_pool, (S, H, L, D))
    _check_index("lengths", lengths, (S,), q.device)
    fn = _build.bind(SOURCE, "azt_decode_attention", _ARGS)
    n_split = _split_plan(kv_bucket)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), S, H, L, D, kv_bucket,
                n_split, 1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype],
                _vec(q), _stream(q))
    _build.check_launch(SOURCE, rc,
                        f"{KERNEL_NAME} (cluster of {n_split})")
    LAUNCHES.add(KERNEL_NAME)
    return out


def _launch_paged(q, k_pool, v_pool, tables, lengths,
                  kv_bucket: int) -> torch.Tensor:
    _check_q(q)
    S, H, D = q.shape
    if k_pool.dim() != 4:
        raise ValueError("paged_decode_attention: pools must be "
                         "[num_blocks, H, block_len, D]")
    num_blocks, _, block_len, _ = k_pool.shape
    _check_pools(q, k_pool, v_pool, (num_blocks, H, block_len, D))
    _check_index("lengths", lengths, (S,), q.device)
    _check_index("tables", tables, (S, tables.shape[-1]), q.device)
    fn = _build.bind(SOURCE, "azt_paged_decode_attention", _PAGED_ARGS)
    n_split = _split_plan(kv_bucket)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), S, H,
                block_len, D, tables.shape[-1], kv_bucket, n_split,
                1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype], _vec(q),
                _stream(q))
    _build.check_launch(SOURCE, rc, f"{PAGED_NAME} (cluster of {n_split})")
    LAUNCHES.add(PAGED_NAME)
    return out


def decode_cost(q, kv_bucket: int, table_entries: int = 0):
    """(flops, bytes) of one decode step (JAX `_decode_cost` L95, declared
    at L199; `_paged_cost` L208 adds the block table's int32 entries):
    QKᵀ and PV over the bucket, the K and V windows streamed once."""
    S, H, D = q.shape
    item = q.element_size()
    kv_bytes = 2.0 * S * H * kv_bucket * D * item
    qo_bytes = 2.0 * S * H * D * item + 4.0 * S
    return (4.0 * S * H * kv_bucket * D,
            kv_bytes + qo_bytes + 4.0 * S * table_entries)


def _route(t: torch.Tensor, what: str) -> bool:
    """True to launch the kernel (a CUDA tensor), False for the plain
    version (a CPU tensor); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def decode_attention(q, k_pool, v_pool, lengths, kv_bucket: int
                     ) -> torch.Tensor:
    """One decode step of attention for every slot.

    q: [S, H, D] — the current token's query per slot.
    k_pool/v_pool: [S, H, L, D] — the whole KV pool; only positions
    [0, kv_bucket) are read (`kv_bucket` is the static serving bucket,
    `<= L`, chosen per step by the DecodeScheduler).
    lengths: int32 [S] — live KV length per slot, all >= 1; positions
    >= lengths[s] are masked. Returns [S, H, D] in q's dtype."""
    L = k_pool.shape[2]
    if not 1 <= kv_bucket <= L:
        raise ValueError(f"kv_bucket {kv_bucket} outside [1, {L}]")
    with kernel_region(decode_cost, q, kv_bucket):
        lengths = lengths.to(torch.int32)
        if not _route(q, KERNEL_NAME):
            return _reference_decode_attention(q, k_pool, v_pool, lengths,
                                               kv_bucket)
        return _launch(q, k_pool, v_pool, lengths, kv_bucket)


def paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                           kv_bucket: int) -> torch.Tensor:
    """One decode step of attention for every slot, KV read through
    per-sequence block tables.

    q: [S, H, D]; k_pool/v_pool: [num_blocks, H, block_len, D] — slot
    ``s``'s logical positions ``[j*block_len, (j+1)*block_len)`` live in
    physical block ``tables[s, j]``. tables: int32 [S, T] with
    ``T >= kv_bucket // block_len``; entries past a slot's live length may
    point at any valid block (the scratch block by convention), since
    masking is by `lengths`. lengths: int32 [S], all >= 1.
    Returns [S, H, D] in q's dtype."""
    block_len = k_pool.shape[2]
    if kv_bucket < 1 or kv_bucket % block_len:
        raise ValueError(
            f"kv_bucket {kv_bucket} must be a positive multiple of "
            f"block_len {block_len}")
    n_kb = kv_bucket // block_len
    if tables.shape[-1] < n_kb:
        raise ValueError(
            f"block table has {tables.shape[-1]} entries, kv_bucket "
            f"{kv_bucket} needs {n_kb}")
    with kernel_region(decode_cost, q, kv_bucket, n_kb):
        lengths = lengths.to(torch.int32)
        tables = tables.to(torch.int32)
        if not _route(q, PAGED_NAME):
            return _reference_paged_decode_attention(
                q, k_pool, v_pool, tables, lengths, kv_bucket)
        return _launch_paged(q, k_pool, v_pool, tables.contiguous(),
                             lengths, kv_bucket)
