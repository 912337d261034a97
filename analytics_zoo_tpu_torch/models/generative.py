"""Tiny causal-LM decoder — the generative model contract decode mode serves.

Port of `analytics_zoo_tpu/models/generative.py`: `_layer_norm` (L54) and
`TinyDecoder` (L60) with `init_params`, `init_kv`, `prefill_fn` (L108),
`step_fn` (L146), `init_kv_blocks`, `paged_prefill_fn` (L191) and
`paged_step_fn` (L281). The architecture is GPT-2's: pre-LN blocks,
learned positions, a tanh-GELU MLP and an untied head, with no attention
biases.

What the serving engine (`serving/decode.py`) needs from a model:

- ``init_params(seed)`` — a host tree of numpy weights, the same draws in
  the same order as the JAX package, so both packages serve identical
  weights from one seed; `InferenceModel.load_generative` moves it to the
  device.
- ``init_kv(slots, max_kv_len)`` — the pooled KV cache on the model's
  device: per layer a ``{"k","v"}: [slots, heads, max_kv_len, head_dim]``
  pair, one buffer per layer for the whole pool.
- ``prefill_fn(params, kv, tokens, length, slot)`` — run the prompt
  (padded to a prompt bucket) through the stack, write its KV into pool
  rows ``[slot, :, 0:len(tokens)]`` and return ``(kv, logits)`` with the
  logits at position ``length - 1``: the first generated token comes out
  of prefill itself.
- ``step_fn(params, kv, tokens, positions, kv_bucket)`` — one decode step
  for every slot: embed ``tokens[s]`` at ``positions[s]``, write the new
  K/V at ``positions[s]``, attend over the first ``positions[s] + 1``
  positions through the decode-attention kernel and return
  ``(kv, logits[s])``.
- the paged pair over a block pool (``init_kv_blocks``): the same math,
  with KV reached through per-sequence block tables.

The JAX functions are functional: each returns a new KV tree. Here the
pools are updated in place and returned, so the engine's rebinding of
``pool.kv`` keeps working; within a layer every KV write precedes the
attention that reads it (decode steps) or follows the context read
(paged prefill chunks), as in the JAX code. Where JAX clamps an index
(gathers, `dynamic_index_in_dim`, `dynamic_update_slice`) the index is
clamped here, and where it drops an out-of-bounds scatter (a padded
prefill chunk's rows) the write is redirected to the chunk's last real row
with that row's own values, so the shapes stay static and nothing is read
back to the host. Prefill attention stays plain `torch` (the JAX prefill is
a plain einsum, no Pallas kernel); only the decode steps run the kernels,
once per layer, when ``use_pallas`` is set.

Every program is capture-safe: the per-call integers (``length``,
``slot``, ``pre_len``, ``chunk_len``) may be host integers or int tensors
of one element on the device, and are used only as tensors (indices of
`index_put_` / `index_select`, operands of comparisons), never read back;
tokens, positions and tables may be device tensors. There is no host sync
and no allocation whose size depends on a value, so
`InferenceModel.warmup_generative*` can capture each program as a CUDA
graph over static device buffers, and the KV writes stay in place in the
pool the graph was captured on.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.keras.layers import get_activation
from analytics_zoo_tpu_torch.kernels.decode_attention import (
    _reference_decode_attention, _reference_paged_decode_attention,
    decode_attention, gather_kv_window, paged_decode_attention)


def _layer_norm(x, g, b, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


_gelu = get_activation("gelu")      # jax.nn.gelu's default, the tanh form


def _causal_mask(n: int, device) -> torch.Tensor:
    causal = torch.tril(torch.ones((n, n), dtype=torch.float32,
                                   device=device))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(causal > 0, zero, -1e30)


def _ids(x, device) -> torch.Tensor:
    """Token ids, positions or tables as int64 on `device` (numpy or
    tensor in)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _scalar(x, device) -> torch.Tensor:
    """A per-call integer as an int64 tensor of one element on `device`: a
    host integer, or an int tensor of one element (a graph's static
    buffer), never read back."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).reshape(1)
    return torch.tensor([int(x)], dtype=torch.int64, device=device)


def _mlp(x, lp):
    h2 = _layer_norm(x, lp["ln2_g"], lp["ln2_b"])
    return x + (_gelu(h2 @ lp["w1"] + lp["b1"]) @ lp["w2"] + lp["b2"])


class TinyDecoder:
    """Minimal functional causal LM exposing the decode-mode contract.

    `use_pallas` selects the CUDA decode-attention kernels in the decode
    steps (the name is the JAX package's, where it selects the Pallas
    kernels); off, the steps call the plain versions. `device` is where
    `init_kv` / `init_kv_blocks` allocate the pools: `None` is `cuda`."""

    def __init__(self, vocab: int = 64, n_layers: int = 2,
                 n_heads: int = 2, head_dim: int = 8,
                 max_len: int = 256, mlp_mult: int = 2,
                 use_pallas: bool = True, device: DeviceLike = None):
        self.vocab = int(vocab)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.embed_dim = self.n_heads * self.head_dim
        self.max_len = int(max_len)
        self.mlp_dim = self.embed_dim * int(mlp_mult)
        self.use_pallas = bool(use_pallas)
        self.device = resolve_device(device)

    # -- weights / cache ---------------------------------------------------
    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Host numpy weights, drawn exactly as the JAX package draws them
        (one generator, the same shapes in the same order)."""
        rng = np.random.default_rng(seed)
        E, M, V = self.embed_dim, self.mlp_dim, self.vocab

        def w(*shape, scale=0.08):
            return rng.normal(0.0, scale, shape).astype(np.float32)

        layers: List[Dict[str, np.ndarray]] = []
        for _ in range(self.n_layers):
            layers.append({
                "wq": w(E, E), "wk": w(E, E), "wv": w(E, E), "wo": w(E, E),
                "w1": w(E, M), "b1": np.zeros(M, np.float32),
                "w2": w(M, E), "b2": np.zeros(E, np.float32),
                "ln1_g": np.ones(E, np.float32),
                "ln1_b": np.zeros(E, np.float32),
                "ln2_g": np.ones(E, np.float32),
                "ln2_b": np.zeros(E, np.float32),
            })
        return {"embed": w(V, E, scale=0.5), "pos": w(self.max_len, E),
                "layers": layers,
                "lnf_g": np.ones(E, np.float32),
                "lnf_b": np.zeros(E, np.float32),
                "head": w(E, V, scale=0.3)}

    def _pools(self, shape):
        return [{"k": torch.zeros(shape, dtype=torch.float32,
                                  device=self.device),
                 "v": torch.zeros(shape, dtype=torch.float32,
                                  device=self.device)}
                for _ in range(self.n_layers)]

    def init_kv(self, slots: int, max_kv_len: int):
        return self._pools((slots, self.n_heads, max_kv_len, self.head_dim))

    def init_kv_blocks(self, num_blocks: int, block_len: int):
        return self._pools((num_blocks, self.n_heads, block_len,
                            self.head_dim))

    # -- prefill -----------------------------------------------------------
    def _causal_attention(self, q, k, v, mask, dtype):
        """The prefill's plain attention over the prompt itself (JAX
        L123-127): scores in the working dtype, the causal mask added in
        f32, softmax, PV."""
        D = self.head_dim
        scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
        scores = scores.float() + mask[None]
        w = torch.softmax(scores, dim=-1).to(dtype)
        return torch.einsum("hqk,khd->qhd", w, v).reshape(q.shape[0], -1)

    def prefill_fn(self, params, kv, tokens, length, slot):
        """tokens: int [P] (bucket-padded prompt); length, slot: integers
        (host, or one-element device tensors). Writes the prompt's KV into
        pool rows [slot, :, :P] and returns (kv, logits[vocab]) at the last
        real prompt position."""
        dev = params["embed"].device
        tok = _ids(tokens, dev)
        P = tok.shape[0]
        H, D = self.n_heads, self.head_dim
        x = params["embed"][tok] + params["pos"][:P]        # [P, E]
        mask = _causal_mask(P, dev)
        # dynamic_update_slice clamps its start so the update fits
        slot = _scalar(slot, dev).clamp(0, kv[0]["k"].shape[0] - 1)
        for lp, lkv in zip(params["layers"], kv):
            h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
            q = (h @ lp["wq"]).reshape(P, H, D)
            k = (h @ lp["wk"]).reshape(P, H, D)
            v = (h @ lp["wv"]).reshape(P, H, D)
            att = self._causal_attention(q, k, v, mask, x.dtype)
            x = x + att @ lp["wo"]
            x = _mlp(x, lp)
            # park this prompt's KV into the pool rows of `slot`
            lkv["k"][slot, :, :P] = k.transpose(0, 1)[None]
            lkv["v"][slot, :, :P] = v.transpose(0, 1)[None]
        last = (_scalar(length, dev) - 1).clamp(0, P - 1)
        x_last = _layer_norm(x.index_select(0, last)[0], params["lnf_g"],
                             params["lnf_b"])
        return kv, x_last @ params["head"]

    # -- decode step -------------------------------------------------------
    def step_fn(self, params, kv, tokens, positions, kv_bucket: int):
        """tokens/positions: int [S]. One token per slot; the KV write
        lands at ``positions[s]`` and attention covers the first
        ``positions[s] + 1`` positions, windowed to the static
        ``kv_bucket``. Returns (kv, logits[S, vocab])."""
        dev = params["embed"].device
        tok = _ids(tokens, dev)
        positions = _ids(positions, dev)
        S = tok.shape[0]
        H, D = self.n_heads, self.head_dim
        rows = torch.arange(S, device=dev)[:, None]          # [S, 1]
        heads = torch.arange(H, device=dev)[None, :]         # [1, H]
        x = params["embed"][tok] + params["pos"][
            positions.clamp(0, self.max_len - 1)]            # [S, E]
        lengths = positions.to(torch.int32) + 1
        col = positions[:, None]
        for lp, lkv in zip(params["layers"], kv):
            h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
            q = (h @ lp["wq"]).reshape(S, H, D)
            k = (h @ lp["wk"]).reshape(S, H, D)
            v = (h @ lp["wv"]).reshape(S, H, D)
            lkv["k"][rows, heads, col] = k
            lkv["v"][rows, heads, col] = v
            if self.use_pallas:
                att = decode_attention(q, lkv["k"], lkv["v"], lengths,
                                       kv_bucket)
            else:
                att = _reference_decode_attention(q, lkv["k"], lkv["v"],
                                                  lengths, kv_bucket)
            x = x + att.reshape(S, -1) @ lp["wo"]
            x = _mlp(x, lp)
        x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
        return kv, x @ params["head"]

    # -- paged contract ----------------------------------------------------
    # Same math, block-pool memory layout: the cache is one pool of
    # ref-counted [heads, block_len, head_dim] blocks per layer and each
    # sequence owns an ordered block table. Greedy outputs equal the
    # contiguous contract's bit for bit because every numeric op is the
    # same — only where the KV bytes live changes.
    def paged_prefill_fn(self, params, kv, tokens, table, pre_len,
                         chunk_len, kv_bucket: int):
        """One prefill chunk of a prompt, KV parked through the block
        table.

        tokens: int [Cb] — this chunk, padded to a chunk bucket. table:
        int [T] — the sequence's block table (covers at least
        ``pre_len + chunk_len`` logical positions). pre_len, chunk_len:
        integers (host, or one-element device tensors) — tokens already
        in KV, and real tokens in this chunk (>= 1). kv_bucket: the
        context window covering ``pre_len`` (0 on a fresh first chunk).

        Returns (kv, logits[vocab]) at chunk position ``chunk_len - 1`` —
        the first generated token on the final chunk.

        The ``kv_bucket == 0`` branch is op for op `prefill_fn` at the
        same shapes, so a fresh single-chunk prompt gives the same
        first-token logits bit for bit (the paged-parity anchor)."""
        dev = params["embed"].device
        tok = _ids(tokens, dev)
        table = _ids(table, dev)
        Cb = tok.shape[0]
        H, D = self.n_heads, self.head_dim
        bl = kv[0]["k"].shape[2]
        pre_len, chunk_len = _scalar(pre_len, dev), _scalar(chunk_len, dev)
        heads = torch.arange(H, device=dev)[None, :]         # [1, H]
        idx = torch.arange(Cb, device=dev)
        logical = pre_len + idx                              # [Cb]
        if kv_bucket == 0:
            x = params["embed"][tok] + params["pos"][:Cb]
        else:
            # a gather (not a slice) so real positions near max_len are
            # never shifted by start-clamping
            x = params["embed"][tok] + params["pos"][
                logical.clamp(0, self.max_len - 1)]
        mask = _causal_mask(Cb, dev)
        # KV destinations. JAX routes the pad rows (idx >= chunk_len) out
        # of bounds and drops them; here each pad row writes the last real
        # row's values to that row's own place — the same bytes twice —
        # so a padded chunk never touches another position.
        src = torch.minimum(idx, chunk_len.clamp(min=1) - 1)
        dst = logical[src]
        blk = table[(dst // bl).clamp(0, table.shape[0] - 1)][:, None]
        off = (dst % bl)[:, None]
        for lp, lkv in zip(params["layers"], kv):
            h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
            q = (h @ lp["wq"]).reshape(Cb, H, D)
            k = (h @ lp["wk"]).reshape(Cb, H, D)
            v = (h @ lp["wv"]).reshape(Cb, H, D)
            if kv_bucket == 0:
                att = self._causal_attention(q, k, v, mask, x.dtype)
            else:
                # context (earlier logical positions, read through the
                # table before this chunk's writes) ++ in-chunk causal
                ctx_k = gather_kv_window(lkv["k"], table[None],
                                         kv_bucket)[0]        # [H,kvb,D]
                ctx_v = gather_kv_window(lkv["v"], table[None],
                                         kv_bucket)[0]
                ctx_s = torch.einsum("qhd,hkd->hqk", q, ctx_k) / math.sqrt(D)
                cpos = torch.arange(kv_bucket, device=dev)
                ctx_s = torch.where(cpos[None, None, :] < pre_len,
                                    ctx_s.float(), -1e30)
                chn_s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
                chn_s = chn_s.float() + mask[None]
                scores = torch.cat([ctx_s, chn_s], dim=-1)
                w = torch.softmax(scores, dim=-1).to(x.dtype)
                att = (torch.einsum("hqk,hkd->qhd", w[..., :kv_bucket],
                                    ctx_v)
                       + torch.einsum("hqk,khd->qhd", w[..., kv_bucket:],
                                      v)).reshape(Cb, -1)
            x = x + att @ lp["wo"]
            x = _mlp(x, lp)
            lkv["k"][blk, heads, off] = k[src]
            lkv["v"][blk, heads, off] = v[src]
        last = (chunk_len - 1).clamp(0, Cb - 1)
        x_last = _layer_norm(x.index_select(0, last)[0], params["lnf_g"],
                             params["lnf_b"])
        return kv, x_last @ params["head"]

    def paged_step_fn(self, params, kv, tokens, positions, tables,
                      kv_bucket: int):
        """One decode step for every lane, KV routed through per-lane
        block tables. tokens/positions: int [S]; tables: int [S, T]. Dead
        lanes carry all-scratch tables and position 0, so their (discarded)
        KV write lands in the reserved scratch block and never touches a
        live block."""
        dev = params["embed"].device
        tok = _ids(tokens, dev)
        positions = _ids(positions, dev)
        tables = _ids(tables, dev).to(torch.int32)
        S = tok.shape[0]
        H, D = self.n_heads, self.head_dim
        bl = kv[0]["k"].shape[2]
        heads = torch.arange(H, device=dev)[None, :]         # [1, H]
        x = params["embed"][tok] + params["pos"][
            positions.clamp(0, self.max_len - 1)]            # [S, E]
        lengths = positions.to(torch.int32) + 1
        blk = tables.gather(1, (positions // bl)[:, None]).long()   # [S,1]
        off = (positions % bl)[:, None]
        for lp, lkv in zip(params["layers"], kv):
            h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
            q = (h @ lp["wq"]).reshape(S, H, D)
            k = (h @ lp["wk"]).reshape(S, H, D)
            v = (h @ lp["wv"]).reshape(S, H, D)
            lkv["k"][blk, heads, off] = k
            lkv["v"][blk, heads, off] = v
            if self.use_pallas:
                att = paged_decode_attention(q, lkv["k"], lkv["v"], tables,
                                             lengths, kv_bucket)
            else:
                att = _reference_paged_decode_attention(
                    q, lkv["k"], lkv["v"], tables, lengths, kv_bucket)
            x = x + att.reshape(S, -1) @ lp["wo"]
            x = _mlp(x, lp)
        x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
        return kv, x @ params["head"]
