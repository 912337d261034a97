"""Transformer blocks and the BERT encoder as Keras-style layers.

Port of `analytics_zoo_tpu/keras/transformer.py`: `dot_product_attention`
(L44), `MultiHeadSelfAttention` (L71), `TransformerEncoderBlock` (L127),
`TransformerLayer` (L187), `stack_block_params` / `unstack_block_params`
(L238/L252) and `BERT` (L261) with `make_mask` (L358). Same math, same
layouts:

- fused QKV: one `[D, 3D]` matmul, reshaped `(B, T, 3, H, Dh)`;
- attention on `[B, H, T, Dh]` with an additive `[B, 1, 1, T]` mask of
  -10000 on padded keys; `use_flash` runs the CUDA flash-attention kernel
  (`kernels/flash_attention.py`) on the card;
- post-norm blocks: x + MHA → LN → x + FFN(tanh-gelu) → LN, eps 1e-12.

Dense weights are stored `[in, out]` as in the JAX package, so a JAX
parameter tree maps onto the port's state dict by name alone
(`convert.py`). The stacked layout (`BERT(stacked=True)`, one `[L, ...]`
buffer per tensor, a `lax.scan` over blocks) has no counterpart in eager
PyTorch: the port keeps one module per block and `convert.py` accepts both
JAX layouts.

Dropout runs where the JAX package runs it, when `training` and a seed are
given (the JAX `rng`): after the embedding LayerNorm, on the attention
weights (inside the flash kernels with `use_flash`), on the attention
output and after the FFN of every block. Each site's seed derives from its
parent's by a fixed rule (`kernels.philox.site_seed(seed, site index)`),
the port's stand-in for splitting a `jax.random` key, so one integer
reproduces a whole step. In a training step the seed is a
`philox.DeviceSeed` (the step seed in the trainer's scalar table on the
device): a site's seed is then the step seed and its static path of site
indices, which the kernels follow on the card, so a step captured as a
CUDA graph draws new masks at every replay.

`BERT(remat=True)` (JAX L272-279, the unstacked loop L395-402) recomputes
each block in the backward instead of keeping its activations:
`torch.utils.checkpoint` (non-reentrant) around every block. The JAX
policy, `dots_with_no_batch_dims_saveable`, saves nothing inside a block
(every product carries the batch), which is what a whole-block checkpoint
does. The block's parameters enter the checkpointed function as arguments,
so the recompute reads the tensors the forward read (the bf16 casts of a
mixed-precision step, not the f32 masters). The dropout masks come from
seeds, not generator state, so the recompute draws the same ones: a remat
step computes bitwise what a plain step computes. It launches the forward
kernels of a block twice a step (flash attention and the block's two
dropout sites), and keeps none of a block's activations, the flash
forward's O and lse included, past the block.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.common.tree import tree_map
from analytics_zoo_tpu_torch.keras.engine import Layer, new_parameter
from analytics_zoo_tpu_torch.keras.layers import (LayerNormalization, fill_,
                                                  get_activation, get_init)
from analytics_zoo_tpu_torch.kernels.dropout import fused_dropout
from analytics_zoo_tpu_torch.kernels.flash_attention import (
    _reference_attention, flash_attention)
from analytics_zoo_tpu_torch.kernels.philox import Seed, site_seed
from analytics_zoo_tpu_torch.serving.quantization import maybe_int8_matmul


def _dropout(seed: Seed, rate: float, x):
    """Shared inverted dropout: the dropout kernel on the card."""
    return fused_dropout(x, rate, seed=seed)


def _site_seeds(training: bool, seed: Optional[Seed], n: int):
    """The seeds of a layer's `n` dropout sites, or Nones when the layer
    runs without dropout (not training, or no seed — as the JAX layers do
    without an `rng`)."""
    if not training or seed is None:
        return [None] * n
    return [site_seed(seed, i) for i in range(n)]


def dot_product_attention(q, k, v, mask=None,
                          dropout_seed: Optional[int] = None,
                          dropout_rate: float = 0.0,
                          use_flash: bool = False):
    """q, k, v: `[B, H, T, Dh]`; mask: additive `[B,1,1,T]` or `[B,1,T,T]`.
    Softmax statistics in f32 whatever the input dtype. With `use_flash`
    the flash kernels run forward and backward, with attention dropout
    inside them; without, dropout runs on the weights through the dropout
    kernel (JAX L59-68)."""
    no_drop = dropout_seed is None or dropout_rate == 0.0
    if use_flash:
        return flash_attention(q, k, v, mask=mask,
                               dropout_rate=0.0 if no_drop else dropout_rate,
                               dropout_seed=None if no_drop else dropout_seed)
    if no_drop:
        return _reference_attention(q, k, v, mask)
    depth = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(depth)
    scores = scores.float()
    if mask is not None:
        scores = scores + mask
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    weights = _dropout(dropout_seed, dropout_rate, weights)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


class MultiHeadSelfAttention(Layer):
    """Fused-QKV self attention."""

    def __init__(self, hidden_size: int, n_head: int,
                 attn_dropout: float = 0.0, output_dropout: float = 0.0,
                 use_flash: bool = False, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name)
        if hidden_size % n_head:
            raise ValueError(f"hidden_size {hidden_size} not divisible by "
                             f"n_head {n_head}")
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.head_dim = hidden_size // n_head
        self.attn_dropout = attn_dropout
        self.output_dropout = output_dropout
        self.use_flash = use_flash
        d = hidden_size
        self.qkv_kernel = new_parameter((d, 3 * d), device, dtype)
        self.qkv_bias = new_parameter((3 * d,), device, dtype)
        self.out_kernel = new_parameter((d, d), device, dtype)
        self.out_bias = new_parameter((d,), device, dtype)

    def build(self, generator):
        init = get_init("glorot_uniform")
        fill_(self.qkv_kernel, init(generator, tuple(self.qkv_kernel.shape)))
        fill_(self.qkv_bias, torch.zeros(self.qkv_bias.shape))
        fill_(self.out_kernel, init(generator, tuple(self.out_kernel.shape)))
        fill_(self.out_bias, torch.zeros(self.out_bias.shape))
        return self

    def call(self, x, *, training: bool = False,
             seed: Optional[int] = None, mask=None):
        if isinstance(x, (list, tuple)):
            x, mask = x
        attn_seed, out_seed = _site_seeds(training, seed, 2)
        B, T, D = x.shape
        qkv = maybe_int8_matmul(x, self, "qkv_kernel") + self.qkv_bias
        # (B, T, 3, H, Dh) → (3, B, H, T, Dh): one copy leaves q, k and v
        # each contiguous [B, H, T, Dh], as the kernel takes them
        qkv = qkv.reshape(B, T, 3, self.n_head, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        ctx = dot_product_attention(q, k, v, mask=mask,
                                    dropout_seed=attn_seed,
                                    dropout_rate=self.attn_dropout,
                                    use_flash=self.use_flash)
        ctx = ctx.permute(0, 2, 1, 3).reshape(B, T, D)
        out = maybe_int8_matmul(ctx, self, "out_kernel") + self.out_bias
        if out_seed is not None and self.output_dropout > 0:
            out = _dropout(out_seed, self.output_dropout, out)
        return out


class TransformerEncoderBlock(Layer):
    """Post-norm BERT block: x + MHA → LN → x + FFN(gelu) → LN."""

    def __init__(self, hidden_size: int, n_head: int,
                 intermediate_size: Optional[int] = None,
                 hidden_dropout: float = 0.1, attn_dropout: float = 0.1,
                 hidden_act: str = "gelu", use_flash: bool = False,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.attn = MultiHeadSelfAttention(
            hidden_size, n_head, attn_dropout=attn_dropout,
            output_dropout=hidden_dropout, use_flash=use_flash,
            device=device, dtype=dtype, name=self.name + "_attn")
        self.ln1 = LayerNormalization(hidden_size, device=device, dtype=dtype,
                                      name=self.name + "_ln1")
        self.ln2 = LayerNormalization(hidden_size, device=device, dtype=dtype,
                                      name=self.name + "_ln2")
        self.act = get_activation(hidden_act)
        self.hidden_dropout = hidden_dropout
        d, f = hidden_size, self.intermediate_size
        self.ffn_in_kernel = new_parameter((d, f), device, dtype)
        self.ffn_in_bias = new_parameter((f,), device, dtype)
        self.ffn_out_kernel = new_parameter((f, d), device, dtype)
        self.ffn_out_bias = new_parameter((d,), device, dtype)

    def build(self, generator):
        super().build(generator)
        init = get_init("glorot_uniform")
        fill_(self.ffn_in_kernel,
              init(generator, tuple(self.ffn_in_kernel.shape)))
        fill_(self.ffn_in_bias, torch.zeros(self.ffn_in_bias.shape))
        fill_(self.ffn_out_kernel,
              init(generator, tuple(self.ffn_out_kernel.shape)))
        fill_(self.ffn_out_bias, torch.zeros(self.ffn_out_bias.shape))
        return self

    def call(self, x, *, training: bool = False,
             seed: Optional[int] = None, mask=None):
        if isinstance(x, (list, tuple)):
            x, mask = x
        attn_seed, ffn_seed = _site_seeds(training, seed, 2)
        a = self.attn.call(x, training=training, seed=attn_seed, mask=mask)
        x = self.ln1.call(x + a)
        h = self.act(maybe_int8_matmul(x, self, "ffn_in_kernel")
                     + self.ffn_in_bias)
        h = maybe_int8_matmul(h, self, "ffn_out_kernel") + self.ffn_out_bias
        if ffn_seed is not None and self.hidden_dropout > 0:
            h = _dropout(ffn_seed, self.hidden_dropout, h)
        return self.ln2.call(x + h)


class TransformerLayer(Layer):
    """A transformer stack over token ids (`TransformerLayer.scala:56`):
    word and position embeddings, N(0, 0.02) at build, then `n_block`
    post-norm encoder blocks without a mask (the JAX layer passes none:
    every position attends to every other). `[B, T]` ids give `[B, T,
    hidden]`. With `use_flash` each block runs the flash-attention kernel
    on the card. Dropout follows the JAX layer: after the embeddings, then
    inside each block, each site's seed derived from the node's (the
    layer's `call_and_state` takes it, as a model hands it)."""

    def __init__(self, vocab: int, seq_len: int, n_block: int = 12,
                 hidden_size: int = 768, n_head: int = 12,
                 embedding_drop: float = 0.1, hidden_drop: float = 0.1,
                 attn_drop: float = 0.1, use_flash: bool = False,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.vocab, self.seq_len = vocab, seq_len
        self.hidden_size = hidden_size
        self.embedding_drop = embedding_drop
        self.word_embeddings = new_parameter((vocab, hidden_size), device,
                                             dtype)
        self.position_embeddings = new_parameter((seq_len, hidden_size),
                                                 device, dtype)
        self.blocks = nn.ModuleList(
            TransformerEncoderBlock(hidden_size, n_head,
                                    hidden_dropout=hidden_drop,
                                    attn_dropout=attn_drop,
                                    use_flash=use_flash, device=device,
                                    dtype=dtype,
                                    name=f"{self.name}_block{i}")
            for i in range(n_block))

    def build(self, generator):
        for emb in (self.word_embeddings, self.position_embeddings):
            fill_(emb, torch.randn(tuple(emb.shape), generator=generator)
                  * 0.02)
        return super().build(generator)

    def call(self, x, *, training: bool = False,
             seed: Optional[Seed] = None):
        seeds = _site_seeds(training, seed, 1 + len(self.blocks))
        ids = torch.as_tensor(x, device=self.word_embeddings.device).long()
        h = (F.embedding(ids, self.word_embeddings)
             + self.position_embeddings[None, :ids.shape[1]])
        if seeds[0] is not None and self.embedding_drop > 0:
            h = _dropout(seeds[0], self.embedding_drop, h)
        for blk, blk_seed in zip(self.blocks, seeds[1:]):
            h = blk.call(h, training=training, seed=blk_seed)
        return h

    def call_and_state(self, x, *, training: bool = False,
                       seed: Optional[Seed] = None):
        return self.call(x, training=training, seed=seed), {}

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.seq_len, self.hidden_size)


def _parameter_slots(module: nn.Module):
    """`(owning module's _parameters dict, leaf name)` for each parameter
    of `module`: where remat's recompute puts a block's parameters back.
    A direct swap, as `torch.func.functional_call` does it, without its
    per-call checks (~0.2 ms of host time a call, measured on the CPU)."""
    slots = []
    for name, _ in module.named_parameters():
        owner = module
        *path, leaf = name.split(".")
        for part in path:
            owner = getattr(owner, part)
        slots.append((owner._parameters, leaf))
    return slots


def stack_block_params(params: Dict, n_block: int, prefix: str) -> Dict:
    """UNSTACKED JAX-layout BERT tree (per-block subtrees named
    `{prefix}_block{i}`) → the stacked layout (`blocks` = one `[L, ...]`
    array per tensor). Works on nested dicts of numpy arrays."""
    per_block = [params[f"{prefix}_block{i}"] for i in range(n_block)]
    out = {k: v for k, v in params.items()
           if not k.startswith(prefix + "_block")}
    out["blocks"] = tree_map(lambda *xs: np.stack([np.asarray(x)
                                                   for x in xs]), *per_block)
    return out


def unstack_block_params(params: Dict, n_block: int, prefix: str) -> Dict:
    """Inverse of `stack_block_params`."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    for i in range(n_block):
        out[f"{prefix}_block{i}"] = tree_map(lambda x, _i=i: x[_i],
                                             params["blocks"])
    return out


class BERT(Layer):
    """BERT encoder as a layer. Inputs: `[ids, token_type, mask]`,
    `[ids, mask]` or `ids` (position ids are implicit, token types default
    to zeros, the mask to all ones). Outputs `(sequence, pooled)`, or just
    pooled with `pooled_only=True`."""

    def __init__(self, vocab: int = 30522, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12,
                 seq_len: int = 512, intermediate_size: int = 3072,
                 type_vocab: int = 2, hidden_drop: float = 0.1,
                 attn_drop: float = 0.1, pooled_only: bool = False,
                 use_flash: bool = False, remat: bool = False,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.vocab, self.hidden_size = vocab, hidden_size
        self.seq_len, self.type_vocab = seq_len, type_vocab
        self.hidden_drop = hidden_drop
        self.pooled_only = pooled_only
        self.remat = remat
        self.n_block = n_block
        self.word_embeddings = new_parameter((vocab, hidden_size), device,
                                             dtype)
        self.position_embeddings = new_parameter((seq_len, hidden_size),
                                                 device, dtype)
        self.token_type_embeddings = new_parameter((type_vocab, hidden_size),
                                                   device, dtype)
        self.emb_ln = LayerNormalization(hidden_size, device=device,
                                         dtype=dtype,
                                         name=self.name + "_emb_ln")
        self.pooler_kernel = new_parameter((hidden_size, hidden_size),
                                           device, dtype)
        self.pooler_bias = new_parameter((hidden_size,), device, dtype)
        self.blocks = nn.ModuleList(
            TransformerEncoderBlock(hidden_size, n_head, intermediate_size,
                                    hidden_dropout=hidden_drop,
                                    attn_dropout=attn_drop,
                                    use_flash=use_flash, device=device,
                                    dtype=dtype,
                                    name=f"{self.name}_block{i}")
            for i in range(n_block))

    def build(self, generator):
        for emb in (self.word_embeddings, self.position_embeddings,
                    self.token_type_embeddings):
            fill_(emb, torch.randn(tuple(emb.shape), generator=generator)
                  * 0.02)
        fill_(self.pooler_kernel, get_init("glorot_uniform")(
            generator, tuple(self.pooler_kernel.shape)))
        fill_(self.pooler_bias, torch.zeros(self.pooler_bias.shape))
        return super().build(generator)

    def _run_block(self, blk, h, mask, training: bool,
                   seed: Optional[int]):
        """One block; with `remat` (and autograd on) under a whole-block
        checkpoint whose inputs are `h`, the mask and the block's
        parameters as the forward sees them (the recompute puts them back
        in place of whatever the block holds then)."""
        if not (self.remat and torch.is_grad_enabled()):
            return blk.call([h, mask], training=training, seed=seed)
        slots = _parameter_slots(blk)
        tensors = [owner[leaf] for owner, leaf in slots]

        def run(hh, mm, *params):
            held = [owner[leaf] for owner, leaf in slots]
            for (owner, leaf), t in zip(slots, params):
                owner[leaf] = t
            try:
                return blk.call([hh, mm], training=training, seed=seed)
            finally:
                for (owner, leaf), t in zip(slots, held):
                    owner[leaf] = t

        # the masks come from `seed`, not from torch's generators: no RNG
        # state to stash and restore around the recompute
        return checkpoint(run, h, mask, *tensors, use_reentrant=False,
                          preserve_rng_state=False)

    @staticmethod
    def make_mask(attention_mask: torch.Tensor) -> torch.Tensor:
        """`[B, T]` {0,1} → additive `[B, 1, 1, T]` float32 (-10000 on
        padding, the reference's masked-logit convention)."""
        m = attention_mask.to(torch.float32)
        return ((1.0 - m)[:, None, None, :] * -10000.0).contiguous()

    def call(self, x, *, training: bool = False,
             seed: Optional[int] = None):
        if isinstance(x, (list, tuple)):
            if len(x) == 3:
                ids, token_type, attn_mask = x
            elif len(x) == 2:
                ids, attn_mask = x
                token_type = None
            else:
                raise ValueError("BERT expects [ids, (token_type), mask]")
        else:
            ids, token_type, attn_mask = x, None, None
        seeds = _site_seeds(training, seed, 1 + len(self.blocks))
        device = self.word_embeddings.device
        ids = torch.as_tensor(ids, device=device).long()
        token_type = (torch.zeros_like(ids) if token_type is None else
                      torch.as_tensor(token_type, device=device).long())
        attn_mask = (torch.ones_like(ids) if attn_mask is None else
                     torch.as_tensor(attn_mask, device=device))
        T = ids.shape[1]
        # F.embedding, the counterpart of `jnp.take`: its backward sums
        # the rows deterministically (an index's backward does not, on the
        # CPU), so a step is reproducible from its seed
        h = (F.embedding(ids, self.word_embeddings)
             + self.position_embeddings[None, :T]
             + F.embedding(token_type, self.token_type_embeddings))
        h = self.emb_ln.call(h)
        if seeds[0] is not None and self.hidden_drop > 0:
            h = _dropout(seeds[0], self.hidden_drop, h)
        mask = self.make_mask(attn_mask)
        for blk, blk_seed in zip(self.blocks, seeds[1:]):
            h = self._run_block(blk, h, mask, training, blk_seed)
        pooled = torch.tanh(maybe_int8_matmul(h[:, 0], self, "pooler_kernel")
                            + self.pooler_bias)
        if self.pooled_only:
            return pooled
        return h, pooled
