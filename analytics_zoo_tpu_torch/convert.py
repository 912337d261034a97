"""Carry BERT weights between the JAX package's parameter tree and the
port's state dict.

The tree is what `analytics_zoo_tpu.models.bert.BERTClassifier.build`
returns, as nested dicts of numpy arrays:

    bert/{word,position,token_type}_embeddings, bert/emb_ln/{gamma,beta},
    bert/pooler_{kernel,bias},
    bert/bert_block{i}/attn/{qkv,out}_{kernel,bias},
    bert/bert_block{i}/{ln1,ln2}/{gamma,beta},
    bert/bert_block{i}/ffn_{in,out}_{kernel,bias},
    cls_kernel, cls_bias

or, for `BERT(stacked=True)`, `bert/blocks/...` with `[L, ...]` leaves in
place of the per-block subtrees. The port stores dense weights `[in, out]`
as the JAX package does (no transpose; the fused QKV kernel keeps its
q|k|v column order) and names its modules after the tree's keys, so a
state-dict key is the tree path joined by "." with `{enc}_block{i}`
renamed `blocks.{i}`.

Loaded with `load_state_dict`, the weights land in the model's own
parameters, which are trainable (`requires_grad`), so a converted model
fine-tunes as it is. Optimizer state crosses too: a JAX Adam state (optax's
`ScaleByAdamState`, an optax chain holding one, as `optax.adam`/`adamw`
build, or the JAX package's `FusedAdamState`) maps onto the port's
`ops.optimizers.FusedAdamState` and back, its moment trees mapped like the
parameters.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.keras.transformer import (stack_block_params,
                                                       unstack_block_params)
from analytics_zoo_tpu_torch.ops.optimizers import FusedAdamState
from analytics_zoo_tpu_torch.serving.quantization import INT8_NOT_PORTED

_BLOCK_KEY = re.compile(r"^(?P<prefix>.+)_block(?P<index>\d+)$")


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]):
    for key, value in tree.items():
        if key.endswith("_q"):
            raise NotImplementedError(INT8_NOT_PORTED)
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            _flatten(value, path + ".", out)
        else:
            out[path] = np.asarray(value)


def _encoder_to_port(name: str, tree: Mapping) -> Mapping:
    """One encoder subtree with its blocks renamed `blocks.{i}` (unstacked
    first if it came stacked)."""
    if "blocks" in tree:
        n_block = len(tree_leaves(tree["blocks"])[0])
        tree = unstack_block_params(tree, n_block, name)
    out = {}
    for key, value in tree.items():
        m = _BLOCK_KEY.match(key)
        if m and m.group("prefix") == name:
            out.setdefault("blocks", {})[m.group("index")] = value
        else:
            out[key] = value
    return out


def _to_tensor(a) -> torch.Tensor:
    """A numpy leaf as a CPU tensor; numpy's bfloat16 (the `ml_dtypes`
    type jax hands out), which torch cannot wrap, crosses through float32
    exactly."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `BERTClassifier` tree (stacked or not) → the port's state dict
    (CPU tensors in the tree's dtypes; `load_state_dict` copies them onto
    the model's device and dtype)."""
    tree = {key: _encoder_to_port(key, value)
            if isinstance(value, Mapping) else value
            for key, value in tree.items()}
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: _to_tensor(v) for k, v in flat.items()}


def params_to_jax(state_dict: Mapping[str, torch.Tensor],
                  stacked: bool = False) -> Dict:
    """Inverse of `params_from_jax`: the port's state dict → the JAX tree,
    in the stacked layout when `stacked` (bfloat16 leaves come back as
    float32 arrays: numpy has no bfloat16)."""
    tree: Dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if len(parts) > 2 and parts[1] == "blocks":
            parts = [parts[0], f"{parts[0]}_block{parts[2]}"] + parts[3:]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:    # numpy has no bfloat16
            value = value.float()
        node[parts[-1]] = value.numpy()
    if stacked:
        for name, sub in tree.items():
            if isinstance(sub, dict):
                n_block = sum(1 for k in sub if _BLOCK_KEY.match(k))
                if n_block:
                    tree[name] = stack_block_params(sub, n_block, name)
    return tree


def _adam_state(state) -> Any:
    """The (count, mu, nu) record inside a JAX optimizer state."""
    if all(hasattr(state, f) for f in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for part in state:
            try:
                return _adam_state(part)
            except ValueError:
                continue
    raise ValueError(f"no Adam state (count, mu, nu) in {type(state)}")


def opt_state_from_jax(state, device=None) -> FusedAdamState:
    """A JAX Adam state → the port's `FusedAdamState` (count as an int,
    moments as state dicts, on `device`)."""
    adam = _adam_state(state)

    def moments(tree):
        return {k: v.to(device) for k, v in params_from_jax(tree).items()}
    return FusedAdamState(int(np.asarray(adam.count)), moments(adam.mu),
                          moments(adam.nu))


def opt_state_to_jax(state: FusedAdamState,
                     stacked: bool = False) -> FusedAdamState:
    """The port's state → (count as int32, mu, nu as JAX trees of numpy
    arrays); wrap it as the JAX side needs (`optax.ScaleByAdamState(*t)`,
    `FusedAdamState(*t)`)."""
    return FusedAdamState(np.int32(state.count),
                          params_to_jax(state.mu, stacked),
                          params_to_jax(state.nu, stacked))
