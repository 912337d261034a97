"""Int8 post-training quantization for serving.

Port of `analytics_zoo_tpu/serving/quantization.py` (L42-295):
`quantize_activations` (L42), `int8_matmul` (L50), `int8_conv` (L60),
`dequantize_rows` (L78), `maybe_int8_matmul` (L83), `_RAW_INT8_KERNELS`
and `_quantize_raw_kernels` (L96-128), `_quantize_tensor` (L131),
`quantize_model_params` (L147, with its `_BERTTask` branch),
`save_quantized` (L204), `sidecar_path` (L222), `write_int8_sidecar`
(L230, with its `quantized_checkpoints_total` counter),
`load_int8_sidecar` (L270) and `load_quantized` (L288).

Weights are symmetric int8 per output channel (`<key>_q` + an f32
`<key>_scale`); activations are quantized per tensor, dynamically, from
the batch's abs-max; an embedding table per row. The JAX package rewrites
the parameter tree; the port's weights live in modules, so:

- `quantize_params_tree(model, tree)` is the JAX function's body on the
  JAX parameter tree (`convert.state_to_jax`), walked with the port's
  layer classes: it is what the sidecar and the artifacts hold, leaf for
  leaf the JAX package's (a convolution's kernel is HWIO there, scaled
  over O).
- `quantize_model_params(model)` returns a NEW module, a structural copy
  of `model` in which each quantized `<key>` Parameter is an int8 buffer
  `<key>_q` and an f32 buffer `<key>_scale` (`with_layout`); its
  state-dict keys are the names `convert` gives the tree's leaves. The f32
  model is left untouched, as the JAX package leaves `model.params`.
- Layers dispatch on `hasattr(module, key + "_q")`, as the JAX layers do
  on `key + "_q" in params`.

The int8 product is `torch._int_mm` (cuBLASLt's int8 GEMM with int32
accumulation on the card), as the JAX package computes it with
`lax.dot_general` outside any Pallas kernel; the activation quantization
and the dequantizing multiply are plain PyTorch ops, the same code on the
CPU and the card. On CUDA `_int_mm` takes more than 16 rows and K and N
that are multiples of 8 (`int8_mm` pads with zeros, which is exact, and
slices the result), and is fastest with its right operand column-major:
the int8 modules hold their `[in, out]` GEMM weights so, with the JAX
shapes (a weight that needs padding is padded once and the copy kept on
it). The order of
operations is the JAX package's, so the results are bitwise its own:
`sx = max(max|x| / 127, 1e-12)`, `x_q = clip(round(x / sx), -127, 127)`
(round half to even in both), then `y · (sx · w_scale)`, the product of
the scales first.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from analytics_zoo_tpu_torch.common.modules import copy_module, owner_of

_EPS = 1e-12


# ---------------------------------------------------------------------------
# int8 compute paths (used by the layers' quantized dispatch)
# ---------------------------------------------------------------------------
def quantize_activations(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Dynamic symmetric per-tensor quantization: `(x_q int8, sx)`, the
    scale a 0-d tensor from the batch's abs-max. The divisor is a tensor
    on `x`'s device: CUDA divides by a Python number as a multiply by its
    reciprocal, which can land one ulp off the true quotient, the JAX
    package's and the CPU's scale."""
    amax = x.abs().max()
    sx = torch.clamp(amax / torch.full_like(amax, 127.0), min=_EPS)
    x_q = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    return x_q, sx


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mm_operand(w_q: Tensor) -> Tensor:
    """`w_q` `[K, N]` as `_int_mm`'s right operand. cuBLASLt's int8 GEMM
    takes a column-major one several times faster than a row-major one
    (`chip_smoke.py` times both), so the int8 modules hold their GEMM
    weights column-major (`with_layout`), and an aligned weight passes as
    it is. One whose K or N is not a multiple of 8 is padded with zeros,
    column-major, once per tensor (and again after an in-place write to
    it), the copy kept on the tensor as `_int8_operand`."""
    K, N = w_q.shape
    if not (K % 8 or N % 8):
        return w_q
    version = -1 if w_q.is_inference() else w_q._version
    cached = getattr(w_q, "_int8_operand", None)
    if cached is not None and cached[0] == version:
        return cached[1]
    w = F.pad(w_q, (0, _round_up(N, 8) - N, 0, _round_up(K, 8) - K))
    w = w.t().contiguous().t()
    w_q._int8_operand = (version, w)
    return w


def refresh_int8_operands(tensors) -> None:
    """After int8 weights were written in place (a `"same"` hot swap),
    rewrite the padded operand `_mm_operand` keeps on each of `tensors` in
    its own storage, which a captured CUDA graph reads; its zero padding
    stays."""
    for w_q in tensors:
        cached = getattr(w_q, "_int8_operand", None)
        if cached is None:
            continue
        K, N = w_q.shape
        cached[1][:K, :N].copy_(w_q)
        version = -1 if w_q.is_inference() else w_q._version
        w_q._int8_operand = (version, cached[1])


def int8_mm(a: Tensor, w_q: Tensor) -> Tensor:
    """`a @ w_q` for int8 `a` `[M, K]` and `w_q` `[K, N]`, int32, through
    `torch._int_mm`: rows padded to 32 when there are 16 or fewer, K and N
    to multiples of 8 (zeros), the result sliced back to `[M, N]`."""
    M, K = a.shape
    w = _mm_operand(w_q)
    Kp = w.shape[0]
    Mp = M if M > 16 else 32
    if Mp != M or Kp != K:
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    y = torch._int_mm(a.contiguous(), w)
    return y[:M, :w_q.shape[1]]


def int8_matmul(x: Tensor, w_q: Tensor, w_scale: Tensor) -> Tensor:
    """y ≈ x @ (w_q · w_scale): int8 × int8 → int32, dequantized with the
    product of the activation scale and the per-channel weight scales."""
    x_q, sx = quantize_activations(x)
    K, N = w_q.shape
    y = int8_mm(x_q.reshape(-1, K), w_q).reshape(*x.shape[:-1], N)
    return y.float() * (sx * w_scale)


def int8_conv(x: Tensor, w_q: Tensor, w_scale: Tensor, conv, **conv_kwargs
              ) -> Tensor:
    """Weight-only int8 for convolutions: the int8 kernel (`[O, I, *k]`,
    the port's layout) dequantizes to bf16 at use, the convolution `conv`
    (`F.conv2d`, ...) runs in bf16 on a bf16 cast of `x`, and the output is
    f32. An integer input raises: raw 0-255 pixels are not served
    unscaled."""
    if not x.is_floating_point():
        raise TypeError(f"int8 convolution input must be a float tensor, "
                        f"got {x.dtype}")
    scale = w_scale.to(torch.bfloat16).reshape((-1,) + (1,) * (w_q.dim() - 1))
    w = w_q.to(torch.bfloat16) * scale
    return conv(x.to(torch.bfloat16), w, None, **conv_kwargs).float()


def dequantize_rows(table_q: Tensor, scale: Tensor, ids: Tensor) -> Tensor:
    """Embedding path: gather int8 rows, dequantize only what was read."""
    return table_q[ids].float() * scale[ids][..., None]


def maybe_int8_matmul(x: Tensor, params: nn.Module, key: str) -> Tensor:
    """`x @ params.<key>` (the weight stored `[in, out]` as in the JAX
    package; `params` is the module that owns it), on the int8 path when
    the quantized form (`<key>_q` + `<key>_scale`) is there: the dispatch
    hook of raw-matmul layers (transformer blocks, BERT's heads)."""
    if hasattr(params, key + "_q"):
        return int8_matmul(x, getattr(params, key + "_q"),
                           getattr(params, key + "_scale"))
    return x @ getattr(params, key)


# raw (non-Dense-layer) matmul kernels that have a maybe_int8_matmul call
# site; only these are rewritten (a blanket *_kernel match would break
# layers that read their kernels directly)
_RAW_INT8_KERNELS = frozenset({
    "qkv_kernel", "out_kernel", "ffn_in_kernel", "ffn_out_kernel",
    "pooler_kernel", "cls_kernel", "ner_kernel", "qa_kernel",
})


def _quantize_raw_kernels(tree):
    """Rewrite the known raw matmul kernels (`[in, out]` leaves, or the
    stacked encoder's `[L, in, out]`, scaled per (layer, out channel)) of
    a parameter tree, recursively."""
    if not isinstance(tree, dict):
        return tree
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k in _RAW_INT8_KERNELS and not isinstance(v, dict) \
                and np.ndim(v) in (2, 3):
            q, scale = _quantize_tensor(v, (np.ndim(v) - 2,))
            out[k + "_q"], out[k + "_scale"] = q, scale
        else:
            out[k] = _quantize_raw_kernels(v)
    return out


# ---------------------------------------------------------------------------
# parameter rewrite
# ---------------------------------------------------------------------------
def _quantize_tensor(w, reduce_axes) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 over `reduce_axes`; the scale keeps the other
    axes."""
    w = np.asarray(w, np.float32)
    amax = np.maximum(np.abs(w).max(axis=reduce_axes, keepdims=True), _EPS)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, np.squeeze(scale, axis=reduce_axes)


def _net(model):
    from analytics_zoo_tpu_torch.models.common import ZooModel
    return model.model if isinstance(model, ZooModel) else model


def quantize_params_tree(model, tree: Mapping) -> Dict[str, Any]:
    """A built model's JAX parameter tree (`convert.state_to_jax`, keyed by
    this model's layer names) with int8 weights for every Dense,
    convolution and Embedding layer, recursing into nested models, and
    for the raw kernels of transformer layers and BERT task models. Layers
    without an int8 path (BatchNorm, recurrent cells, LayerNorm, ...) keep
    f32."""
    from analytics_zoo_tpu_torch.keras import transformer as tfm
    from analytics_zoo_tpu_torch.keras.engine import KerasNet
    from analytics_zoo_tpu_torch.keras.layers import (Dense, Embedding,
                                                      _ConvND)
    from analytics_zoo_tpu_torch.models.bert import _BERTTask

    out = dict(tree)
    if isinstance(model, _BERTTask):
        # the encoder and the head by structure, not by a global name
        # match: a user layer's same-named 2-D leaf is never touched
        out["bert"] = _quantize_raw_kernels(out.get("bert", {}))
        for head in ("cls_kernel", "ner_kernel", "qa_kernel"):
            if head in out and not isinstance(out[head], dict) \
                    and np.ndim(out[head]) == 2:
                q, scale = _quantize_tensor(out.pop(head), (0,))
                out[head + "_q"], out[head + "_scale"] = q, scale
    for layer in model.ordered_layers():
        sub = out.get(layer.name)
        if sub is None:
            continue
        if isinstance(layer, KerasNet):
            out[layer.name] = quantize_params_tree(layer, sub)
        elif isinstance(layer, (tfm.MultiHeadSelfAttention,
                                tfm.TransformerEncoderBlock, tfm.BERT)):
            out[layer.name] = _quantize_raw_kernels(sub)
        elif isinstance(layer, (Dense, _ConvND)):
            k = np.asarray(sub["kernel"])    # [in, out] / HWIO
            q, scale = _quantize_tensor(k, tuple(range(k.ndim - 1)))
            new = {kk: v for kk, v in sub.items() if kk != "kernel"}
            new["kernel_q"], new["kernel_scale"] = q, scale
            out[layer.name] = new
        elif isinstance(layer, Embedding):
            q, scale = _quantize_tensor(sub["embeddings"], (1,))
            out[layer.name] = {"embeddings_q": q, "embeddings_scale": scale}
    return out


_QUANT_SUFFIXES = ("_q", "_scale")


def _base_key(key: str) -> Optional[str]:
    for suffix in _QUANT_SUFFIXES:
        if key.endswith(suffix):
            return key[:-len(suffix)]
    return None


def _empty_leaf(leaf: str, shape, dtype, device) -> Tensor:
    """An int8 leaf's buffer: an `[in, out]` GEMM weight (every 2-D `_q`
    but an embedding table, which is gathered by row) column-major, as
    `int8_mm` takes it; the others row-major."""
    if leaf.endswith("_q") and len(shape) == 2 and leaf != "embeddings_q":
        return torch.empty(tuple(shape)[::-1], dtype=dtype,
                           device=device).t()
    return torch.empty(shape, dtype=dtype, device=device)


def with_layout(model: nn.Module, state: Mapping[str, Any]) -> nn.Module:
    """A structural copy of `model` whose state has the keys of `state`,
    loaded with its values: `<key>` Parameters become `<key>_q` /
    `<key>_scale` buffers where `state` is quantized, and the other way
    round (the int8 GEMM weights column-major, `_empty_leaf`). `model` is
    left untouched. Any other difference in keys raises KeyError."""
    live = model.state_dict(keep_vars=True)
    drop = set(live) - set(state)
    add = set(state) - set(live)
    for key in drop:
        base = _base_key(key)
        if key + "_q" not in state and (base is None or base not in state):
            raise KeyError(f"state has no {key!r} (nor its int8 form)")
    for key in add:
        base = _base_key(key)
        if key + "_q" not in live and (base is None or base not in live):
            raise KeyError(f"model has no place for {key!r}")
    out = copy_module(model, lambda key, t: None if key in drop
                      else torch.empty_like(t))
    for key in sorted(add):
        value = torch.as_tensor(np.asarray(state[key])) \
            if not isinstance(state[key], Tensor) else state[key]
        base = _base_key(key)
        twin = live[base] if base is not None and base in live \
            else live[key + "_q"]
        owner, leaf = owner_of(out, key)
        if base is not None and base in live:
            owner.register_buffer(leaf, _empty_leaf(
                leaf, value.shape, value.dtype, twin.device))
        else:
            dtype = torch.float32 if value.dtype == torch.float64 \
                else value.dtype
            owner.register_parameter(leaf, nn.Parameter(torch.empty(
                value.shape, dtype=dtype, device=twin.device)))
    out.load_state_dict({k: v if isinstance(v, Tensor)
                         else torch.as_tensor(np.asarray(v))
                         for k, v in state.items()})
    return out


def quantize_model_params(model, params: Optional[Mapping] = None
                          ) -> nn.Module:
    """The int8 twin of a built model (a `KerasNet` or a `ZooModel`), as a
    new module on the model's devices; `params`, a state dict of `model`,
    gives the weights to quantize (default: its own)."""
    from analytics_zoo_tpu_torch import convert
    net = _net(model)
    if params is None:
        if not getattr(net, "built", True):
            raise ValueError("Model has no parameters; fit or load first")
        params = net.state_dict()
    q = quantize_params_tree(net, convert.state_to_jax(params, net))
    return with_layout(net, convert.state_from_jax(q, net))


# ---------------------------------------------------------------------------
# int8 artifacts: quantize once, ship the small file
# ---------------------------------------------------------------------------
def save_quantized(model, path: str, params: Optional[Mapping] = None
                   ) -> nn.Module:
    """Quantize and write the int8 artifact (the JAX package's
    `save_weights` format: npz + structure + layer-order sidecars), which
    loads onto a fresh instance of the architecture through
    `load_quantized` in either package. Returns the quantized module."""
    net = _net(model)
    q = quantize_model_params(net, params)
    net.save_weights(path, params=q.state_dict())
    return q


def sidecar_path(run_dir: str, version: int) -> str:
    """The stem of a checkpoint's int8 sidecar (the `.npz` +
    `.structure.json` pair `learn/checkpoint.save_pytree` writes)."""
    return os.path.join(run_dir, f"model.{version}.int8")


def write_int8_sidecar(run_dir: str, version: int, model,
                       params: Optional[Mapping] = None) -> str:
    """The post-training quantization pass, persisted beside
    `model.<version>` with the checkpoint's own atomic write and CRC, so a
    torn sidecar is invisible and serving falls back to quantize-at-load.
    `params` is the checkpoint's JAX tree under this model's layer names
    (default: read from disk and remapped onto this instance). Returns the
    sidecar's stem."""
    from analytics_zoo_tpu_torch.learn.checkpoint import (load_pytree,
                                                          save_pytree)
    net = _net(model)
    if params is None:
        # an offline pass runs in a process whose auto-numbered layer
        # names differ from the checkpointing one's
        params = net._remap_loaded(
            load_pytree(os.path.join(run_dir, f"model.{version}")))
    q = quantize_params_tree(net, params)
    path = sidecar_path(run_dir, version)
    save_pytree(path, q)
    from analytics_zoo_tpu_torch.observability.registry import get_registry
    get_registry().counter(
        "quantized_checkpoints_total",
        "int8 checkpoint sidecars written by the post-training "
        "quantization pass").inc()
    return path


def load_int8_sidecar(run_dir: str, version: int):
    """The quantized tree a `write_int8_sidecar` pass wrote, or None when
    the sidecar is absent or fails its CRC (the caller quantizes at
    load)."""
    from analytics_zoo_tpu_torch.learn.checkpoint import (
        CorruptCheckpointError, load_pytree)
    path = sidecar_path(run_dir, version)
    if not os.path.exists(path + ".npz"):
        return None
    try:
        return load_pytree(path)
    except (OSError, ValueError, KeyError, CorruptCheckpointError):
        return None


def load_quantized(model, path: str) -> nn.Module:
    """An int8 artifact (of either package) onto `model`'s architecture:
    a new int8 module, remapped to this instance's layer names; `model`
    is left untouched."""
    from analytics_zoo_tpu_torch import convert
    net = _net(model)
    return with_layout(net, convert.state_from_jax(
        net.load_weights_tree(path), net))
