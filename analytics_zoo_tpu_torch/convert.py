"""Carry weights and optimizer state between the JAX package's parameter
trees and the port's state dicts: BERT's, and a functional `Model`'s or a
`Sequential`'s (NeuralCF, the image models, AnomalyDetector,
TextClassifier, SessionRecommender).

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

A functional `Model`'s or a `Sequential`'s tree is `{layer name: {leaf:
array}}` (`{}` for a layer without parameters); the port's state dict is
keyed `"<layer name>.<leaf>"`. Layers are matched by their position in the
graph order (`ordered_layers` here, `_ordered_layers()` there), not by
name: given names (`ncf_mlp_user`, ...) agree, but auto-generated ones
(`dense_3`) count per process and differ between the two models. Three
layers nest: a `Sequential` or a functional `Model` inside one is a
subtree of its own layers (matched by position too: its entry in the name
list is `(name, [its layers' names])`, as `layer_names` lists a port
model's), converted in both directions like the outer model, its
convolution kernels transposed too; `Bidirectional`'s `{"forward",
"backward"}` subtrees are its submodules `forward_layer` and `backward_layer`; and `TimeDistributed`
keeps its inner layer's leaves at its own level in the JAX tree, under its
submodule `layer` in the port. The
lazy-embedding optimizer state (`learn/lazy_embedding.init_state`: the
rest optimizer's Adam state, per-table `(mu, nu)` and the step count)
crosses the same way.

A convolution's kernel is HWIO in the JAX tree (`[*window, in / groups,
out]`) and OIHW in the port (`[out, in / groups, *window]`): it is
transposed each way, its Adam moments too, and so are the kernels of the
layers_ext convolutions: `SeparableConvolution2D`'s `depthwise` and
`pointwise`, `ConvLSTM2D/3D`'s `kernel` and `recurrent`, and
`Deconvolution2D`'s kernel (HWIO ↔ `conv_transpose2d`'s `[in, out, kh,
kw]`). A `TransformerLayer`'s `<name>_block{i}` subtrees are its
`blocks.{i}` modules, as BERT's are. Seq2seq's net has a tree of its own
(`seq2seq_params_from_jax` / `_to_jax`). The int8 form of a tree
(`serving/quantization.py`: `<leaf>_q` int8 and `<leaf>_scale` f32 leaves)
crosses both ways like the f32 leaves: a convolution's `kernel_q` is
transposed as `kernel` is, its per-output-channel scale is not, and a
stacked BERT's `[L, in, out]` `_q` leaves and `[L, out]` scales unstack
like the f32 leaves. BatchNorm's moving statistics
are leaves of the JAX tree and buffers of the port, under the same
`"<layer>.<leaf>"` keys, so they cross unchanged with the weights. They
have no optimizer state in the port (the optimizer steps parameters
only): `model_opt_state_from_jax` drops their moment entries (zeros in
the JAX state: a training forward gives them no gradient) and
`model_opt_state_to_jax` puts zeros back.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.keras.engine import KerasNet
from analytics_zoo_tpu_torch.keras.layers import (Bidirectional,
                                                  TimeDistributed, _ConvND)
from analytics_zoo_tpu_torch.keras.layers_ext import (ConvLSTM2D,
                                                      Deconvolution2D,
                                                      SeparableConvolution2D)
from analytics_zoo_tpu_torch.keras.transformer import (TransformerLayer,
                                                       stack_block_params,
                                                       unstack_block_params)
from analytics_zoo_tpu_torch.ops.optimizers import FusedAdamState

_BLOCK_KEY = re.compile(r"^(?P<prefix>.+)_block(?P<index>\d+)$")


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]):
    for key, value in tree.items():
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


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its own (bfloat16 as float32: numpy has
    none): a copy, since `.numpy()` of a CPU tensor shares its memory, and
    training the port model in place would change the JAX tree."""
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


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
        node[parts[-1]] = _to_numpy(value)
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


# ---------------------------------------------------------------------------
# functional Model and Sequential (NeuralCF, the image and recurrent models)
# ---------------------------------------------------------------------------
def _entry_name(entry) -> str:
    return entry if isinstance(entry, str) else entry[0]


def layer_names(model) -> list:
    """A port model's layer names in graph order, a nested model as
    `(name, [its layers' names])`: the `jax_layer_names` of its own tree
    (what persistence saves under)."""
    return [(l.name, layer_names(l)) if isinstance(l, KerasNet) else l.name
            for l in model.ordered_layers()]


def _port_layers(model, jax_layer_names: Sequence) -> Dict[str, tuple]:
    """JAX layer name → (port layer, its entry in `jax_layer_names`), by
    position in the graph order."""
    layers = model.ordered_layers()
    if len(layers) != len(jax_layer_names):
        raise ValueError(f"the JAX model has {len(jax_layer_names)} layers, "
                         f"the port's {len(layers)}")
    return {_entry_name(e): (l, e) for e, l in zip(jax_layer_names, layers)}


def _port_names(model, jax_layer_names: Sequence) -> Dict[str, str]:
    """JAX layer name → port layer name, by position in the graph order."""
    return {j: l.name for j, (l, _) in
            _port_layers(model, jax_layer_names).items()}


# a convolution's f32 kernel and its int8 form are transposed between the
# layouts; the int8 form's per-output-channel scale is not
_CONV_KERNELS = ("kernel", "kernel_q")


def _hwio_to_oihw(a: np.ndarray, rank: int) -> np.ndarray:
    return np.ascontiguousarray(
        np.transpose(a, (rank + 1, rank) + tuple(range(rank))))


def _oihw_to_hwio(a: np.ndarray, rank: int) -> np.ndarray:
    return np.ascontiguousarray(
        np.transpose(a, tuple(range(2, rank + 2)) + (1, 0)))


def _kernel_leaves(layer):
    """`(leaves, JAX layout → port, port → JAX)` of a layer whose kernels
    the two packages lay out differently, else None."""
    if isinstance(layer, _ConvND):
        r = layer.spatial_rank
        return (_CONV_KERNELS, lambda a: _hwio_to_oihw(a, r),
                lambda a: _oihw_to_hwio(a, r))
    if isinstance(layer, ConvLSTM2D):
        r = layer.spatial_rank
        return (("kernel", "recurrent"), lambda a: _hwio_to_oihw(a, r),
                lambda a: _oihw_to_hwio(a, r))
    if isinstance(layer, SeparableConvolution2D):
        return (("depthwise", "pointwise"), lambda a: _hwio_to_oihw(a, 2),
                lambda a: _oihw_to_hwio(a, 2))
    if isinstance(layer, Deconvolution2D):
        # HWIO [kh, kw, in, out] ↔ conv_transpose2d's [in, out, kh, kw]
        def swap(a):
            return np.ascontiguousarray(np.transpose(a, (2, 3, 0, 1)))
        return ("kernel",), swap, swap
    return None


def _transformer_from_jax(sub: Mapping) -> Dict[str, Any]:
    """A `TransformerLayer`'s subtree: its `<name>_block{i}` subtrees
    become `blocks.{i}.`, flattened."""
    out: Dict[str, Any] = {}
    for key, value in sub.items():
        m = _BLOCK_KEY.match(key)
        if m:
            _flatten(value, f"blocks.{m.group('index')}.", out)
        else:
            out[key] = value
    return out


def _transformer_to_jax(flat: Mapping[str, np.ndarray], prefix: str) -> Dict:
    tree: Dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        if parts[0] == "blocks":
            parts = [f"{prefix}_block{parts[1]}"] + parts[2:]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _layer_from_jax(layer, sub: Mapping, entry) -> Dict[str, Any]:
    """One layer's JAX subtree → {state-dict key below the layer: leaf}."""
    if isinstance(layer, KerasNet):
        return _tree_from_jax(sub, entry[1], layer)
    if isinstance(layer, TransformerLayer):
        return _transformer_from_jax(sub)
    if isinstance(layer, Bidirectional):
        return {f"{half}_layer.{leaf}": value
                for half in ("forward", "backward")
                for leaf, value in sub[half].items()}
    if isinstance(layer, TimeDistributed):
        return {f"layer.{key}": value for key, value in
                _layer_from_jax(layer.layer, sub, None).items()}
    out = dict(sub)
    kernels = _kernel_leaves(layer)
    if kernels is not None:
        leaves, to_port, _ = kernels
        for key in leaves:
            if out.get(key) is not None:
                out[key] = to_port(np.asarray(out[key]))
    return out


def _tree_from_jax(tree: Mapping, jax_layer_names: Sequence,
                   model) -> Dict[str, Any]:
    layers = _port_layers(model, jax_layer_names)
    out: Dict[str, Any] = {}
    for jname, sub in tree.items():
        if jname not in layers:
            raise ValueError(f"layer {jname!r} is not in the JAX layer list")
        layer, entry = layers[jname]
        for key, value in _layer_from_jax(layer, sub, entry).items():
            out[f"{layer.name}.{key}"] = value
    return out


def _layer_to_jax(layer, flat: Mapping[str, np.ndarray], entry) -> Dict:
    """Inverse of `_layer_from_jax`."""
    if isinstance(layer, KerasNet):
        return _tree_to_jax(flat, entry[1], layer)
    if isinstance(layer, Bidirectional):
        tree: Dict = {"forward": {}, "backward": {}}
        for key, value in flat.items():
            half, leaf = key.split(".", 1)
            tree[half[:-len("_layer")]][leaf] = value
        return tree
    if isinstance(layer, TimeDistributed):
        return _layer_to_jax(layer.layer, {key.split(".", 1)[1]: value
                                           for key, value in flat.items()},
                             None)
    if isinstance(layer, TransformerLayer):
        return _transformer_to_jax(flat, entry if isinstance(entry, str)
                                   else layer.name)
    out = dict(flat)
    kernels = _kernel_leaves(layer)
    if kernels is not None:
        leaves, _, to_jax = kernels
        for key in leaves:
            if key in out:
                out[key] = to_jax(out[key])
    return out


def _tree_to_jax(flat: Mapping[str, np.ndarray], jax_layer_names: Sequence,
                 model) -> Dict:
    layers = _port_layers(model, jax_layer_names)
    groups: Dict[str, Dict[str, np.ndarray]] = {
        l.name: {} for l, _ in layers.values()}
    for key, value in flat.items():
        name, rest = key.split(".", 1)
        groups[name][rest] = value
    return {j: _layer_to_jax(l, groups[l.name], e)
            for j, (l, e) in layers.items()}


def model_params_from_jax(tree: Mapping, jax_layer_names: Sequence,
                          model) -> Dict[str, torch.Tensor]:
    """A JAX functional `Model`'s or `Sequential`'s parameter tree → the
    port model's state dict (CPU tensors; `load_state_dict` copies them
    onto the model's device). `jax_layer_names` lists the JAX model's
    layers in graph order (`[l.name for l in jax_model._ordered_layers()]`),
    a nested `Sequential` or `Model` as `(name, [its layers' names])`. None
    leaves
    (the tables of a lazy-embedding rest state) are skipped."""
    return {k: _to_tensor(v) for k, v in
            _tree_from_jax(tree, jax_layer_names, model).items()
            if v is not None}


def model_params_to_jax(state_dict: Mapping[str, torch.Tensor],
                        jax_layer_names: Sequence, model) -> Dict:
    """Inverse of `model_params_from_jax`: a port state dict → the JAX tree
    under the JAX layer names, every layer present (`{}` when it has no
    parameters), in graph order."""
    return _tree_to_jax({k: _to_numpy(v) for k, v in state_dict.items()},
                        jax_layer_names, model)


def model_opt_state_from_jax(state, jax_layer_names: Sequence[str], model,
                             device=None) -> FusedAdamState:
    """A functional `Model`'s JAX Adam state (optax's, an optax chain
    holding one, or the JAX package's `FusedAdamState`) → the port's
    `FusedAdamState`, moments keyed like the model's parameters, on
    `device`. Moment entries of buffers (BatchNorm's moving statistics) are
    dropped: the port's optimizer steps parameters only."""
    adam = _adam_state(state)
    params = dict(model.named_parameters())

    def moments(tree):
        return {k: v.to(device) for k, v in model_params_from_jax(
            tree, jax_layer_names, model).items() if k in params}
    return FusedAdamState(int(np.asarray(adam.count)), moments(adam.mu),
                          moments(adam.nu))


def model_opt_state_to_jax(state: FusedAdamState,
                           jax_layer_names: Sequence[str],
                           model) -> FusedAdamState:
    """Inverse of `model_opt_state_from_jax`: (count as int32, mu, nu as
    JAX trees), with float32 zeros for the buffers' entries, as the JAX
    state holds them. Wrap it as the JAX side needs
    (`optax.ScaleByAdamState(*t)`, `FusedAdamState(*t)`)."""
    zeros = _buffer_zeros(model)

    def tree(moments):
        return model_params_to_jax(dict(moments, **zeros), jax_layer_names,
                                   model)
    return FusedAdamState(np.int32(state.count), tree(state.mu),
                          tree(state.nu))


def lazy_state_from_jax(state: Mapping, jax_layer_names: Sequence[str],
                        model, device=None) -> Dict:
    """The JAX lazy-embedding optimizer state (`{"rest": optax or fused
    Adam state, "tables": {"layer/leaf": (mu, nu)}, "t": int32}`) → the
    port's (`{"rest": FusedAdamState, "tables": {...}, "t": int}`), tensors
    on `device`."""
    names = _port_names(model, jax_layer_names)
    adam = _adam_state(state["rest"])

    def moments(tree):
        return {k: v.to(device) for k, v in
                model_params_from_jax(tree, jax_layer_names, model).items()}

    tables = {}
    for key, (mu, nu) in state["tables"].items():
        layer, leaf = key.split("/", 1)
        tables[f"{names[layer]}/{leaf}"] = (_to_tensor(mu).to(device),
                                            _to_tensor(nu).to(device))
    return {"rest": FusedAdamState(int(np.asarray(adam.count)),
                                   moments(adam.mu), moments(adam.nu)),
            "tables": tables, "t": int(np.asarray(state["t"]))}


def lazy_state_to_jax(state: Mapping, jax_layer_names: Sequence[str],
                      model) -> Dict:
    """Inverse of `lazy_state_from_jax`. The rest comes back as
    `(count, mu, nu)` with None at the table leaves, as the JAX package's
    `split_rest` leaves them; wrap it as the JAX side needs
    (`optax.ScaleByAdamState(*t)` in optax.adam's chain, or
    `FusedAdamState(*t)`)."""
    to_jax = {p: j for j, p in _port_names(model, jax_layer_names).items()}
    table_leaves = [key.split("/", 1) for key in state["tables"]]

    def tree(moments):
        t = model_params_to_jax(moments, jax_layer_names, model)
        for layer, leaf in table_leaves:
            t[to_jax[layer]][leaf] = None
        return t

    rest = state["rest"]
    return {"rest": FusedAdamState(np.int32(rest.count), tree(rest.mu),
                                   tree(rest.nu)),
            "tables": {f"{to_jax[layer]}/{leaf}": tuple(
                _to_numpy(m) for m in state["tables"][f"{layer}/{leaf}"])
                for layer, leaf in table_leaves},
            "t": np.int32(state["t"])}


# ---------------------------------------------------------------------------
# training checkpoints: the model tree and the optimizer state in optax's
# layout (`learn/checkpoint.py`, `learn/trainer.fit_keras`)
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Seq2seq's own tree (`models/seq2seq._Seq2seqNet`)
# ---------------------------------------------------------------------------
def seq2seq_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX `_Seq2seqNet` tree (`{enc_0: {kernel, recurrent, bias}, ...,
    bridge_0: [{kernel, bias}, ...], generator: {kernel, bias}}`) → the
    port net's state dict: the cells by name, the bridge's list as
    `bridge_{i}.{j}.`, the generator's leaves under `generator.`."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        if isinstance(value, (list, tuple)):
            for j, leaves in enumerate(value):
                _flatten(leaves, f"{key}.{j}.", flat)
        else:
            _flatten(value, f"{key}.", flat)
    return {k: _to_tensor(v) for k, v in flat.items()}


def seq2seq_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of `seq2seq_params_from_jax`."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[0].startswith("bridge_"):
            maps = tree.setdefault(parts[0], [])
            j = int(parts[1])
            maps.extend({} for _ in range(j + 1 - len(maps)))
            maps[j][parts[2]] = _to_numpy(value)
        else:
            tree.setdefault(parts[0], {})[parts[1]] = _to_numpy(value)
    return tree


def _seq2seq_net(model) -> bool:
    from analytics_zoo_tpu_torch.models.seq2seq import _Seq2seqNet
    return isinstance(model, _Seq2seqNet)


def _graph_model(model) -> bool:
    """A functional `Model` or a `Sequential` (its tree is keyed by layer
    name); else a model converted whole, as BERT is."""
    return bool(model.ordered_layers())


def state_to_jax(flat: Mapping[str, torch.Tensor], model) -> Dict:
    """A state dict (or a dict of moments keyed like it) → the JAX tree of
    `model`: `model_params_to_jax` under the model's own layer names, or
    `params_to_jax` for a model without layers (BERT), or Seq2seq's own
    tree."""
    if _graph_model(model):
        return model_params_to_jax(flat, layer_names(model), model)
    if _seq2seq_net(model):
        return seq2seq_params_to_jax(flat)
    return params_to_jax(flat)


def state_from_jax(tree: Mapping, model) -> Dict[str, torch.Tensor]:
    """Inverse of `state_to_jax`, for a tree keyed by this model's layer
    names (remap a saved tree first: `KerasNet._remap_loaded`)."""
    if _graph_model(model):
        return model_params_from_jax(tree, layer_names(model), model)
    if _seq2seq_net(model):
        return seq2seq_params_from_jax(tree)
    return params_from_jax(tree)


def _buffer_zeros(model) -> Dict[str, torch.Tensor]:
    params = dict(model.named_parameters())
    return {k: torch.zeros(b.shape, dtype=torch.float32)
            for k, b in model.state_dict().items() if k not in params}


def _moments_to_jax(moments: Mapping[str, torch.Tensor], model,
                    tables=()) -> Dict:
    """A params-shaped dict of moments → the JAX tree: float32 zeros for
    the buffers (the JAX state holds them as leaves), None at the lazy
    tables' leaves (`tables`: `(port layer, leaf)` pairs)."""
    tree = state_to_jax(dict(moments, **_buffer_zeros(model)), model)
    if tables:
        to_jax = {p: j for j, p in
                  _port_names(model, layer_names(model)).items()}
        for layer, leaf in tables:
            tree[to_jax[layer]][leaf] = None
    return tree


def _layout_to_jax(node, model, tables=()):
    """One node of an optimizer state in optax's layout → the JAX state's
    node: records field by field, moment dicts keyed like the parameters
    as JAX trees (what `model_opt_state_to_jax` makes of an Adam record's
    `mu` and `nu`), counts as int32."""
    if isinstance(node, tuple):
        parts = [_layout_to_jax(v, model, tables) for v in node]
        return type(node)(*parts) if hasattr(node, "_fields") \
            else tuple(parts)
    if isinstance(node, Mapping):
        return _moments_to_jax(node, model, tables)
    if isinstance(node, (int, np.integer)):
        return np.int32(node)
    raise TypeError(f"cannot lay out optimizer state node {type(node)}")


def _fill_moments(dst: Mapping[str, torch.Tensor],
                  src: Mapping[str, torch.Tensor]) -> Mapping:
    """Copy `src` into the template's tensors in place: each keeps its
    device, dtype and memory format (the fused kernel walks a
    channels_last moment as the param's flat array)."""
    for k, t in dst.items():
        t.copy_(src[k])
    return dst


def _layout_from_jax(jnode, pnode, model):
    """Inverse of `_layout_to_jax` into `pnode`, a fresh state's node of
    the same layout, whose tensors take the values in place (the moments
    of buffers, zeros in the JAX state, are dropped)."""
    if isinstance(pnode, tuple):
        parts = [_layout_from_jax(j, p, model) for j, p in zip(jnode, pnode)]
        return type(pnode)(*parts) if hasattr(pnode, "_fields") \
            else tuple(parts)
    if isinstance(pnode, Mapping):
        conv = state_from_jax(jnode, model)
        return _fill_moments(pnode, conv)
    return int(np.asarray(jnode))


def opt_layout_to_jax(optimizer, state, model, lazy: bool = False):
    """The port optimizer's state → the JAX optimizer state in optax's
    layout (records as tuples, moment trees under the model's layer
    names, numpy leaves): what a training checkpoint's
    `optimMethod-<name>.<iteration>` holds, leaf for leaf what the JAX
    package's `optimizer.init` would build. `lazy` states
    (`learn/lazy_embedding.init_state`) come back as the JAX package's
    `{"rest": <the rest optimizer's layout, None at the tables>, "tables":
    {"layer/leaf": (mu, nu)}, "t": int32}`."""
    if not lazy:
        return _layout_to_jax(optimizer.to_optax(state), model)
    out = lazy_state_to_jax(state, layer_names(model), model)
    tables = [key.split("/", 1) for key in state["tables"]]
    out["rest"] = _layout_to_jax(optimizer.to_optax(state["rest"]), model,
                                 tables)
    return out


def opt_layout_from_jax(optimizer, tree, state, model, lazy: bool = False):
    """A saved optimizer tree (of either package, its moment trees keyed by
    this model's layer names: see `remap_moment_trees`) poured into
    `state`, a fresh `init` of `optimizer` for this model, in place: leaf
    by leaf in optax's order (`learn.checkpoint.restore_opt_state`, which
    raises ValueError on a leaf count or shape that differs). Returns the
    filled state."""
    from analytics_zoo_tpu_torch.learn.checkpoint import restore_opt_state
    template = opt_layout_to_jax(optimizer, state, model, lazy)
    filled = restore_opt_state(template, tree)
    if not lazy:
        return optimizer.from_optax(_layout_from_jax(
            filled, optimizer.to_optax(state), model))
    names = _port_names(model, layer_names(model))
    rest = optimizer.from_optax(_layout_from_jax(
        filled["rest"], optimizer.to_optax(state["rest"]), model))
    tables = {}
    for key, (mu, nu) in filled["tables"].items():
        layer, leaf = key.split("/", 1)
        dst = state["tables"][f"{names[layer]}/{leaf}"]
        dst[0].copy_(_to_tensor(mu))
        dst[1].copy_(_to_tensor(nu))
        tables[f"{names[layer]}/{leaf}"] = dst
    return {"rest": rest, "tables": tables, "t": int(filled["t"])}


def remap_moment_trees(tree, layer_keys, remap):
    """Every params-shaped dict in a saved optimizer tree (its keys are
    `layer_keys`, the saved model tree's layer names) through `remap` (the
    model's `_remap_loaded`), so that its layers carry this instance's
    names, as the saved parameters do."""
    if isinstance(tree, dict):
        if tree and set(tree) == set(layer_keys):
            return remap(tree)
        return {k: remap_moment_trees(v, layer_keys, remap)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [remap_moment_trees(v, layer_keys, remap) for v in tree]
    return tree


# ---------------------------------------------------------------------------
# generative decoder (`models/generative.TinyDecoder`)
# ---------------------------------------------------------------------------
def generative_params_from_jax(tree: Mapping, device=None) -> Dict[str, Any]:
    """A `TinyDecoder` parameter tree of numpy (or jax) arrays → the same
    tree of tensors on `device` (`None` is `cuda`): ``embed``, ``pos``,
    ``layers`` (a list of per-layer dicts), ``lnf_g``, ``lnf_b``,
    ``head``. Dense weights keep the JAX layout ``[in, out]``."""
    from analytics_zoo_tpu_torch.common.device import resolve_device
    from analytics_zoo_tpu_torch.common.tree import tree_map
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a).to(dev), dict(tree))


def generative_params_to_jax(params: Mapping) -> Dict[str, Any]:
    """The inverse: a tree of tensors → the same tree of numpy arrays."""
    from analytics_zoo_tpu_torch.common.tree import tree_map
    return tree_map(_to_numpy, dict(params))


def kv_from_jax(kv: Sequence[Mapping], device=None) -> list:
    """A KV pool (contiguous or block pool), per layer ``{"k", "v"}``
    arrays → the same list of tensors on `device` (`None` is `cuda`)."""
    from analytics_zoo_tpu_torch.common.device import resolve_device
    dev = resolve_device(device)
    return [{name: _to_tensor(layer[name]).to(dev) for name in ("k", "v")}
            for layer in kv]


def kv_to_jax(kv: Sequence[Mapping]) -> list:
    """A KV pool of tensors → per layer ``{"k", "v"}`` numpy arrays."""
    return [{name: _to_numpy(layer[name]) for name in ("k", "v")}
            for layer in kv]
