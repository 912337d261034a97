"""Keras-style model engine: the `Layer` and `KerasNet` base classes, the
symbolic graph (`Node`, `Input`) and the functional `Model`.

Port of `analytics_zoo_tpu/keras/engine.py`: `reset_name_scope` (L45),
`Layer` (L49) with
`stateful` and `call_and_state` (L61-80) and its symbolic `__call__`
(L82), `Node` (L110), `Input` (L128), `_topo_sort` (L134), `KerasNet`
(L151) with `compile` (L183, a list of losses summed over the outputs,
L193-214), `set_tensorboard` (L226), `set_checkpoint` (L230) and its
`_checkpoint_path` (L160), `fit` (L246),
`evaluate` (L255), `predict` (L262) and `ensure_built` (L234),
persistence (`save_weights`, `load_weights_tree`, `load_weights`,
`_order_path`, `_layer_order`, `_remap_loaded`, L268-392), `summary` and
`_summary_rows` (L394-412), `Sequential` (L414-511: `add`, the list
constructor, `build`, `apply`, `apply_and_state`, `compute_output_shape`,
`call` / `call_and_state` and the symbolic `__call__` as a layer,
`input_shape`) and `Model` (L513, `build` L548, `apply` and
`apply_and_state` L566-612, and as a layer L604-625). In the JAX
package a layer is a pure function plus a parameter pytree (`build(rng,
shape) -> params`, `call(params, x)`); here a layer is an `nn.Module` that
owns its parameters, so the parameter argument goes away:

- `Layer.call(x, *, training=False, ...)` is the forward of a layer;
  calling a layer on a `Node` (or a list of them) builds the graph instead,
  as in the JAX package, and anything else runs the forward
  (`nn.Module.__call__` is the forward in PyTorch, so `__call__` tells the
  two apart by the argument);
- `KerasNet.apply(inputs, *, training=False, seed=None)` is the forward
  of a model (it shadows `nn.Module.apply`, whose init-by-callback use the
  port does not need: `build` initialises parameters); `seed`, the JAX
  `rng`, is the integer a training step's dropout sites derive their
  seeds from;
- parameters are created with the sizes the layer's config gives, at
  construction, or, for a layer whose sizes depend on its input's width
  (`Dense`), when it is first called on a node or a `Sequential` walks
  its shapes; they are created on the layer's `device` and `dtype`, and
  hold no values until `build(generator)` fills them (the JAX init
  families: Glorot uniform kernels, orthogonal recurrent kernels, zero
  biases, N(0, 0.02) or U[0, 0.05) embeddings) or a state dict is loaded
  (`convert` carries JAX weights across);
- `Model` and `Sequential` register their layers as submodules under
  their names, in order, so their state-dict keys are
  `"<layer name>.<leaf>"`.

Parameters are trainable (`requires_grad`); serving, `evaluate` and
`predict` run under `torch.inference_mode`, so they build no autograd
graph.

Non-gradient state (BatchNorm's moving statistics) follows PyTorch's
idiom. It lives in registered buffers named after the JAX leaves
(`moving_mean`, `moving_var`), so state-dict keys stay
`"<layer>.<leaf>"` and `convert` carries them unchanged; the optimizer
never sees them (`named_parameters` leaves them out). A stateful layer's
`call_and_state` returns its output and the new values of its state in
a training forward (none otherwise), and writes nothing;
`Model.apply_and_state` collects them per layer, as in the JAX package;
`Model.apply` (the forward that training, `evaluate` and serving run)
then writes them into the buffers in place, under `torch.no_grad()`
(`merge_state`, the JAX trainer's `_merge_state`, `learn/trainer.py:634`),
as `F.batch_norm` updates its running statistics. The JAX trainer merges
the updates after the optimizer step instead. The two orders give the same
result: the update reads the statistics as they were before the step in
both, and the optimizer never changes them in the JAX package either (their
gradient is zero in a training forward, which normalises with the batch's
statistics, and `_merge_state` overwrites whatever the step wrote).

A `Model` or a `Sequential` is a layer too: called on a node it adds
itself to the enclosing graph, registered as one submodule, so its
state-dict keys take its name in front (`"<model>.<layer>.<leaf>"`); its
stateful layers' updates come keyed by paths below its name; and it takes
the seed its node gets (`site_seed(seed, i)`) and splits it again for its
own nodes, where the JAX package splits the key it is handed. Nodes may be
wrapped in the autograd DSL's `Variable` (`ops/autograd.py`): a layer
called on Variables returns a Variable, and `Model` takes them for inputs
and outputs.

Persistence writes the JAX package's artifact: the parameter tree
(`convert.model_params_to_jax`, under this model's own layer names) through
`learn/checkpoint.save_pytree` (npz + structure json with the npz's CRC)
and the `.layers.json` order sidecar. Loading remaps the saved tree onto
this instance's layer names (positionally by the sidecar, and inside a
nested model by the JAX package's sort of auto-generated names, which
count per process) and loads it through `convert.model_params_from_jax`.
So an artifact saved by either package loads in the other.
"""

from __future__ import annotations

import collections
import json
import os
import re
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.kernels.philox import site_seed

Shape = Tuple[Optional[int], ...]

_name_counters: Dict[str, int] = collections.defaultdict(int)
# an auto-generated layer name: "<class>_<count>"
_AUTO_NAME = re.compile(r"^(.*)_(\d+)$")


def _auto_name(cls_name: str) -> str:
    _name_counters[cls_name] += 1
    return f"{cls_name.lower()}_{_name_counters[cls_name]}"


def reset_name_scope() -> None:
    """Restart the counts of auto-generated layer names (JAX L45): the
    next `Dense` is `dense_1` again."""
    _name_counters.clear()


def new_parameter(shape, device: DeviceLike, dtype: torch.dtype
                  ) -> nn.Parameter:
    """An unfilled, trainable parameter; `build` or a loaded state dict
    sets it."""
    return nn.Parameter(torch.empty(shape, device=resolve_device(device),
                                    dtype=dtype))


def _as_node(item) -> Optional["Node"]:
    """A `Node`, or the node an autograd `Variable` wraps; else None."""
    if isinstance(item, Node):
        return item
    node = getattr(item, "node", None)
    return node if isinstance(node, Node) else None


def _is_symbolic(inputs) -> bool:
    if isinstance(inputs, (list, tuple)):
        return bool(inputs) and all(_as_node(i) is not None for i in inputs)
    return _as_node(inputs) is not None


def _call_symbolic(layer, inputs):
    """`layer` applied to node(s): its parameters are created from the
    input shapes (`ensure_parameters`) and the output node is returned,
    wrapped in the inputs' `Variable` type when they came wrapped."""
    raw = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    nodes = [_as_node(i) for i in raw]
    wrapper = next((type(i) for i in raw if not isinstance(i, Node)), None)
    in_shapes = [n.shape for n in nodes]
    shape_in = in_shapes if len(in_shapes) > 1 else in_shapes[0]
    layer.ensure_parameters(shape_in)
    out = Node(layer=layer, inputs=nodes,
               shape=layer.compute_output_shape(shape_in))
    return wrapper(node=out) if wrapper is not None else out


State = Dict[str, Dict[str, torch.Tensor]]


@torch.no_grad()
def merge_state(module: nn.Module, updates: State) -> None:
    """Write stateful-layer updates (`{layer name: {buffer: value}}`, a
    name relative to `module`; `{"": {...}}` for `module` itself) into the
    buffers in place, cast to the buffers' dtype: under mixed precision the
    updates are computed from bf16 casts and the buffers stay float32."""
    for name, leaves in updates.items():
        layer = module.get_submodule(name)
        for leaf, value in leaves.items():
            getattr(layer, leaf).copy_(value)


class _GraphCall:
    """The `__call__` of a layer and of a model used as a layer: on a
    `Node` or a list of nodes (or autograd `Variable`s), a symbolic call
    that yields the output node; on anything else, the forward."""

    def __call__(self, *args, **kwargs):
        if args and _is_symbolic(args[0]):
            if len(args) > 1 or kwargs:
                raise TypeError(f"{self.name}: a symbolic call takes the "
                                "input node(s) only")
            return _call_symbolic(self, args[0])
        return super().__call__(*args, **kwargs)


class Layer(_GraphCall, nn.Module):
    """Base layer. Subclasses create their parameters in `__init__` or, when
    their sizes depend on the input, in `create_parameters`; fill them in
    `build`; and implement `call` (and `compute_output_shape` when the
    layer changes the shape). Layers that carry non-gradient state set
    `stateful` and implement `call_and_state`."""

    # True for layers carrying non-gradient state (BatchNorm's moving
    # statistics, in buffers)
    stateful = False

    def __init__(self, name: Optional[str] = None,
                 input_shape: Optional[Sequence] = None):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)
        # the Keras contract: `input_shape` excludes the batch dimension
        self.input_shape = (None,) + tuple(input_shape) \
            if input_shape is not None else None
        self._params_created = False

    # -- subclass API ------------------------------------------------------
    def build(self, generator: torch.Generator) -> "Layer":
        """Fill this layer's own parameters, then its children's."""
        for child in self.children():
            if isinstance(child, Layer):
                child.build(generator)
            elif isinstance(child, nn.ModuleList):
                for sub in child:
                    sub.build(generator)
        return self

    def create_parameters(self, input_shape) -> None:
        """Create the parameters whose sizes come from the input's shape
        (called once, through `ensure_parameters`)."""

    def ensure_parameters(self, input_shape) -> None:
        """`create_parameters` unless done: at construction when the layer
        was given `input_shape`, else at its first call on a node or when a
        `Sequential` walks its shapes."""
        if not self._params_created:
            self.create_parameters(input_shape)
            self._params_created = True

    def call(self, x, *, training: bool = False):
        raise NotImplementedError

    def call_and_state(self, x, *, training: bool = False,
                       seed: Optional[int] = None):
        """`(output, {buffer name: new value})`: what a functional `Model`
        runs for each node. Writes nothing; a stateless layer returns no
        updates. `seed` is for the layers that draw random bits
        (`Dropout`); the others ignore it."""
        return self.call(x, training=training), {}

    def compute_output_shape(self, input_shape):
        return input_shape

    def forward(self, *args, **kwargs):
        return self.call(*args, **kwargs)

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name})"


class Node:
    """A symbolic tensor in the layer graph: the layer that made it, its
    input nodes and its shape (batch dimension None)."""

    def __init__(self, layer: Optional[Layer], inputs: List["Node"],
                 shape: Shape):
        self.layer = layer
        self.inputs = inputs
        self.shape = shape

    def __repr__(self):
        lname = self.layer.name if self.layer else "input"
        return f"Node({lname}, shape={self.shape})"


def Input(shape: Shape, name: Optional[str] = None) -> Node:
    """Entry node of a functional graph; `shape` excludes the batch
    dimension (the Keras contract)."""
    return Node(layer=None, inputs=[], shape=(None,) + tuple(shape))


def _topo_sort(outputs: Sequence[Node]) -> List[Node]:
    """The nodes in depth-first post-order (each node after its inputs,
    inputs in order). Iterative: a recursive closure would be a reference
    cycle holding the node list, and with it every layer and parameter of
    the graph, until a garbage collection."""
    order: List[Node] = []
    seen: set = set()
    for out in outputs:
        stack = [(out, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                order.append(node)
            elif id(node) not in seen:
                seen.add(id(node))
                stack.append((node, True))
                stack.extend((i, False) for i in reversed(node.inputs))
    return order


def _multi_output_loss(fns: Sequence[Callable]) -> Callable:
    """One loss per output, summed (JAX `KerasNet.compile` L197-212), with
    its two checks: as many outputs as losses, and labels given as a list
    of that many arrays."""
    def _combined(y_true, y_pred):
        if not isinstance(y_pred, (list, tuple)) or len(y_pred) != len(fns):
            n = len(y_pred) if isinstance(y_pred, (list, tuple)) else 1
            raise ValueError(
                f"compile() got {len(fns)} losses but the model produces "
                f"{n} output(s)")
        if not isinstance(y_true, (list, tuple)) or len(y_true) != len(fns):
            raise ValueError(
                f"multi-output loss needs a list of {len(fns)} label "
                "arrays (got a single array — it would zip batch rows, "
                "not outputs)")
        return sum(fn(t, p) for fn, t, p in zip(fns, y_true, y_pred))

    return _combined


class KerasNet(_GraphCall, nn.Module):
    """Model base (`Topology.scala:67` in the reference): a built model owns
    its parameters; `apply` is its forward."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)
        self._built = False
        self.loss = None
        self.optimizer = None
        self.metrics: List[Any] = []
        self._optimizer_spec = None
        self._checkpoint_path: Optional[str] = None
        self._tensorboard_dir: Optional[str] = None

    # -- subclass API ------------------------------------------------------
    def build(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def apply(self, inputs, *, training: bool = False,
              seed: Optional[int] = None):
        raise NotImplementedError

    def forward(self, inputs, training: bool = False,
                seed: Optional[int] = None):
        return self.apply(inputs, training=training, seed=seed)

    # -- Keras surface -----------------------------------------------------
    def compile(self, optimizer, loss, metrics: Optional[Sequence] = None):
        """Resolve compile strings through the registries
        (`ops/optimizers.py`, `ops/objectives.py`, `ops/metrics.py`;
        `"accuracy"` resolves by the loss string). The compile string is
        remembered (`_optimizer_spec`) so `fit(fused_optimizer=True)` can
        find its fused twin and lazy embeddings their Adam defaults. A list
        of losses is the Keras multi-output contract (JAX L193-214): one
        loss per output, summed; the labels are then a list of arrays, one
        per output."""
        from analytics_zoo_tpu_torch.ops import metrics as zmetrics
        from analytics_zoo_tpu_torch.ops import objectives, optimizers
        self._optimizer_spec = optimizer if isinstance(optimizer, str) \
            else None
        loss_str = loss if isinstance(loss, str) else None
        if isinstance(loss, (list, tuple)):
            self.loss = _multi_output_loss([objectives.get(fn)
                                            for fn in loss])
        else:
            self.loss = objectives.get(loss)
        self.optimizer = optimizers.get(optimizer)
        self.metrics = zmetrics.resolve(metrics, loss_str)
        # step costs counted, and training programs captured, for the old
        # loss and optimizer
        self.__dict__.pop("_roofline_cost_memo", None)
        self.__dict__.pop("_train_cache", None)

    def set_tensorboard(self, log_dir: str, app_name: str):
        """`Topology.scala:208`: `fit` writes its summaries (loss,
        throughput, step time, validation) under `log_dir/app_name/train`
        (`utils/tensorboard.SummaryWriter`)."""
        self._tensorboard_dir = f"{log_dir.rstrip('/')}/{app_name}"

    def set_checkpoint(self, path: str, over_write: bool = True):
        """`Topology.scala:249`: `fit` writes training checkpoints under
        `path` (`learn/checkpoint.CheckpointManager`) and
        `fit(auto_resume=True)` continues from them."""
        self._checkpoint_path = path

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 1,
            validation_data=None, distributed: bool = True, **kwargs):
        """Train on in-memory arrays where the parameters live; returns
        the history dict (`learn/trainer.fit_keras`), with per-epoch
        `val_<metric>` entries for `validation_data=(x, y)`."""
        from analytics_zoo_tpu_torch.learn.trainer import fit_keras
        return fit_keras(self, x, y, batch_size=batch_size, epochs=nb_epoch,
                         validation_data=validation_data,
                         distributed=distributed, **kwargs)

    def evaluate(self, x, y=None, batch_per_thread: int = 32, **kwargs):
        """The compiled metrics (or the loss) over `(x, y)`, as
        `{name: value}` (`learn/trainer.evaluate_keras`)."""
        from analytics_zoo_tpu_torch.learn.trainer import evaluate_keras
        return evaluate_keras(self, x, y, batch_per_thread=batch_per_thread,
                              **kwargs)

    def predict(self, x, batch_per_thread: int = 32, **kwargs):
        """The model's outputs on `x` as numpy arrays
        (`learn/trainer.predict_keras`)."""
        from analytics_zoo_tpu_torch.learn.trainer import predict_keras
        return predict_keras(self, x, batch_per_thread=batch_per_thread,
                             **kwargs)

    # -- parameters ----------------------------------------------------------
    @property
    def built(self) -> bool:
        """True once `ensure_built` or `load_state_dict` gave the
        parameters values (the JAX package's `params is not None`)."""
        return self._built

    def ensure_built(self, sample_input=None, seed: int = 0
                     ) -> Dict[str, torch.Tensor]:
        """Initialise parameters from `seed` unless already built or loaded;
        returns the state dict. A `Model`'s sizes come from its graph, so it
        ignores `sample_input`; a `Sequential` may take its input's shape
        from it."""
        if not self._built:
            with torch.no_grad():
                self.build(torch.Generator().manual_seed(seed))
            self._mark_built()
        return self.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        result = super().load_state_dict(state_dict, strict=strict,
                                         assign=assign)
        self._mark_built()
        return result

    def _mark_built(self) -> None:
        """This model and the models nested in it have their values."""
        for m in self.modules():
            if isinstance(m, KerasNet):
                m._built = True

    def ordered_layers(self) -> List:
        """The layers in graph order: the order `convert`, persistence and
        `summary` go by (auto-generated names differ between processes).
        A nested model is one entry."""
        return []

    # -- as a layer ----------------------------------------------------------
    def ensure_parameters(self, input_shape) -> None:
        """A `Model`'s parameters exist once its graph does; `Sequential`
        creates its own from the shape it is called on."""

    def call(self, x, *, training: bool = False, seed: Optional[int] = None):
        return self.apply(x, training=training, seed=seed)

    def call_and_state(self, x, *, training: bool = False,
                       seed: Optional[int] = None):
        """`(output, {path below this model: {buffer: value}})`: the
        seed this model's node gets is split again for its own nodes."""
        return self.apply_and_state(x, training=training, seed=seed)

    # -- persistence (`models/common/ZooModel.scala` save/load) -----------
    def save_weights(self, path: str,
                     params: Optional[Dict[str, Any]] = None) -> None:
        """Write this model's parameters and buffers as the JAX package's
        artifact: its parameter tree under this model's layer names
        (`<path>.npz` + `<path>.structure.json`) and the layer-order
        sidecar `<path>.layers.json`. `params`, a state dict of this
        architecture (default: the model's own), lets derived states (the
        int8 form, `serving/quantization.py`) use the same artifact."""
        from analytics_zoo_tpu_torch import convert
        from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
        if params is None:
            if not self._built:
                raise ValueError("Model has no parameters yet; call fit or "
                                 "ensure_built first")
            params = self.state_dict()
        ckpt.save_pytree(path, convert.state_to_jax(params, self))
        order = self._layer_order()
        if order:
            with open(self._order_path(path), "w") as fh:
                json.dump(order, fh)

    def load_weights_tree(self, path: str) -> Dict[str, Any]:
        """Read an artifact written by `save_weights` (of either package)
        and remap it onto this instance's layer names, without loading it:
        the JAX parameter tree, numpy leaves."""
        from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
        loaded = ckpt.load_pytree(path)
        order = None
        if os.path.exists(self._order_path(path)):
            with open(self._order_path(path)) as fh:
                order = json.load(fh)
        return self._remap_loaded(loaded, order)

    def load_weights(self, path: str) -> "KerasNet":
        """`load_weights_tree`, loaded into this model's parameters and
        buffers (on their device, in their dtype)."""
        from analytics_zoo_tpu_torch import convert
        self.load_state_dict(convert.state_from_jax(
            self.load_weights_tree(path), self))
        return self

    @staticmethod
    def _order_path(path: str) -> str:
        base = path[:-4] if path.endswith(".npz") else path
        return base + ".layers.json"

    def _layer_order(self) -> List[str]:
        return [l.name for l in self.ordered_layers()]

    def _remap_loaded(self, loaded: Dict[str, Any],
                      order: Optional[List[str]] = None) -> Dict[str, Any]:
        """Saved layer names → this instance's (JAX L317-392), recursing
        into nested models. With the order sidecar the match is by
        position (a saved auto-generated name of another class at a
        position is an architecture mismatch); without it, names that
        agree map by name, else layers map per class prefix in the order
        of their auto-generated names' numbers (creation order)."""
        layers = self.ordered_layers()
        if not layers:
            return loaded
        if order is not None and (len(order) != len(loaded)
                                  or set(order) != set(loaded)):
            raise ValueError(
                f"Stale/mismatched layer-order sidecar: order has "
                f"{len(order)} names, saved params have {len(loaded)}")
        if len(loaded) != len(layers):
            raise ValueError(
                f"Saved weights have {len(loaded)} layers, model has "
                f"{len(layers)}")

        def remap_child(layer, value):
            if isinstance(layer, KerasNet):
                return layer._remap_loaded(value)
            return value

        if order is not None:
            for layer, sname in zip(layers, order):
                saved_auto = _AUTO_NAME.match(sname)
                cur_auto = _AUTO_NAME.match(layer.name)
                if saved_auto and cur_auto \
                        and cur_auto.group(1) == type(layer).__name__.lower() \
                        and saved_auto.group(1) != cur_auto.group(1):
                    raise ValueError(
                        f"Saved layer {sname!r} does not match model layer "
                        f"{layer.name!r} ({type(layer).__name__}) at the "
                        "same structural position")
            return {layer.name: remap_child(layer, loaded[sname])
                    for layer, sname in zip(layers, order)}

        if set(loaded) == {l.name for l in layers}:
            return {l.name: remap_child(l, loaded[l.name]) for l in layers}

        def split(name: str):
            m = _AUTO_NAME.match(name)
            return (m.group(1), int(m.group(2))) if m else (name, 0)

        saved_by_prefix: Dict[str, List] = {}
        for name in loaded:
            p, n = split(name)
            saved_by_prefix.setdefault(p, []).append((n, name))
        cur_by_prefix: Dict[str, List] = {}
        for layer in layers:
            p, n = split(layer.name)
            cur_by_prefix.setdefault(p, []).append((n, layer))
        if {p: len(v) for p, v in saved_by_prefix.items()} != \
                {p: len(v) for p, v in cur_by_prefix.items()}:
            raise ValueError(
                f"Saved layer classes {sorted(saved_by_prefix)} do not match "
                f"model layer classes {sorted(cur_by_prefix)}")
        result: Dict[str, Any] = {}
        for p, cur_list in cur_by_prefix.items():
            for (_, layer), (_, sname) in zip(
                    sorted(cur_list, key=lambda t: t[0]),
                    sorted(saved_by_prefix[p], key=lambda t: t[0])):
                result[layer.name] = remap_child(layer, loaded[sname])
        return result

    # -- summary ---------------------------------------------------------------
    def summary(self) -> str:
        """Print and return the JAX package's summary text: one row a layer
        (name and class, "-", its count of values, moving statistics
        included), then the total. A model without values has no rows."""
        rows = self._summary_rows()
        lines = [f"Model: {self.name}", "-" * 60]
        for layer, shape, count in rows:
            lines.append(f"{layer:<30} {str(shape):<20} {count}")
        lines.append("-" * 60)
        lines.append(f"Total params: {sum(r[2] for r in rows)}")
        text = "\n".join(lines)
        print(text)
        return text

    def _summary_rows(self) -> List[Tuple[str, str, int]]:
        if not self._built:
            return []
        return [(f"{layer.name} ({type(layer).__name__})", "-",
                 sum(t.numel() for t in layer.state_dict().values()))
                for layer in self.ordered_layers()]


def _add_updates(updates: State, layer, upd) -> None:
    """Collect one layer's state updates under its name; a nested model's
    come keyed by paths below it, which take its name as a prefix."""
    if not upd:
        return
    if isinstance(layer, KerasNet):
        for path, leaves in upd.items():
            updates[f"{layer.name}.{path}"] = leaves
    else:
        updates.setdefault(layer.name, {}).update(upd)


def _sample_shape(sample) -> Shape:
    """The shape a sample batch gives a model: batch dimension None."""
    shape = sample.shape if hasattr(sample, "shape") else np.shape(sample)
    return (None,) + tuple(int(d) for d in shape[1:])


class Sequential(KerasNet):
    """Linear stack (`Topology.scala:854`), registered as submodules under
    the layers' names, so its state-dict keys are `"<layer name>.<leaf>"`
    (a nested `Sequential` adds its own name in front).

    The port's layers create their parameters when their input's shape is
    known, so `add` walks the shapes as the JAX package's `build` does:
    from the first layer's `input_shape`, each layer gets the running shape
    (`ensure_parameters`) and passes on its `compute_output_shape`. When the
    first layer has no `input_shape`, creation waits for
    `ensure_built(sample_input)`, or for the shape a symbolic call or an
    enclosing `Sequential` gives it. A `Sequential` can be a layer: added to
    another, or called on a `Node`."""

    def __init__(self, layers: Optional[Sequence] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.layers: List = []
        self._params_created = False
        self._out_shape: Optional[Shape] = None
        for layer in (layers or []):
            self.add(layer)

    def add(self, layer) -> "Sequential":
        if any(layer is l for l in self.layers):
            raise ValueError(f"{layer.name} is already in {self.name}")
        self.add_module(layer.name, layer)
        self.layers.append(layer)
        if len(self.layers) == 1 and layer.input_shape is not None:
            self._params_created = True
            self._out_shape = layer.input_shape
        if self._params_created:
            layer.ensure_parameters(self._out_shape)
            self._out_shape = layer.compute_output_shape(self._out_shape)
        return self

    @property
    def input_shape(self) -> Optional[Shape]:
        return self.layers[0].input_shape if self.layers else None

    def create_parameters(self, input_shape) -> None:
        self._params_created = True
        shape = self.input_shape or input_shape
        for layer in self.layers:
            layer.ensure_parameters(shape)
            shape = layer.compute_output_shape(shape)
        self._out_shape = shape

    def ensure_parameters(self, input_shape) -> None:
        if not self._params_created:
            self.create_parameters(input_shape)

    def ensure_built(self, sample_input=None, seed: int = 0
                     ) -> Dict[str, torch.Tensor]:
        """As `KerasNet.ensure_built`; a stack whose first layer has no
        `input_shape` creates its parameters from `sample_input`'s shape
        first."""
        if not self._params_created:
            if sample_input is None:
                raise ValueError(f"Cannot build {self.name}: no input_shape "
                                 "on the first layer and no sample input")
            self.create_parameters(_sample_shape(sample_input))
        return super().ensure_built(sample_input, seed)

    def build(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.build(generator)

    def apply(self, inputs, *, training: bool = False,
              seed: Optional[int] = None):
        """The forward; in training, the stateful layers' buffers take
        their updates (`merge_state`)."""
        out, updates = self.apply_and_state(inputs, training=training,
                                            seed=seed)
        merge_state(self, updates)
        return out

    def apply_and_state(self, inputs, *, training: bool = False,
                        seed: Optional[int] = None) -> Tuple[Any, State]:
        """`(output, {layer name: {buffer: new value}})`, writing nothing.
        Layer i gets the seed `site_seed(seed, i)`, where the JAX package
        splits its key once a layer."""
        x = inputs
        updates: State = {}
        for i, layer in enumerate(self.layers):
            sub = None if seed is None else site_seed(seed, i)
            x, upd = layer.call_and_state(x, training=training, seed=sub)
            _add_updates(updates, layer, upd)
        return x, updates

    def compute_output_shape(self, input_shape):
        shape = input_shape
        for layer in self.layers:
            shape = layer.compute_output_shape(shape)
        return shape

    def ordered_layers(self) -> List:
        return list(self.layers)


class Model(KerasNet):
    """Functional graph model (`Topology.scala:631`): built from `Input`
    nodes and symbolic layer calls. Its layers are its submodules, under
    their names, in graph order."""

    def __init__(self, inputs: Union[Node, Sequence[Node]],
                 outputs: Union[Node, Sequence[Node]],
                 name: Optional[str] = None):
        super().__init__(name)
        self.inputs = [_as_node(i) for i in inputs] \
            if isinstance(inputs, (list, tuple)) else [_as_node(inputs)]
        self.outputs = [_as_node(o) for o in outputs] \
            if isinstance(outputs, (list, tuple)) else [_as_node(outputs)]
        self._order = _topo_sort(self.outputs)
        # one parameter set per layer object (weight sharing); two distinct
        # layers with one name is an error, as in Keras
        self._layers: List[Layer] = []
        by_name: Dict[str, Layer] = {}
        for node in self._order:
            layer = node.layer
            if layer is None or any(layer is l for l in self._layers):
                continue
            dup = by_name.get(layer.name)
            if dup is not None:
                raise ValueError(
                    f"Duplicate layer name {layer.name!r} for two distinct "
                    "layers in one graph")
            by_name[layer.name] = layer
            self._layers.append(layer)
            self.add_module(layer.name, layer)

    def build(self, generator: torch.Generator) -> None:
        for layer in self._layers:
            layer.build(generator)

    def apply(self, inputs, *, training: bool = False,
              seed: Optional[int] = None):
        """The forward; in training, the stateful layers' buffers take
        their updates (`merge_state`)."""
        out, updates = self.apply_and_state(inputs, training=training,
                                            seed=seed)
        merge_state(self, updates)
        return out

    def apply_and_state(self, inputs, *, training: bool = False,
                        seed: Optional[int] = None) -> Tuple[Any, State]:
        """`(outputs, {layer name: {buffer: new value}})`, writing nothing.
        Node i of the graph order (inputs excluded) gets the seed
        `site_seed(seed, i)`, where the JAX package splits its key once a
        node."""
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        if len(xs) != len(self.inputs):
            raise ValueError(f"Model {self.name} expects {len(self.inputs)} "
                             f"inputs, got {len(xs)}")
        values: Dict[int, Any] = {id(n): x for n, x in zip(self.inputs, xs)}
        updates: State = {}
        site = 0
        for node in self._order:
            if id(node) in values:
                continue
            if node.layer is None:
                raise ValueError("Disconnected input node in graph")
            args = [values[id(i)] for i in node.inputs]
            arg = args if len(args) > 1 else (args[0] if args else None)
            sub = None if seed is None else site_seed(seed, site)
            site += 1
            y, upd = node.layer.call_and_state(arg, training=training,
                                               seed=sub)
            values[id(node)] = y
            _add_updates(updates, node.layer, upd)
        outs = [values[id(o)] for o in self.outputs]
        return (outs if len(outs) > 1 else outs[0]), updates

    def compute_output_shape(self, input_shape):
        outs = [o.shape for o in self.outputs]
        return outs if len(outs) > 1 else outs[0]

    def ordered_layers(self) -> List:
        return list(self._layers)
