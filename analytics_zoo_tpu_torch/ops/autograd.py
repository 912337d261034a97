"""Autograd DSL: symbolic `Variable` math, `Lambda` layers, `Parameter`,
`Constant` and `CustomLoss`.

Port of `analytics_zoo_tpu/ops/autograd.py`: `_infer_shape` (L24),
`LambdaLayer` / `Lambda` (L39-57), `pad_lambda` (L60), `Variable` with its
operators, `slice`, `index_select` and `squeeze` (L69-190), the unary ops
(L192-207), `sum`, `mean`, `clip`, `pow`, `maximum`, `mm`, `dot`,
`l2_normalize`, `slice`, `index_select`, `softmax`, `expand_dims`,
`squeeze`, `stack`, `concatenate` (L210-303), `ParameterLayer` /
`Parameter` (L306-385), `ConstantLayer` / `Constant` (L387-408),
`CustomLoss` (L414) and `custom_loss_from_fn` (L435). Every op records a
function on torch tensors as a parameterless layer in the same `Node`
graph the functional `Model` uses, with the JAX package's layer classes
and names (`add_3`, `lambdalayer_7`), so a graph's layer list, summary and
saved tree are the JAX package's.

Shape inference runs the function once on zero tensors of the input
shapes (batch 1, float32, as the JAX package's `jax.eval_shape` dummies)
under `torch.no_grad()`; a None batch dimension comes back when an input
had one. The dummies go where the tensors the function captures live (its
closure and default arguments: a normalisation's mean and std made on the
card), else on the CPU. The function keeps its inputs' dtype rules: a
uint8 image stays uint8 until the function casts it.

`Parameter` and `Constant` take `device` (None is `cuda`, as for every
layer of the port). A `Parameter`'s value is a parameter of its layer,
`value`, as the leaf of the JAX tree; a `Constant`'s is a buffer kept out
of the state dict, as the JAX package keeps it out of the tree.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.keras.engine import (Input, Layer, Model, Node,
                                                  new_parameter)
from analytics_zoo_tpu_torch.keras.layers import fill_
from analytics_zoo_tpu_torch.ops.objectives import Objective


def _captured_device(fn: Callable) -> torch.device:
    """The device of the first tensor `fn` captures (closure cells,
    default arguments), else the CPU."""
    values = list(getattr(fn, "__defaults__", None) or ())
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            values.append(cell.cell_contents)
        except ValueError:          # a cell not yet bound
            continue
    for value in values:
        if isinstance(value, torch.Tensor):
            return value.device
    return torch.device("cpu")


def _run_on_zeros(fn: Callable, in_shapes: Sequence,
                  device: torch.device) -> tuple:
    dummies = [torch.zeros(tuple(1 if d is None else d for d in s),
                           device=device) for s in in_shapes]
    with torch.no_grad():
        return tuple(fn(*dummies).shape)


def _infer_shape(fn: Callable, in_shapes: Sequence) -> tuple:
    """Shape inference by one run on float32 zeros; None batch dims become
    1 and come back as None. The zeros lie where the tensors `fn`'s
    closure or defaults capture lie; a function that holds its CUDA
    tensors elsewhere (a `functools.partial`, a bound method, a global)
    fails on CPU zeros and is run once more on the card's."""
    device = _captured_device(fn)
    try:
        shape = _run_on_zeros(fn, in_shapes, device)
    except RuntimeError:
        if device.type != "cpu" or not torch.cuda.is_available():
            raise
        shape = _run_on_zeros(fn, in_shapes, resolve_device(None))
    # restore the None batch dim if any input had one (Parameter/Constant
    # sources have fully-concrete shapes and broadcast against the batch)
    if shape and any(s and s[0] is None for s in in_shapes):
        shape = (None,) + tuple(shape[1:])
    return shape


class LambdaLayer(Layer):
    """A parameterless layer from a function on tensors
    (`Lambda.scala:49`); a list input is passed as separate arguments."""

    def __init__(self, function: Callable, **kw):
        super().__init__(**kw)
        self.function = function

    def call(self, x, *, training: bool = False):
        if isinstance(x, (list, tuple)):
            return self.function(*x)
        return self.function(x)

    def compute_output_shape(self, input_shape):
        shapes = input_shape if isinstance(input_shape, list) \
            else [input_shape]
        return _infer_shape(self.function, shapes)


# keep the pyzoo name
Lambda = LambdaLayer


def pad_lambda(pad_cfg, value: float = 0.0) -> LambdaLayer:
    """A LambdaLayer that pads with `value`, `pad_cfg` one (before, after)
    pair a dimension, as `jnp.pad` takes it."""
    flat = [int(n) for pair in reversed(tuple(pad_cfg)) for n in pair]

    def fn(t, pads=tuple(flat), v=value):
        return F.pad(t, pads, value=v)
    return LambdaLayer(fn)


class Variable:
    """Symbolic tensor with math operators (`math.scala:378`). Wraps a graph
    Node; interchangeable with Keras functional-API nodes."""

    def __init__(self, input_shape=None, node: Optional[Node] = None,
                 name: Optional[str] = None):
        if node is not None:
            self.node = node
        elif input_shape is not None:
            self.node = Input(shape=tuple(input_shape), name=name)
        else:
            raise ValueError("Variable needs input_shape or node")

    @property
    def shape(self):
        return self.node.shape

    # -- op plumbing -------------------------------------------------------
    @staticmethod
    def _lift(fn: Callable, *vs: "Variable", name: str = "op") -> "Variable":
        layer = LambdaLayer(fn, name=None)
        layer.name = layer.name.replace("lambdalayer", name)
        nodes = [v.node for v in vs]
        out = layer(nodes if len(nodes) > 1 else nodes[0])
        return Variable(node=out)

    def _binop(self, other, fn, name):
        if isinstance(other, Variable):
            return Variable._lift(fn, self, other, name=name)
        const = other
        return Variable._lift(lambda a: fn(a, const), self, name=name)

    def _rbinop(self, other, fn, name):
        const = other
        return Variable._lift(lambda a: fn(const, a), self, name=name)

    # -- operators ---------------------------------------------------------
    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b, "add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b, "sub")

    def __rsub__(self, other):
        return self._rbinop(other, lambda a, b: a - b, "rsub")

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b, "mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / b, "div")

    def __rtruediv__(self, other):
        return self._rbinop(other, lambda a, b: a / b, "rdiv")

    def __pow__(self, p):
        return self._binop(p, lambda a, b: a ** b, "pow")

    def __neg__(self):
        return Variable._lift(lambda a: -a, self, name="neg")

    def __getitem__(self, idx):
        return Variable._lift(lambda a: a[idx], self, name="slice")

    def _resolve_nonbatch_dim(self, dim: int, op: str) -> int:
        """Normalize `dim` against this variable's rank and reject the batch
        dimension (the reference contract for slice/index_select)."""
        rank = len(self.shape)
        if not -rank <= dim < rank:
            raise ValueError(f"{op}: dim {dim} out of range for rank {rank}")
        d = dim % rank
        if d == 0 and self.shape[0] is None:
            raise ValueError(f"Cannot {op} the batch dimension")
        return d

    # -- torch-style narrowing (`autograd.py:317,340`) ---------------------
    def slice(self, dim: int, start_index: int, length: int = 1
              ) -> "Variable":
        """Narrow `dim` to [start_index, start_index+length) without reducing
        rank; length=-1 runs to the end. dim counts the batch dim (0), which
        cannot be narrowed — matching the reference contract."""
        d = self._resolve_nonbatch_dim(dim, "slice")

        def fn(a, d=d, s=start_index, l=length):
            ln = a.shape[d] - s if l == -1 else l
            return a.narrow(d, s, ln)
        return Variable._lift(fn, self, name="slice")

    def index_select(self, dim: int, index: int) -> "Variable":
        """Select one index along `dim`, removing that dim (-1 selects the
        last position). The batch dim cannot be selected."""
        d = self._resolve_nonbatch_dim(dim, "index_select")
        size = self.shape[d]
        if size is not None and not -size <= index < size:
            raise IndexError(
                f"index_select: index {index} out of range for dim {dim} "
                f"of size {size}")

        def fn(a, d=d, i=index):
            return a.select(d, i % a.shape[d])
        return Variable._lift(fn, self, name="index_select")

    def squeeze(self, dim: Optional[int] = None) -> "Variable":
        """Delete singleton dim(s). With dim=None all non-batch singleton
        dims are removed (the dynamic batch dim is never squeezed — a dummy
        batch of 1 must not change the graph's rank)."""
        if dim is not None:
            d = self._resolve_nonbatch_dim(dim, "squeeze")
            return Variable._lift(lambda a: a.squeeze(d), self,
                                  name="squeeze")

        def fn(a):
            axes = tuple(i for i in range(1, a.dim()) if a.shape[i] == 1)
            return a.squeeze(axes) if axes else a
        return Variable._lift(fn, self, name="squeeze")


# ---------------------------------------------------------------------------
# Module-level math functions (`pyzoo/zoo/pipeline/api/autograd.py` surface)
# ---------------------------------------------------------------------------
def _unary(fn, name):
    def op(v: Variable) -> Variable:
        return Variable._lift(fn, v, name=name)
    op.__name__ = name
    return op


abs = _unary(torch.abs, "abs")          # noqa: A001
square = _unary(torch.square, "square")
sqrt = _unary(torch.sqrt, "sqrt")
exp = _unary(torch.exp, "exp")
log = _unary(torch.log, "log")
neg = _unary(lambda a: -a, "neg")
erf = _unary(torch.erf, "erf")
softsign = _unary(F.softsign, "softsign")
softplus = _unary(F.softplus, "softplus")


def sum(v: Variable, axis: int = 0, keepdims: bool = False  # noqa: A001
        ) -> Variable:
    """The sum over `axis`, which counts the batch dimension (0), as
    `jnp.sum` takes it."""
    return Variable._lift(
        lambda a: torch.sum(a, dim=axis, keepdim=keepdims), v, name="sum")


def mean(v: Variable, axis: int = 0, keepdims: bool = False) -> Variable:
    return Variable._lift(
        lambda a: torch.mean(a, dim=axis, keepdim=keepdims), v, name="mean")


def clip(v: Variable, min: float, max: float) -> Variable:  # noqa: A002
    return Variable._lift(lambda a: torch.clamp(a, min, max), v, name="clip")


def pow(v: Variable, a: float) -> Variable:  # noqa: A001
    return v ** a


def maximum(a: Variable, b) -> Variable:
    if isinstance(b, Variable):
        return Variable._lift(torch.maximum, a, b, name="maximum")
    return Variable._lift(lambda x: torch.clamp(x, min=b), a, name="maximum")


def _batched_contract(a: torch.Tensor, b: torch.Tensor, ax: int, ay: int
                      ) -> torch.Tensor:
    """`lax.dot_general` contracting a's axis `ax` with b's `ay`, batch
    dimension 0 of both: [B, *a's free dims, *b's free dims]."""
    a = a.movedim(ax % a.dim(), -1)
    b = b.movedim(ay % b.dim(), 1)
    free_a, free_b = a.shape[1:-1], b.shape[2:]
    out = torch.bmm(a.reshape(a.shape[0], -1, a.shape[-1]),
                    b.reshape(b.shape[0], b.shape[1], -1))
    return out.reshape((a.shape[0],) + tuple(free_a) + tuple(free_b))


def mm(x: Variable, y: Variable, axes: Optional[Sequence[int]] = None
       ) -> Variable:
    """Batched matmul contracting the given axes (`autograd.py mm`)."""
    if axes is None:
        return Variable._lift(torch.matmul, x, y, name="mm")
    ax, ay = axes
    return Variable._lift(lambda a, b: _batched_contract(a, b, ax, ay), x, y,
                          name="mm")


def dot(x: Variable, y: Variable, axes=None, normalize: bool = False
        ) -> Variable:
    def fn(a, b):
        if normalize:
            a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True),
                                min=1e-7)
            b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True),
                                min=1e-7)
        return torch.sum(a * b, dim=-1, keepdim=True)
    return Variable._lift(fn, x, y, name="dot")


def l2_normalize(v: Variable, axis: int) -> Variable:
    """Normalize wrt the L2 norm along `axis` (`autograd.py:80`
    l2_normalize). Uses the TF epsilon (1e-12) under the root."""
    def fn(a):
        sq = torch.sum(torch.square(a), dim=axis, keepdim=True)
        return a * torch.rsqrt(torch.clamp(sq, min=1e-12))
    return Variable._lift(fn, v, name="l2_normalize")


def slice(v: Variable, dim: int, start_index: int,  # noqa: A001
          length: int = 1) -> Variable:
    return v.slice(dim, start_index, length)


def index_select(v: Variable, dim: int, index: int) -> Variable:
    return v.index_select(dim, index)


def softmax(v: Variable, axis: int = -1) -> Variable:
    return Variable._lift(lambda a: torch.softmax(a, dim=axis), v,
                          name="softmax")


def expand_dims(v: Variable, axis: int) -> Variable:
    return Variable._lift(lambda a: a.unsqueeze(axis), v,
                          name="expand_dims")


def squeeze(v: Variable, axis: Optional[int] = None) -> Variable:
    return v.squeeze(axis)  # batch-dim-safe method semantics


def stack(vs: Sequence[Variable], axis: int = 1) -> Variable:
    return Variable._lift(lambda *xs: torch.stack(xs, dim=axis), *vs,
                          name="stack")


def concatenate(vs: Sequence[Variable], axis: int = -1) -> Variable:
    return Variable._lift(lambda *xs: torch.cat(xs, dim=axis), *vs,
                          name="concat")


# ---------------------------------------------------------------------------
# Parameter / Constant (`pyzoo/zoo/pipeline/api/autograd.py:462,524`)
# ---------------------------------------------------------------------------
class ParameterLayer(Layer):
    """Zero-input source layer holding one trainable tensor, `value`.
    Default init is RandomUniform(-0.05, 0.05), matching the reference's
    default (`autograd.py:462` Parameter docstring). Not trainable: the
    value leaves the gradient (the optimizer sees a zero gradient)."""

    def __init__(self, shape: Sequence[int], init_weight=None,
                 trainable: bool = True, init_range: float = 0.05,
                 device: DeviceLike = None, **kw):
        super().__init__(**kw)
        self.pshape = tuple(int(d) for d in shape)
        self.init_weight = init_weight
        self.trainable = trainable
        self.init_range = init_range
        self.value = new_parameter(self.pshape, device, torch.float32)

    def build(self, generator):
        if self.init_weight is not None:
            val = torch.as_tensor(np.asarray(self.init_weight, np.float32))
            if tuple(val.shape) != self.pshape:
                raise ValueError(
                    f"init_weight shape {tuple(val.shape)} != Parameter "
                    f"shape {self.pshape}")
        else:
            val = (torch.rand(self.pshape, generator=generator) * 2.0
                   - 1.0) * self.init_range
        fill_(self.value, val)
        return self

    def call(self, x, *, training: bool = False):
        return self.value if self.trainable else self.value.detach()

    def compute_output_shape(self, input_shape):
        return self.pshape


class Parameter(Variable):
    """A trainable standalone Variable (`autograd.py:462`), usable anywhere
    in a functional graph or a Variable expression. Its value is the
    parameter `value` of the layer named after it, so the optimizer steps
    it like any weight. `get_weight` reads it; `set_weight` writes it and
    the value a later `build` starts from."""

    def __init__(self, shape: Sequence[int], init_weight=None,
                 trainable: bool = True, name: Optional[str] = None,
                 device: DeviceLike = None):
        layer = ParameterLayer(shape, init_weight=init_weight,
                               trainable=trainable, device=device, name=name)
        # zero-input source node (a symbolic call needs inputs)
        super().__init__(node=Node(layer=layer, inputs=[],
                                   shape=layer.pshape))
        self._layer = layer

    @property
    def name(self) -> str:
        return self._layer.name

    def get_weight(self) -> np.ndarray:
        """The current value, as a float32 numpy array of its own."""
        return np.array(self._layer.value.detach().float().cpu().numpy())

    def set_weight(self, value) -> None:
        value = np.asarray(value, np.float32)
        if value.shape != self._layer.pshape:
            raise ValueError(
                f"set_weight shape {value.shape} != Parameter shape "
                f"{self._layer.pshape}")
        self._layer.init_weight = value
        fill_(self._layer.value, torch.from_numpy(value))


class ConstantLayer(Layer):
    """Zero-input source layer emitting a captured constant (float32), in
    a buffer that moves with the model and stays out of its state
    dict."""

    def __init__(self, data, device: DeviceLike = None, **kw):
        super().__init__(**kw)
        self.register_buffer("data", torch.as_tensor(
            np.asarray(data, np.float32), device=resolve_device(device)),
            persistent=False)

    def call(self, x, *, training: bool = False):
        return self.data

    def compute_output_shape(self, input_shape):
        return tuple(self.data.shape)


class Constant(Variable):
    """A constant Variable without weights (`autograd.py:524`)."""

    def __init__(self, data, name: Optional[str] = None,
                 device: DeviceLike = None):
        layer = ConstantLayer(data, device=device, name=name)
        super().__init__(node=Node(layer=layer, inputs=[],
                                   shape=tuple(layer.data.shape)))


# ---------------------------------------------------------------------------
# CustomLoss (`CustomLoss.scala:66`, pyzoo CustomLoss)
# ---------------------------------------------------------------------------
class CustomLoss(Objective):
    """A loss objective from a Variable expression over (y_true, y_pred)
    placeholders: the mean of the expression's value over the batch.

    >>> y_true = Variable(input_shape=(3,))
    >>> y_pred = Variable(input_shape=(3,))
    >>> loss = CustomLoss(mean(square(y_true - y_pred), axis=1), y_true, y_pred)
    >>> model.compile("adam", loss)

    float64 labels are taken as float32, as the JAX package takes them."""

    def __init__(self, loss_var: Variable, y_true: Variable,
                 y_pred: Variable):
        self._model = Model([y_true.node, y_pred.node], loss_var.node)
        self._model.ensure_built(seed=0)

    def __call__(self, y_true, y_pred):
        ys = [torch.as_tensor(y) for y in (y_true, y_pred)]
        ys = [y.float() if y.dtype == torch.float64 else y for y in ys]
        return torch.mean(self._model.apply(ys))


def custom_loss_from_fn(fn: Callable) -> Callable:
    """A plain fn(y_true, y_pred) -> scalar on tensors, as a loss (what the
    DSL compiles down to anyway)."""
    return fn

