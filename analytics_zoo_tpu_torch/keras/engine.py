"""Keras-style model engine: the `Layer` and `KerasNet` base classes.

Port of `analytics_zoo_tpu/keras/engine.py`: `Layer` (L49), `KerasNet`
(L151) with `compile` (L183, the single-loss form) and `fit` (L246), and
`ensure_built` (L234). In the JAX package a layer is a pure
function plus a parameter pytree (`build(rng, shape) -> params`,
`call(params, x)`); here a layer is an `nn.Module` that owns its
parameters, so the parameter argument goes away:

- `Layer.call(x, *, training=False, ...)` is the forward of a layer;
- `KerasNet.apply(inputs, *, training=False, seed=None)` is the forward
  of a model (it shadows `nn.Module.apply`, whose init-by-callback use the
  port does not need: `build` initialises parameters); `seed`, the JAX
  `rng`, is the integer a training step's dropout sites derive their
  seeds from;
- parameters are created at construction, with the sizes the layer's
  config gives, on the layer's `device` and `dtype`, and hold no values
  until `build(generator)` fills them (the JAX init families: Glorot
  uniform kernels, zero biases, N(0, 0.02) embeddings) or a state dict is
  loaded (`convert.params_from_jax` carries JAX weights across).

Parameters are trainable (`requires_grad`); serving runs under
`torch.inference_mode`, so it builds no autograd graph. `evaluate` and
`predict` (which need `ops/metrics.py`), the symbolic graph (`Node`,
`Input`, `Sequential`, `Model`) and weight persistence wait for later
slices of the port (ROADMAP.md queue 1).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device

_name_counters: Dict[str, int] = collections.defaultdict(int)


def _auto_name(cls_name: str) -> str:
    _name_counters[cls_name] += 1
    return f"{cls_name.lower()}_{_name_counters[cls_name]}"


def new_parameter(shape, device: DeviceLike, dtype: torch.dtype
                  ) -> nn.Parameter:
    """An unfilled, trainable parameter; `build` or a loaded state dict
    sets it."""
    return nn.Parameter(torch.empty(shape, device=resolve_device(device),
                                    dtype=dtype))


class Layer(nn.Module):
    """Base layer. Subclasses create their parameters in `__init__`,
    fill them in `build`, and implement `call`."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)

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

    def call(self, x, *, training: bool = False):
        raise NotImplementedError

    def forward(self, *args, **kwargs):
        return self.call(*args, **kwargs)

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name})"


class KerasNet(nn.Module):
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
        (`ops/optimizers.py`, `ops/objectives.py`). The compile string is
        remembered (`_optimizer_spec`) so `fit(fused_optimizer=True)` can
        find its fused twin. A list of losses (multi-output) and metrics
        are not ported yet."""
        from analytics_zoo_tpu_torch.ops import objectives, optimizers
        if isinstance(loss, (list, tuple)):
            raise NotImplementedError(
                "compile() with one loss per output is not ported yet "
                f"({optimizers.NOT_PORTED_QUEUE})")
        if metrics:
            raise NotImplementedError(
                "compile(metrics=...) is not ported yet: metrics come with "
                f"evaluate/predict ({optimizers.NOT_PORTED_QUEUE})")
        self._optimizer_spec = optimizer if isinstance(optimizer, str) \
            else None
        self.loss = objectives.get(loss)
        self.optimizer = optimizers.get(optimizer)
        self.metrics = []

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 1,
            validation_data=None, distributed: bool = True, **kwargs):
        """Train on in-memory arrays where the parameters live; returns
        the history dict (`learn/trainer.fit_keras`)."""
        from analytics_zoo_tpu_torch.learn.trainer import fit_keras
        return fit_keras(self, x, y, batch_size=batch_size, epochs=nb_epoch,
                         validation_data=validation_data,
                         distributed=distributed, **kwargs)

    # -- parameters ----------------------------------------------------------
    @property
    def built(self) -> bool:
        """True once `ensure_built` or `load_state_dict` gave the
        parameters values (the JAX package's `params is not None`)."""
        return self._built

    def ensure_built(self, sample_input=None, seed: int = 0
                     ) -> Dict[str, torch.Tensor]:
        """Initialise parameters from `seed` unless already built or loaded;
        returns the state dict. `sample_input` is accepted for the JAX
        signature; sizes come from the model's config."""
        if not self._built:
            with torch.no_grad():
                self.build(torch.Generator().manual_seed(seed))
            self._built = True
        return self.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        result = super().load_state_dict(state_dict, strict=strict,
                                         assign=assign)
        self._built = True
        return result
