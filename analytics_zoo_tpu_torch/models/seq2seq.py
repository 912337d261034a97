"""Seq2seq: an RNN encoder and decoder with a bridge, teacher forcing and
greedy inference.

Port of `analytics_zoo_tpu/models/seq2seq.py`: `_make_cells` (L25),
`_run_rnn` (L33), `_Seq2seqNet` (L48) with `encode`, `_bridge_states`,
`decode` and `apply`, and `Seq2seq` (L131) with `infer` (L163): the
reference's `Seq2seq.scala:59-103` (`RNNEncoder` / `RNNDecoder` stacks, an
optional `dense` bridge from the encoder's final states to the decoder's
initial ones, an optional generator head; `infer` feeds each prediction
back). The cells are the port's recurrent layers (`keras/layers.py`), run
step by step in a Python loop as their own `call` runs them; a state is a
tensor, or an LSTM's `(h, c)` pair.

`_Seq2seqNet` is a `KerasNet` with its own forward, as in the JAX package.
Its state dict follows the JAX tree: the cells under their names
(`enc_0.kernel`, ...), the bridge's maps as `bridge_{i}.{j}.kernel` /
`.bias` (the JAX tree's `bridge_{i}` list, one map a state tensor) and
`generator.kernel` / `.bias`; `convert.seq2seq_params_from_jax` and
`seq2seq_params_to_jax` carry it across. The cells' input kernels take
their widths from the first inputs the net sees (`ensure_built(sample)`,
which `fit` calls).

`device` says where the parameters are created (None is `cuda`; the CPU
only when asked).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import (KerasNet, _sample_shape,
                                                  new_parameter)
from analytics_zoo_tpu_torch.models.common import ZooModel


def _make_cells(rnn_type: str, hidden_sizes: Sequence[int], prefix: str,
                device: DeviceLike = None) -> List[L._Recurrent]:
    cls = {"lstm": L.LSTM, "gru": L.GRU, "simplernn": L.SimpleRNN}[
        rnn_type.lower()]
    return [cls(h, return_sequences=True, name=f"{prefix}_{i}",
                device=device)
            for i, h in enumerate(hidden_sizes)]


def _cell_step(cell: L._Recurrent, carry, x_t):
    """One step of `cell` on the step's input `x_t` [B, F]."""
    xw_t = torch.addmm(cell.bias, L._match_param_dtype(x_t, cell.kernel),
                       cell.kernel)
    return cell.step(carry, xw_t)


def _run_rnn(cell: L._Recurrent, x, carry=None):
    """One recurrent layer over [B, T, F] → (sequence, final carry)."""
    if carry is None:
        carry = cell.initial_state(x.shape[0])
    outs = []
    for x_t in x.unbind(1):
        carry, h = _cell_step(cell, carry, x_t)
        outs.append(h)
    return torch.stack(outs, dim=1), carry


class _Affine(nn.Module):
    """`x @ kernel + bias` ([in, out], the JAX layout), the bridge's and
    the generator's map; Glorot-uniform kernel, zero bias at build."""

    def __init__(self, n_in: int, n_out: int, device: DeviceLike = None):
        super().__init__()
        self.kernel = new_parameter((n_in, n_out), device, torch.float32)
        self.bias = new_parameter((n_out,), device, torch.float32)

    def build(self, generator) -> None:
        L.fill_(self.kernel, L.get_init("glorot_uniform")(
            generator, tuple(self.kernel.shape)))
        L.fill_(self.bias, torch.zeros(self.bias.shape))

    def forward(self, x):
        return L._match_param_dtype(x, self.kernel) @ self.kernel + self.bias


class _Seq2seqNet(KerasNet):
    """`apply([enc_input, dec_input])` → the decoder's outputs."""

    def __init__(self, encoder_cells, decoder_cells, bridge: Optional[str],
                 generator_units: Optional[int], device: DeviceLike = None):
        super().__init__()
        self.encoder_cells = encoder_cells
        self.decoder_cells = decoder_cells
        self.bridge = bridge
        self.generator_units = generator_units
        self._params_created = False
        for cell in list(encoder_cells) + list(decoder_cells):
            self.add_module(cell.name, cell)
        if bridge == "dense":
            # one map per encoder state tensor per layer
            for i, (e, d) in enumerate(zip(encoder_cells, decoder_cells)):
                n_states = 2 if isinstance(e, L.LSTM) else 1
                self.add_module(f"bridge_{i}", nn.ModuleList(
                    _Affine(e.output_dim, d.output_dim, device)
                    for _ in range(n_states)))
        elif bridge is not None:
            raise ValueError(f"Unsupported bridge: {bridge}")
        self.generator = _Affine(decoder_cells[-1].output_dim,
                                 generator_units, device) \
            if generator_units else None

    def _bridges(self) -> List[nn.ModuleList]:
        return [getattr(self, f"bridge_{i}")
                for i in range(len(self.encoder_cells))] \
            if self.bridge == "dense" else []

    # -- parameters ---------------------------------------------------------
    def create_parameters(self, input_shape) -> None:
        """The cells' kernels from the `[encoder, decoder]` input shapes."""
        for cells, shape in zip((self.encoder_cells, self.decoder_cells),
                                input_shape):
            for cell in cells:
                cell.ensure_parameters(shape)
                shape = cell.compute_output_shape(shape)
        self._params_created = True

    def ensure_built(self, sample_input=None, seed: int = 0
                     ) -> Dict[str, torch.Tensor]:
        if not self._params_created:
            if sample_input is None:
                raise ValueError(f"Cannot build {self.name}: the cells' "
                                 "widths come from a sample input")
            self.create_parameters([_sample_shape(s) for s in sample_input])
        return super().ensure_built(sample_input, seed)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """As `KerasNet.load_state_dict`; a net whose cells have no kernels
        yet (a saved model being loaded) takes their input widths from the
        state's first encoder and decoder kernels."""
        if not self._params_created:
            first = [cells[0].name + ".kernel" for cells in
                     (self.encoder_cells, self.decoder_cells)]
            self.create_parameters([(None, None, state_dict[k].shape[0])
                                    for k in first])
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def build(self, generator: torch.Generator) -> None:
        for cell in list(self.encoder_cells) + list(self.decoder_cells):
            cell.build(generator)
        for maps in self._bridges():
            for m in maps:
                m.build(generator)
        if self.generator is not None:
            self.generator.build(generator)

    # -- pieces ---------------------------------------------------------------
    def encode(self, x):
        states = []
        for cell in self.encoder_cells:
            x, carry = _run_rnn(cell, x)
            states.append(carry)
        return x, states

    def _bridge_states(self, states):
        if self.bridge is None:
            return states
        out = []
        for carry, maps in zip(states, self._bridges()):
            if isinstance(carry, tuple):
                out.append(tuple(torch.tanh(m(s))
                                 for s, m in zip(carry, maps)))
            else:
                out.append(torch.tanh(maps[0](carry)))
        return out

    def decode(self, y_in, init_states):
        x = y_in
        for cell, carry in zip(self.decoder_cells, init_states):
            x, _ = _run_rnn(cell, x, carry)
        if self.generator is not None:
            x = self.generator(x)
        return x

    def apply(self, inputs, *, training: bool = False,
              seed: Optional[int] = None):
        enc_in, dec_in = inputs
        _, states = self.encode(enc_in)
        return self.decode(dec_in, self._bridge_states(states))

    def compute_output_shape(self, input_shape):
        return None


class Seq2seq(ZooModel):
    """`Seq2seq(rnn_type, encoder_hidden, decoder_hidden, bridge=...)`.
    Train with x = [encoder sequence, decoder input sequence] (teacher
    forcing), y = the decoder's target sequence."""

    def __init__(self, rnn_type: str = "lstm",
                 encoder_hidden: Sequence[int] = (32,),
                 decoder_hidden: Sequence[int] = (32,),
                 bridge: Optional[str] = None,
                 generator_units: Optional[int] = None,
                 device: DeviceLike = None):
        super().__init__()
        if len(encoder_hidden) != len(decoder_hidden):
            raise ValueError(
                "rnn encoder and decoder should have the same number of "
                "layers")  # `Seq2seq.scala:175-176`
        if bridge is None:
            for e, d in zip(encoder_hidden, decoder_hidden):
                if e != d:
                    raise ValueError("without a bridge, encoder/decoder "
                                     "hidden sizes must match")
        self._config = dict(rnn_type=rnn_type,
                            encoder_hidden=list(encoder_hidden),
                            decoder_hidden=list(decoder_hidden),
                            bridge=bridge, generator_units=generator_units)
        enc = _make_cells(rnn_type, encoder_hidden, "enc", device)
        dec = _make_cells(rnn_type, decoder_hidden, "dec", device)
        self.model = _Seq2seqNet(enc, dec, bridge, generator_units, device)

    def infer(self, enc_input: np.ndarray, start_sign: np.ndarray,
              max_seq_len: int = 30) -> np.ndarray:
        """Greedy autoregressive decoding, each prediction fed back
        (`Seq2seq.scala` infer). `start_sign`: [B, F], the first decoder
        input. Returns [B, max_seq_len, out] as numpy."""
        net = self.model
        if not net.built:
            raise ValueError("Model has no parameters; fit or build first")
        device = next(net.parameters()).device
        with torch.inference_mode():
            _, states = net.encode(torch.as_tensor(enc_input, device=device))
            carries = net._bridge_states(states)
            y_t = torch.as_tensor(start_sign, device=device)
            outs = []
            for _ in range(max_seq_len):
                x_t = y_t
                new_carries = []
                for cell, carry in zip(net.decoder_cells, carries):
                    carry, x_t = _cell_step(cell, carry, x_t)
                    new_carries.append(carry)
                carries = new_carries
                if net.generator is not None:
                    x_t = net.generator(x_t)
                outs.append(x_t)
                y_t = x_t
            return torch.stack(outs, dim=1).float().cpu().numpy()
