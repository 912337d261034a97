"""The training loop behind `KerasNet.fit` and `Estimator.fit`.

Port of the single-device path of `analytics_zoo_tpu/learn/trainer.py`:
`_tree_len` / `_tree_take` / `_num_batches` (L143-155), `iter_batches`
(L158), `_cast_tree` (L647), `_make_one_step` (L737, without sharding) as
`build_train_step` (L805), `_pick_one_step` (L968), `build_eval_step`
(L985), `fit_keras` (L996) with its lazy-embedding branch (L1327-1330,
L1356-1369, L1385-1388), `evaluate_keras` (L1906) and `predict_keras`
(L1974).

- Batching: `iter_batches` with the same `np.random.RandomState(seed +
  epoch)` shuffle and the same dropped remainder, so a port fit and a JAX
  fit (with `device_cache=False`, which the JAX package would otherwise
  pick on one device and shuffle on the device) see the same batches in
  the same order.
- Mixed precision as the JAX package does it (L748-775): f32 master
  parameters; each step runs the forward on bf16 casts of them through
  `torch.func.functional_call`, so autograd returns f32 gradients to the
  masters through the cast; the predictions are cast to f32 before the
  loss; inputs are never cast. Not `torch.autocast`, whose per-op dtype
  policy is not what the JAX package computes.
- Stateful layers (BatchNorm): the state path of the JAX step (L755-787,
  `_merge_state` L634) is the training forward itself. `Model.apply`
  writes each stateful layer's updates into its buffers
  (`keras.engine.merge_state`); under mixed precision they are computed
  from the bf16 casts of the parameters and statistics, as the JAX step
  computes them, and land in the float32 buffers. The optimizer steps
  `named_parameters()` only, so the moving statistics have no moments
  (the JAX sweep carries them as leaves whose update `_merge_state` then
  overwrites: 267 leaves against 161 for ResNet-50). `evaluate` and
  `predict` read the moving statistics.
- One optimizer step per batch: `fused_apply` (the fused-Adam kernel, in
  place) when the optimizer has it, else `update` and `p += u`.
  `fused_optimizer=True` swaps the compiled optimizer for its fused twin
  (`ops.optimizers.as_fused`), or keeps the plain one with a warning when
  it has none. There is no availability probe: a kernel that fails to
  build or launch raises.
- `lazy_embeddings=True` trains the tables the model declares
  (`lazy_embedding_specs`) row-sparse: with `fused_optimizer=True` through
  the segment kernels (`kernels/segment_update.make_fused_one_step`, which
  keeps them even when the rest has no fused twin), else through the plain
  row Adam of `learn/lazy_embedding.make_lazy_one_step`.
- `evaluate` and `predict` run the forward under `torch.inference_mode`
  in batches of `batch_per_thread` (one device), the last batch padded to
  the full size by repeating its last row and the padding's outputs
  dropped, as the JAX package does.
- Seeds: one integer per step from a `torch.Generator` seeded with `seed`,
  handed to the model's dropout sites.
- History: `history["loss"]` holds one mean per epoch; the step losses
  stay on the device and are read once per epoch (the only host sync).

The optimizer state starts fresh at each call, as in the JAX package.
Steps are dispatched one by one: `steps_per_run=k` is accepted for the
JAX signature (k steps between loss reads there) and changes nothing here,
since losses are read once per epoch anyway; a k-step CUDA graph is
ROADMAP work. The arguments of the JAX loop that are not ported raise
NotImplementedError when given a value other than their default.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_map
from analytics_zoo_tpu_torch.ops.optimizers import NOT_PORTED_QUEUE, as_fused

log = logging.getLogger("analytics_zoo_tpu_torch.learn")

# Arguments of the JAX `fit_keras` that the port does not run yet, with
# their defaults: a value other than the default raises.
_NOT_PORTED_ARGS = {
    "validation_data": None,        # per-epoch validation
    "checkpoint_trigger": None,     # checkpoints and auto-resume
    "end_trigger": None,
    "batch_iter_factory": None,     # streaming datasets
    "prefetch_depth": None,         # the background input pipeline
    "sharding_rules": None,         # distributed training
    "flops_per_step": None,         # training telemetry
    "metrics_report_s": None,
    "compile_cache_dir": None,
    "auto_resume": False,
    "int8_sidecar": False,
    "step_retries": 0,
    "step_timeout_s": None,
    "profile_steps": None,
    "profile_dir": None,
}


# ---------------------------------------------------------------------------
# Data plumbing: numpy structures -> batches
# ---------------------------------------------------------------------------
def _tree_len(x) -> int:
    leaves = tree_leaves(x)
    if not leaves:
        raise ValueError("Empty input data")
    return int(np.shape(leaves[0])[0])


def _tree_take(x, idx):
    return tree_map(lambda a: np.asarray(a)[idx], x)


def _num_batches(n: int, batch: int, drop_remainder: bool) -> int:
    return n // batch if drop_remainder else -(-n // batch)


def iter_batches(x, y=None, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 0, drop_remainder: bool = True,
                 pad_to_batch: bool = False):
    """Yield (x_batch, y_batch, real_count) of numpy arrays."""
    n = _tree_len(x)
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    nb = _num_batches(n, batch_size, drop_remainder and not pad_to_batch)
    for b in range(nb):
        sel = idx[b * batch_size:(b + 1) * batch_size]
        real = len(sel)
        if real < batch_size:
            if pad_to_batch:
                sel = np.concatenate([sel, np.repeat(sel[-1:],
                                                     batch_size - real)])
            else:
                continue
        xb = _tree_take(x, sel)
        yb = _tree_take(y, sel) if y is not None else None
        yield xb, yb, real


def _to_device(tree, device: torch.device):
    return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        device, non_blocking=True), tree)


def _cast_tree(tree: Dict[str, torch.Tensor], dtype: torch.dtype,
               only: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    return {k: v.to(dtype) if v.dtype == only else v
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# One step
# ---------------------------------------------------------------------------
def build_train_step(model, loss_fn: Callable, optimizer,
                     mixed_precision: bool = False) -> Callable:
    """One iteration as a function, `one_step(params, opt_state, xb, yb,
    seed) -> (params, opt_state, loss)`: forward, backward and the
    optimizer step. `params` are the model's own parameters (the f32
    masters), updated in place. PyTorch runs eagerly: there is no program
    to compile or buffers to donate."""
    fused_apply = getattr(optimizer, "fused_apply", None)

    def one_step(params, opt_state, xb, yb, seed: int):
        with torch.enable_grad():
            p = _cast_tree(params, torch.bfloat16) if mixed_precision \
                else params
            pred = functional_call(model, p, (xb,),
                                   {"training": True, "seed": seed})
            if mixed_precision:
                pred = tree_map(lambda a: a.float(), pred)
            loss = loss_fn(yb, pred)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        grads = {n: torch.zeros_like(t) if g is None else g
                 for (n, t), g in zip(params.items(), grads)}
        with torch.no_grad():
            if fused_apply is not None:
                params, opt_state = fused_apply(grads, opt_state, params)
            else:
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                for name, t in params.items():
                    t.add_(updates[name])
        return params, opt_state, loss.detach()

    return one_step


def _resolve_fused(model, optimizer, fused_optimizer: Optional[bool],
                   lazy_specs=None):
    """The optimizer a fit steps with: the fused twin when asked for and
    one exists (JAX L1343-1369, minus the availability probe). Without a
    twin, a fit with lazy tables still takes the segment kernels for the
    tables (`_pick_one_step`); the rest keeps the plain optimizer."""
    if not fused_optimizer:
        return optimizer
    spec = getattr(model, "_optimizer_spec", None)
    twin = as_fused(optimizer, spec)
    if twin is not None:
        return twin
    if lazy_specs:
        log.warning("fused_optimizer: compiled optimizer %r has no exact "
                    "fused twin; embedding tables take the fused segment "
                    "path, the rest stays on the plain optimizer", spec)
    else:
        log.warning("fused_optimizer requested but the compiled optimizer "
                    "(%r) has no exact fused twin (only default-"
                    "hyperparameter adam/adamw specs map); keeping the "
                    "plain path", spec)
    return optimizer


def _pick_one_step(model, loss_fn, optimizer, mixed_precision: bool,
                   lazy_specs, fused: bool) -> Callable:
    if lazy_specs:
        if fused:
            from analytics_zoo_tpu_torch.kernels.segment_update import \
                make_fused_one_step
            return make_fused_one_step(model, loss_fn, optimizer, lazy_specs,
                                       mixed_precision)
        from analytics_zoo_tpu_torch.learn.lazy_embedding import \
            make_lazy_one_step
        return make_lazy_one_step(model, loss_fn, optimizer, lazy_specs,
                                  mixed_precision)
    return build_train_step(model, loss_fn, optimizer, mixed_precision)


def fit_keras(model, x, y=None, batch_size: int = 32, epochs: int = 1,
              validation_data=None, distributed: bool = True,
              shuffle: bool = True, checkpoint_trigger=None,
              end_trigger=None, seed: int = 0,
              batch_iter_factory: Optional[Callable] = None,
              steps_per_run: int = 1, mixed_precision: bool = False,
              prefetch: bool = True,
              prefetch_depth: Optional[int] = None,
              lazy_embeddings: bool = False,
              device_cache: Optional[bool] = None,
              flat_optimizer: bool = False,
              fused_optimizer: Optional[bool] = None,
              sharding_rules=None,
              flops_per_step: Optional[float] = None,
              metrics_report_s: Optional[float] = None,
              compile_cache_dir: Optional[str] = None,
              auto_resume: bool = False,
              int8_sidecar: bool = False,
              step_retries: int = 0,
              step_timeout_s: Optional[float] = None,
              profile_steps: Optional[Tuple[int, int]] = None,
              profile_dir: Optional[str] = None
              ) -> Dict[str, List[float]]:
    """`KerasNet.fit` backend: trains `model` in place on the device its
    parameters live on; returns `{"loss": [mean per epoch]}`.

    `distributed` is accepted (one device: nothing to distribute);
    `prefetch` is accepted and batches are copied to the device in the
    step loop; `device_cache` may be None or False (host batches, the JAX
    package's shuffle). `fused_optimizer=None` means False (the port has
    no config file or environment switch)."""
    given = dict(validation_data=validation_data,
                 checkpoint_trigger=checkpoint_trigger,
                 end_trigger=end_trigger,
                 batch_iter_factory=batch_iter_factory,
                 prefetch_depth=prefetch_depth,
                 sharding_rules=sharding_rules,
                 flops_per_step=flops_per_step,
                 metrics_report_s=metrics_report_s,
                 compile_cache_dir=compile_cache_dir,
                 auto_resume=auto_resume, int8_sidecar=int8_sidecar,
                 step_retries=step_retries, step_timeout_s=step_timeout_s,
                 profile_steps=profile_steps, profile_dir=profile_dir)
    for name, default in _NOT_PORTED_ARGS.items():
        value = given[name]
        if (value is not None) if default is None else (value != default):
            raise NotImplementedError(
                f"fit_keras({name}=...) is not ported yet "
                f"({NOT_PORTED_QUEUE})")
    if device_cache:
        raise NotImplementedError(
            f"fit_keras(device_cache=True) is not ported yet "
            f"({NOT_PORTED_QUEUE})")
    if flat_optimizer:
        raise ValueError("flat_optimizer was retired in the JAX package; "
                         "use fused_optimizer=True")
    if steps_per_run < 1:
        raise ValueError(f"steps_per_run must be >=1, got {steps_per_run}")
    n = _tree_len(x)
    if n < batch_size:
        raise ValueError(
            f"Dataset has {n} samples but the batch is {batch_size}; "
            "training batches are whole-batch only. Lower batch_size or "
            "add data.")
    if not model.built:
        model.ensure_built(x, seed=seed)
    if model.optimizer is None:
        raise RuntimeError("Model must be compiled before fit")
    lazy_specs = None
    if lazy_embeddings:
        from analytics_zoo_tpu_torch.learn.lazy_embedding import resolve_specs
        lazy_specs = resolve_specs(model)
    optimizer = _resolve_fused(model, model.optimizer, fused_optimizer,
                               lazy_specs)
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    if lazy_specs:
        from analytics_zoo_tpu_torch.learn.lazy_embedding import init_state
        opt_state = init_state(params, lazy_specs, optimizer)
    else:
        opt_state = optimizer.init(params)
    one_step = _pick_one_step(model, model.loss, optimizer, mixed_precision,
                              lazy_specs, bool(fused_optimizer))
    gen = torch.Generator().manual_seed(seed)

    history: Dict[str, List[float]] = {"loss": []}
    for epoch in range(epochs):
        losses = []   # device scalars; read once at the end of the epoch
        for xb, yb, _ in iter_batches(x, y, batch_size, shuffle=shuffle,
                                      seed=seed + epoch):
            step_seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
            params, opt_state, loss = one_step(
                params, opt_state, _to_device(xb, device),
                _to_device(yb, device) if yb is not None else None,
                step_seed)
            losses.append(loss)
        step_losses = torch.stack(losses).cpu().numpy()
        mean_loss = float(step_losses.mean())
        history["loss"].append(mean_loss)
        log.info("Epoch %d/%d  loss=%.4f", epoch + 1, epochs, mean_loss)
    return history


# ---------------------------------------------------------------------------
# evaluate / predict
# ---------------------------------------------------------------------------
def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def build_eval_step(model, metrics) -> Callable:
    """`eval_step(states, xb, yb, real) -> states`: one forward and every
    metric's update on the first `real` rows, without an autograd
    graph."""
    def eval_step(states, xb, yb, real: int):
        with torch.inference_mode():
            pred = tree_map(lambda a: a[:real], model(xb, training=False))
            return [m.update(s, yb, pred) for m, s in zip(metrics, states)]

    return eval_step


def _forward_numpy(model, xb) -> Any:
    with torch.inference_mode():
        pred = model(xb, training=False)
    return tree_map(lambda a: a.float().cpu().numpy() if a.dtype in (
        torch.bfloat16, torch.float16) else a.cpu().numpy(), pred)


def evaluate_keras(model, x, y=None, batch_per_thread: int = 32,
                   metrics=None) -> Dict[str, float]:
    """The compiled metrics (or the compiled loss, when there are none)
    over `(x, y)`, on the device the parameters live on. Whole batches
    first; then the tail, padded to a whole batch and sliced to its real
    rows before the metrics see it."""
    model.ensure_built(x)
    ms = metrics if metrics is not None else model.metrics
    if not ms:
        from analytics_zoo_tpu_torch.ops.metrics import Loss
        ms = [Loss(model.loss)] if model.loss else []
    if not ms:
        raise ValueError("No metrics to evaluate; compile with metrics=[...]")
    device = _model_device(model)
    batch = batch_per_thread
    eval_step = build_eval_step(model, ms)
    states = [m.init() for m in ms]
    for xb, yb, real in iter_batches(x, y, batch, drop_remainder=False,
                                     pad_to_batch=False):
        states = eval_step(states, _to_device(xb, device),
                           _to_device(yb, device) if yb is not None
                           else None, real)
    n = _tree_len(x)
    tail = n % batch
    if tail:
        sel = np.concatenate([np.arange(n - tail, n),
                              np.repeat([n - 1], batch - tail)])
        yb = _to_device(_tree_take(y, sel[:tail]), device) \
            if y is not None else None
        states = eval_step(states, _to_device(_tree_take(x, sel), device),
                           yb, tail)
    return {m.name: float(m.compute(s)) for m, s in zip(ms, states)}


def predict_keras(model, x, batch_per_thread: int = 32):
    """The model's outputs on `x` as numpy arrays (float32 for a bf16
    model), in batches of `batch_per_thread`, the last padded to a whole
    batch and sliced to its real rows."""
    model.ensure_built(x)
    device = _model_device(model)
    outs: List[Any] = []
    for xb, _, real in iter_batches(x, None, batch_per_thread,
                                    drop_remainder=False, pad_to_batch=True):
        pred = _forward_numpy(model, _to_device(xb, device))
        outs.append(tree_map(lambda a: a[:real], pred))
    if isinstance(outs[0], (list, tuple)):
        return type(outs[0])(np.concatenate([o[i] for o in outs])
                             for i in range(len(outs[0])))
    return np.concatenate(outs)
