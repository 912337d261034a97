"""Sharding rules: parameter specs by tree path, and the fit's FSDP layout.

Port of `analytics_zoo_tpu/parallel/sharding.py` as pure logic, case for
case: `ShardingRules` (L36) with `spec_for` and its FSDP fallback
(L53-71) and `fingerprint` (L73), `_trim_spec`, `_fsdp_spec`,
`TRANSFORMER_RULES`, `param_specs`, `sharding_descriptor`,
`check_fsdp_divisibility` (L194) and `shard_batch` (L228). `P` stands in
for `jax.sharding.PartitionSpec` (a tuple of axis names, with its repr, so
`fingerprint` hashes the same text). A parameter's path is its JAX tree
path, made from the port's state-dict name as `convert.py` maps it
(`param_path`: "bert.blocks.3.attn.qkv_kernel" →
"bert/bert_block3/attn/qkv_kernel"); a spec names the dims of the port's
tensor (a convolution kernel is OIHW here, HWIO there).

What GSPMD does with a spec, the port does by hand (`ShardLayout`): a leaf
whose spec names `fsdp` (DTensor `Shard(dim)` on the mesh's fsdp
dimension, `placements`) keeps only this rank's block of that dim, the
others are replicated (`Replicate()`); the `data` axis replicates. The
fit gathers the blocks into whole parameters for its forward (one
all-gather a step), reduce-scatters the gradients back to blocks (and
all-reduces them over `data`), and steps the optimizer on the blocks
alone, so parameters and optimizer state take 1/fsdp of a rank's memory
between steps. The collectives go through the mesh (`common/mesh.py`),
which can stage them through the host; DTensor's own redistribution
calls the backend directly, which gloo cannot carry on CUDA tensors. A
spec that names `tensor` on a mesh whose tensor axis is larger than 1
raises NotImplementedError: tensor parallelism waits for ROADMAP item
7b, and so do the other axes.
"""

from __future__ import annotations

import hashlib
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.mesh import BATCH_AXES
from analytics_zoo_tpu_torch.common.tree import tree_map


class P(tuple):
    """`jax.sharding.PartitionSpec`: one mesh axis name (or a tuple of
    them, or None) per dim; trailing dims unnamed are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


class ShardingRules:
    """Ordered (path-regex, P) table; first match wins (`parallel/
    sharding.py:36`). The same table annotates an optimizer state: a
    moment is sharded as its parameter is."""

    def __init__(self, rules: Sequence[Tuple[str, P]],
                 fsdp_fallback: bool = True):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.fsdp_fallback = fsdp_fallback

    def spec_for(self, path: str, shape: Tuple[int, ...], mesh) -> P:
        for pat, spec in self.rules:
            if pat.search(path):
                trimmed = _trim_spec(spec, shape, mesh)
                if (len(spec) > 0
                        and not any(ax is not None for ax in trimmed)
                        and self.fsdp_fallback and mesh.size("fsdp") > 1):
                    # The rule WANTED this leaf sharded but none of its
                    # axes survived on this mesh (e.g. the embedding
                    # rule's 'tensor' axis on a pure data×fsdp mesh):
                    # fall through to ZeRO-style fsdp sharding rather
                    # than silently replicating a large table. An
                    # explicit P() rule (norm scales) stays replicated.
                    return _fsdp_spec(shape, mesh)
                return trimmed
        if self.fsdp_fallback and mesh.size("fsdp") > 1:
            return _fsdp_spec(shape, mesh)
        return P()

    def fingerprint(self) -> str:
        """Stable-across-processes content hash of the table — cache
        keys fold this in so two fits under different rule tables (or
        a replicated vs an fsdp fit) never share a capture record."""
        blob = ";".join(f"{pat.pattern}->{spec}" for pat, spec in self.rules)
        blob += f";fallback={self.fsdp_fallback}"
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _trim_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop axes the mesh doesn't have (size 1) or that don't divide the
    dim — even sharding is both faster and exact."""
    out: List[Optional[str]] = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        sizes = int(np.prod([mesh.size(a) for a in axes]))
        if sizes > 1 and shape[i] % sizes == 0:
            out.append(ax)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _fsdp_spec(shape: Tuple[int, ...], mesh) -> P:
    """Shard the largest dim divisible by the fsdp axis; else replicate."""
    n = mesh.size("fsdp")
    dims = sorted(range(len(shape)), key=lambda i: -shape[i])
    for d in dims:
        if shape[d] >= n and shape[d] % n == 0:
            spec: List[Optional[str]] = [None] * len(shape)
            spec[d] = "fsdp"
            return P(*spec)
    return P()


# Megatron-style transformer table (matches keras/transformer.py param names).
TRANSFORMER_RULES = ShardingRules([
    (r"qkv_kernel$", P("fsdp", "tensor")),      # column-parallel
    (r"qkv_bias$", P("tensor")),
    (r"out_kernel$", P("tensor", "fsdp")),      # row-parallel
    (r"out_bias$", P()),
    (r"ffn_in_kernel$", P("fsdp", "tensor")),   # column-parallel
    (r"ffn_in_bias$", P("tensor")),
    (r"ffn_out_kernel$", P("tensor", "fsdp")),  # row-parallel
    (r"ffn_out_bias$", P()),
    (r"(word|position|token_type)_embeddings$", P(None, "tensor")),
    (r"pooler_kernel$", P(None, "tensor")),
    (r"(ln\d?|_ln|layernorm|emb_ln)/", P()),    # norm scales: replicated
])


def param_path(name: str) -> str:
    """A port state-dict name → its JAX tree path ("." → "/", an encoder's
    `blocks.{i}` → `{encoder}_block{i}`, `convert.params_to_jax`)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1] == "blocks":
        parts = [parts[0], f"{parts[0]}_block{parts[2]}"] + parts[3:]
    return "/".join(parts)


def _tree_paths_and_leaves(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) of a nested dict; a flat dict of port names maps each
    name through `param_path`."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)) and not isinstance(node, P):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            out.append((param_path(prefix) if "." in prefix else prefix,
                        node))
    walk(tree, "")
    return out


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in (leaf.shape if isinstance(
        leaf, torch.Tensor) else np.shape(leaf)))


def param_specs(params, mesh, rules: ShardingRules = TRANSFORMER_RULES):
    """A tree of P matching `params` (a nested dict, or the port's flat
    state dict), per the rule table."""
    specs = iter([rules.spec_for(path, _shape(leaf), mesh)
                  for path, leaf in _tree_paths_and_leaves(params)])
    return tree_map(lambda _: next(specs), params)


def sharding_descriptor(mesh, rules: "ShardingRules" = None) -> str:
    """Canonical layout string for compile-cache keys: the mesh's axis
    extents, its rank count and the rule table's fingerprint — one
    spelling for every key, so what counts as "the layout" cannot drift."""
    rules = rules if rules is not None else TRANSFORMER_RULES
    return (repr(sorted(mesh.axis_sizes.items()))
            + f"|ranks={mesh.n_devices}|rules=" + rules.fingerprint())


def check_fsdp_divisibility(params, mesh,
                            rules: ShardingRules = TRANSFORMER_RULES,
                            min_size: int = 4096) -> None:
    """Validate that every LARGE parameter actually shards over the
    fsdp axis. The largest-dim fallback (`_fsdp_spec`) silently
    replicates a leaf none of whose dims divide `fsdp` — correct but
    defeating the 1/fsdp memory goal, so a big offender should fail
    loudly at config time, not OOM three layers later. Leaves smaller
    than `min_size` elements (biases, norm scales) legitimately
    replicate and are skipped."""
    n = mesh.size("fsdp")
    if n <= 1:
        return
    offenders: List[Tuple[str, Tuple[int, ...]]] = []
    for path, leaf in _tree_paths_and_leaves(params):
        shape = _shape(leaf)
        if not shape or int(np.prod(shape)) < max(min_size, n):
            continue
        spec = rules.spec_for(path, shape, mesh)
        if any(ax is not None for ax in spec):
            continue                      # sharded on some axis
        offenders.append((path, shape))
    if offenders:
        detail = ", ".join(f"{p} {s}" for p, s in offenders[:8])
        more = f" (+{len(offenders) - 8} more)" if len(offenders) > 8 else ""
        raise ValueError(
            f"{len(offenders)} large parameter(s) cannot shard over the "
            f"fsdp axis (size {n}) and would replicate on every device: "
            f"{detail}{more}. Fix by choosing an fsdp size that divides "
            "a dimension of each (e.g. a power of two matching the "
            "hidden size), padding the offending dimension, or adding "
            "an explicit ShardingRules entry for it.")


def _block(a, dim: int, n: int, i: int):
    size = a.shape[dim] // n
    index = [slice(None)] * a.ndim
    index[dim] = slice(i * size, (i + 1) * size)
    return a[tuple(index)]


def shard_batch(batch, mesh, sequence_dim: Optional[int] = None):
    """This rank's share of a global batch: the batch dim split over the
    data axes (data × fsdp), and optionally the sequence dim over the
    'sequence' axis (sequence parallelism for long-context inputs). The
    JAX function places the global batch on the mesh; a torch rank holds
    its own block, which this returns."""
    n_b, i_b = mesh.data_parallel_size, mesh.batch_index

    def take(a):
        if a.shape[0] % n_b:
            raise ValueError(f"batch {a.shape[0]} does not split over "
                             f"the data axes ({n_b})")
        a = _block(a, 0, n_b, i_b)
        if (sequence_dim is not None and mesh.size("sequence") > 1
                and a.ndim > sequence_dim
                and a.shape[sequence_dim] % mesh.size("sequence") == 0):
            a = _block(a, sequence_dim, mesh.size("sequence"),
                       mesh.coordinate("sequence"))
        return a
    return tree_map(take, batch)


def check_spec(spec: P, mesh, path: str = "") -> None:
    """The port shards over `fsdp` only: a spec that names a larger axis
    other than `fsdp` raises NotImplementedError (tensor parallelism is
    ROADMAP item 7b)."""
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None and a != "fsdp" and mesh.size(a) > 1:
                raise NotImplementedError(
                    f"{path or 'a parameter'}: spec {spec} shards over "
                    f"'{a}' (size {mesh.size(a)}); the port's fit shards "
                    "over fsdp only — tensor parallelism and the other "
                    "model axes wait for ROADMAP item 7b")


def fsdp_dim(spec: P) -> Optional[int]:
    """The dim a spec shards over `fsdp`, or None (replicated)."""
    for i, ax in enumerate(spec):
        if ax == "fsdp" or (isinstance(ax, tuple) and "fsdp" in ax):
            return i
    return None


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of a spec over `mesh.torch_mesh`'s dims:
    `Shard(dim)` where the spec names that mesh dim, else `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard
    dims = mesh.live_axes or ("data",)
    out = []
    for name in dims:
        d = next((i for i, ax in enumerate(spec)
                  if ax == name or (isinstance(ax, tuple) and name in ax)),
                 None)
        out.append(Shard(d) if d is not None else Replicate())
    return tuple(out)


class ShardLayout:
    """The fit's layout of a flat parameter dict over the mesh: each
    name's spec (`rules.spec_for` on its JAX path and the port's shape)
    and the dim it is split along the fsdp axis (None: replicated).

    `shard(tree)` takes this rank's blocks of a params-keyed tree (the
    parameters, or an optimizer state's moment dicts); `gather(tree)` puts
    whole tensors back (one all-gather for all of a dict's blocks);
    `reduce_grads` turns whole local gradients into the blocks' global
    mean gradients."""

    def __init__(self, params: Dict[str, torch.Tensor], mesh,
                 rules: ShardingRules):
        self.mesh = mesh
        self.n = mesh.size("fsdp")
        self.specs: Dict[str, P] = {}
        self.dims: Dict[str, Optional[int]] = {}
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        for name, t in params.items():
            spec = rules.spec_for(param_path(name), tuple(t.shape), mesh)
            check_spec(spec, mesh, param_path(name))
            self.specs[name] = spec
            self.dims[name] = fsdp_dim(spec) if self.n > 1 else None
            self.shapes[name] = tuple(t.shape)
        self.sharded = [n for n, d in self.dims.items() if d is not None]
        self.replicated = [n for n, d in self.dims.items() if d is None]

    def block_shape(self, name: str) -> Tuple[int, ...]:
        shape = list(self.shapes[name])
        d = self.dims[name]
        if d is not None:
            shape[d] //= self.n
        return tuple(shape)

    def _is_block(self, name, v) -> bool:
        return (name in self.dims and self.dims[name] is not None
                and isinstance(v, torch.Tensor)
                and tuple(v.shape) == self.shapes[name])

    def shard(self, tree):
        """This rank's blocks (contiguous copies) of every whole sharded
        tensor of `tree` keyed by a parameter name; other leaves as they
        are."""
        i = self.mesh.coordinate("fsdp")

        def walk(node):
            if isinstance(node, dict):
                return {k: _block(v, self.dims[k], self.n, i)
                        .contiguous().clone()
                        if self._is_block(k, v) else walk(v)
                        for k, v in node.items()}
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                return type(node)(*(walk(v) for v in node))
            if isinstance(node, (list, tuple)):
                return type(node)(walk(v) for v in node)
            return node
        return walk(tree)

    def gather_dict(self, blocks: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Whole tensors for a dict of this rank's blocks (sharded names)
        and whole tensors (the rest, passed through): one all-gather of
        the blocks packed flat."""
        names = [k for k in blocks if self.dims.get(k) is not None
                 and tuple(blocks[k].shape) == self.block_shape(k)]
        out = dict(blocks)
        if not names or self.n == 1:
            return out
        flat = torch.cat([blocks[k].reshape(-1) for k in names])
        full = self.mesh.all_gather(flat, "fsdp").view(self.n, -1)
        at = 0
        for k in names:
            shape, size = self.block_shape(k), blocks[k].numel()
            parts = [full[r, at:at + size].view(shape)
                     for r in range(self.n)]
            out[k] = torch.cat(parts, self.dims[k])
            at += size
        return out

    def gather(self, tree):
        """`tree` with every dict of blocks gathered (`gather_dict`)."""
        def walk(node):
            if isinstance(node, dict):
                if any(self.dims.get(k) is not None for k in node):
                    return self.gather_dict(node)
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                return type(node)(*(walk(v) for v in node))
            if isinstance(node, (list, tuple)):
                return type(node)(walk(v) for v in node)
            return node
        return walk(tree)

    def reduce_grads(self, grads: Dict[str, torch.Tensor],
                     loss: torch.Tensor):
        """(this rank's blocks' gradients and the replicated leaves'
        gradients, the global mean loss): each gradient summed over the
        batch axes and divided by their extent — the whole batch's mean
        gradient, as the JAX step takes it of the global batch. The
        replicated gradients and the loss go in one all-reduce over the
        batch axes; the sharded ones in one reduce-scatter over fsdp (and
        one all-reduce over data when it is larger than 1)."""
        mesh, n = self.mesh, self.n
        dp = float(mesh.data_parallel_size)
        out: Dict[str, torch.Tensor] = {}
        rep = [k for k in grads if self.dims.get(k) is None]
        flat = torch.cat([grads[k].reshape(-1).float() for k in rep]
                         + [loss.detach().reshape(1).float()])
        mesh.all_reduce(flat, BATCH_AXES)
        flat.div_(dp)
        at = 0
        for k in rep:
            size = grads[k].numel()
            out[k] = flat[at:at + size].view(grads[k].shape).to(
                grads[k].dtype)
            at += size
        mean_loss = flat[at]
        sh = [k for k in grads if self.dims.get(k) is not None]
        if sh:
            rows = [torch.cat([_block(grads[k], self.dims[k], n, r)
                               .reshape(-1).float() for k in sh])
                    for r in range(n)]
            red = mesh.reduce_scatter(torch.cat(rows), "fsdp")
            if mesh.size("data") > 1:
                mesh.all_reduce(red, ("data",))
            red.div_(dp)
            at = 0
            for k in sh:
                shape = self.block_shape(k)
                size = math.prod(shape)
                out[k] = red[at:at + size].view(shape).to(grads[k].dtype)
                at += size
        return {k: out[k] for k in grads}, mean_loss
