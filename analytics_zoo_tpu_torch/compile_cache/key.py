"""Cache-key anatomy: content fingerprints for captured programs.

Copied from `analytics_zoo_tpu/compile_cache/key.py` (L1-269):
`FORMAT_VERSION`, `fingerprint` (L45), `structure_signature` (L130),
`model_fingerprint` (L186), `abstract_signature` (L193),
`cheap_signature` (L205), `CacheKey` (L222) and `make_key` (L235), with
the same fields and digest rules. What differs in the port:

- the key carries torch's version, the CUDA runtime version PyTorch was
  built with, the card's name (`torch.cuda.get_device_name`) and its
  compute capability, in place of the jax/jaxlib versions and the
  backend platform, device kind and device count: a kernel library built
  for sm_90a by one toolkit must never load on another card or under
  another runtime;
- a leaf is a numpy array or a torch tensor; a tensor's dtype is spelled
  as numpy spells it ("float32", "bfloat16", "int8"), so a numpy batch
  and the tensor uploaded from it sign alike, and both as the JAX
  functions sign the numpy batch;
- trees are flattened in jax's order (dict keys sorted), which is not the
  port's `common.tree.tree_leaves` (insertion order);
- a training program's `sharding` field is its fit's layout
  (`parallel/sharding.sharding_descriptor`: the mesh's axis sizes, its
  rank count and the rule table's `fingerprint()`: an empty table
  without the FSDP fallback for a fit over a process group without
  rules; empty for a fit without a process group),
  so a sharded program and a replicated one never share a capture
  record.

An entry is reusable exactly when re-capturing would produce the same
program, and MUST miss when anything that feeds the capture changed. A
false MISS only costs a kernel build and a capture record.
"""

from __future__ import annotations

import hashlib
import json
import types
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

# the JAX package's entry format, kept: the header layout and the key
# discipline are the same, only the payload (a capture record or a kernel
# library, never an executable) and the platform fields differ
FORMAT_VERSION = 2

_MAX_DEPTH = 5
_MAX_ITEMS = 64


def _h(parts) -> str:
    return hashlib.sha256("\x1f".join(parts).encode()).hexdigest()[:16]


def dtype_name(dtype) -> str:
    """numpy's spelling of a numpy or torch dtype: torch.float32 →
    "float32", torch.bfloat16 → "bfloat16"."""
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


def fingerprint(obj: Any, depth: int = 0) -> str:
    """Stable-across-processes content fingerprint of a python object:
    functions hash by bytecode + consts + closure cells; arrays by
    shape/dtype (values are runtime inputs); layer-bearing objects by a
    structural walk of their scalar attributes. Bounded depth/width so a
    pathological object can't stall key construction."""
    if depth > _MAX_DEPTH:
        return "deep"
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return repr(obj)
    # modules and classes identify by NAME, never by attribute walk: a
    # function closing over `import torch` would otherwise deep-walk the
    # whole package namespace
    if isinstance(obj, types.ModuleType):
        return _h(["module", obj.__name__,
                   str(getattr(obj, "__version__", ""))])
    if isinstance(obj, type):
        return _h(["type", obj.__module__, obj.__qualname__])
    # bound methods: underlying function + owner structure
    owner = getattr(obj, "__self__", None)
    func = getattr(obj, "__func__", None)
    if owner is not None and func is not None:
        return _h(["method", fingerprint(func, depth + 1),
                   fingerprint(owner, depth + 1)])
    code = getattr(obj, "__code__", None)
    if code is not None:
        parts = ["fn", getattr(obj, "__qualname__", "?"),
                 hashlib.sha256(code.co_code).hexdigest()[:16],
                 repr(code.co_names)]
        for c in code.co_consts[:_MAX_ITEMS]:
            parts.append(fingerprint(c, depth + 1))
        for cell in (obj.__closure__ or ())[:_MAX_ITEMS]:
            try:
                parts.append(fingerprint(cell.cell_contents, depth + 1))
            except ValueError:      # empty cell
                parts.append("empty")
        return _h(parts)
    shape = getattr(obj, "shape", None)
    dtype = getattr(obj, "dtype", None)
    if shape is not None and dtype is not None:
        return f"arr{tuple(shape)}:{dtype_name(dtype)}"
    if isinstance(obj, (list, tuple)):
        return _h([type(obj).__name__]
                  + [fingerprint(v, depth + 1) for v in obj[:_MAX_ITEMS]])
    if isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: str(kv[0]))[:_MAX_ITEMS]
        return _h(["dict"] + [f"{k}={fingerprint(v, depth + 1)}"
                              for k, v in items])
    layers = getattr(obj, "layers", None)
    if isinstance(layers, (list, tuple)):
        return _h([type(obj).__name__]
                  + [fingerprint(l, depth + 1) for l in layers[:_MAX_ITEMS]])
    # generic object: type + scalar attrs (hyperparameters like strides
    # and units live here) + CALLABLE attrs (two models differing only in
    # relu-vs-tanh must never share a key). Auto-generated `name` attrs
    # ("dense_3") are EXCLUDED: the numbering counter is process-global.
    try:
        items = sorted(vars(obj).items())
    except TypeError:
        items = []
    parts = [type(obj).__name__]
    n = 0
    for k, v in items:
        if k == "name" or n >= _MAX_ITEMS:
            continue
        if isinstance(v, (bool, int, float, str, tuple)):
            parts.append(f"{k}={v!r}")
            n += 1
        elif callable(v):
            parts.append(f"{k}={fingerprint(v, depth + 1)}")
            n += 1
    return _h(parts)


_AUTONUM_RE = None


def structure_signature(tree: Any) -> str:
    """Canonical structure string of a tree: container shapes, dict keys,
    and per-leaf shape/dtype — with auto-numbered layer keys ("dense_3")
    rewritten to build-order ordinals ("dense#0"), since the layer-naming
    counter is process-global. Ordinals are assigned in dict-insertion
    (build) order, children emitted in sorted-raw-key order (jax's
    flatten order), so a counter offset that reorders the sorted sequence
    gives a different signature: a safe miss."""
    global _AUTONUM_RE
    if _AUTONUM_RE is None:
        import re
        _AUTONUM_RE = re.compile(r"^(.+?)_(\d+)$")
    counters: Dict[str, int] = {}

    def canon(k) -> str:
        m = _AUTONUM_RE.match(str(k))
        base = m.group(1) if m else str(k)
        i = counters.get(base, 0)
        counters[base] = i + 1
        return f"{base}#{i}"

    def walk(t) -> str:
        if isinstance(t, dict):
            labels = {k: canon(k) for k in t}
            return "{" + ",".join(f"{labels[k]}:{walk(t[k])}"
                                  for k in sorted(t, key=str)) + "}"
        if isinstance(t, (list, tuple)):
            return (type(t).__name__ + "["
                    + ",".join(walk(v) for v in t) + "]")
        if t is None:
            return "~"
        shape = getattr(t, "shape", None)
        dtype = getattr(t, "dtype", None)
        if shape is not None:
            return f"{tuple(shape)}:{dtype_name(dtype)}"
        return type(t).__name__

    return walk(tree)


def _state(params: Any) -> Any:
    """A module's state dict as the nested tree its dotted keys spell
    ("dense_3.kernel" → {"dense_3": {"kernel": ...}}), the shape of the
    JAX package's params tree, so auto-numbered layer names canonicalize
    as they do there; any other tree as it is."""
    state_dict = getattr(params, "state_dict", None)
    if not callable(state_dict):
        return params
    nested: Dict[str, Any] = {}
    for name, t in state_dict().items():
        *path, leaf = name.split(".")
        node = nested
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return nested


def model_fingerprint(fn: Any, params: Any) -> str:
    """Fingerprint of (forward fn, params STRUCTURE): what must match for
    a capture record to describe the right program. `params` may be an
    `nn.Module` (its state dict's structure, plus its class)."""
    state = _state(params)
    parts = [fingerprint(fn), structure_signature(state)]
    if state is not params:
        parts.append(fingerprint(type(params)))
    return _h(parts)


def _jax_leaves(tree: Any) -> List[Any]:
    """Leaves in jax's flatten order: dict keys sorted, None a subtree
    with no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree, key=str)
                for leaf in _jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _jax_leaves(t)]
    if tree is None:
        return []
    return [tree]


def _leaf_dtype(leaf) -> str:
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        import numpy as np
        return dtype_name(np.asarray(leaf).dtype)
    return dtype_name(dtype)


def abstract_signature(tree: Any) -> Tuple[str, Tuple]:
    """(canonical structure str, ((shape, dtype), ...)) of a tree of
    arrays or tensors — the per-call part of the key (and the in-process
    program-table key)."""
    return (structure_signature(tree),
            tuple((tuple(getattr(l, "shape", ())), _leaf_dtype(l))
                  for l in _jax_leaves(tree)))


def cheap_signature(tree: Any) -> Tuple:
    """Per-leaf (shape, dtype-name) tuple — the hot-path dispatch key.
    Discriminating only when the tree STRUCTURE is fixed per consumer; pay
    `abstract_signature` when structure can vary."""
    return tuple(
        (tuple(l.shape), dtype_name(l.dtype)) if hasattr(l, "shape")
        else (type(l).__name__,)
        for l in _jax_leaves(tree))


@dataclass
class CacheKey:
    """Canonical key: `fields` is the human-readable anatomy (stored in
    the entry header so `tool ls` can explain an entry); `digest` names
    the entry file."""

    fields: Dict[str, Any] = field(default_factory=dict)

    @property
    def digest(self) -> str:
        blob = json.dumps(self.fields, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:40]


def platform_fields(device=None) -> Dict[str, Any]:
    """torch's version, the CUDA runtime version and, for a CUDA device
    (`device`, default: the current one when there is a card), its name and
    compute capability. A CPU device keys as "cpu" with no capability."""
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(index)
        device_kind = torch.cuda.get_device_name(index)
        capability = f"{major}.{minor}"
    else:
        device_kind, capability = "cpu", ""
    return {"torch": torch.__version__, "cuda": torch.version.cuda or "",
            "device_kind": device_kind, "capability": capability}


def make_key(kind: str, model_fp: str, signature, placement: str = "none",
             sharding: str = "", extra: Any = None,
             dtype: str = "", device=None) -> CacheKey:
    """Build the full cache key. `kind` separates serving forwards
    ("serving"), decode programs and kernel libraries ("kernel");
    `signature` is `abstract_signature(...)` of the call args; `dtype`
    names a non-default serving precision ("bfloat16", "int8") so a
    precision change is a guaranteed miss — empty ("", the f32 default)
    adds NO field, as in the JAX package. `device` names the device whose
    platform fields the key carries."""
    fields = {"format": FORMAT_VERSION}
    fields.update(platform_fields(device))
    fields.update({
        "kind": kind,
        "model": model_fp,
        "signature": _sig_fields(signature),
        "placement": placement,
        "sharding": sharding,
    })
    if dtype:
        fields["dtype"] = dtype
    if extra is not None:
        fields["extra"] = fingerprint(extra)
    return CacheKey(fields)


def _sig_fields(signature):
    treedef, leaves = signature
    return {"tree": treedef,
            "leaves": [[list(shape), dtype] for shape, dtype in leaves]}
