"""Nested dicts, lists and tuples of arrays: the port's stand-in for the
`jax.tree_util` calls of the JAX package (parameter trees, multi-input
requests). `tree_map` and `tree_leaves` take None as a leaf;
`tree_flatten` / `tree_unflatten` follow `jax.tree_util` exactly (dict
keys sorted, None a node without leaves), as the data layer's samples,
shards and batches need."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, *trees):
    """`fn` over matching leaves of trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


class TreeDef:
    """The structure `tree_flatten` read off a tree, to rebuild one from
    its leaves: `jax.tree_util`'s rules, which the data layer's samples
    and shards follow (dict keys sorted, None a node with no leaf)."""

    __slots__ = ("_node",)

    def __init__(self, node):
        self._node = node

    def unflatten(self, leaves):
        it = iter(leaves)

        def build(node):
            if node is _LEAF:
                return next(it)
            kind, meta, children = node
            if kind == "none":
                return None
            parts = [build(c) for c in children]
            if kind == "dict":
                return dict(zip(meta, parts))
            if kind == "namedtuple":
                return meta(*parts)
            return meta(parts)

        return build(self._node)


_LEAF = "*"


def tree_flatten(tree):
    """(leaves, TreeDef): dicts in sorted key order, lists and tuples in
    order, None holding no leaf, anything else one leaf."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return ("none", None, ())
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return ("namedtuple", type(t), tuple(walk(c) for c in t))
        if isinstance(t, (list, tuple)):
            return ("seq", type(t), tuple(walk(c) for c in t))
        leaves.append(t)
        return _LEAF

    return leaves, TreeDef(walk(tree))


def tree_unflatten(treedef: TreeDef, leaves):
    return treedef.unflatten(leaves)


def stack_trees(trees):
    """One tree whose leaves are `np.stack` of the matching leaves of
    `trees` (`jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)`)."""
    import numpy as np
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    return treedef.unflatten(
        [np.stack(parts) for parts in zip(*(f[0] for f in flat))])
