"""Nested dicts, lists and tuples of arrays: the port's stand-in for the
`jax.tree_util` calls of the JAX package (parameter trees, multi-input
requests)."""

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
