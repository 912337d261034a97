"""Structural copies of a module whose tensors are chosen one by one.

Serving needs copies of a model that share its structure but not its
tensors: one per replica (each on its own device or stream), one per hot
swap (new weights, same layout), and the int8 rewrite (some parameters
replaced by buffers). `copy.deepcopy` with a memo that maps every
parameter and buffer to its replacement builds such a copy without copying
the old weights first.
"""

from __future__ import annotations

import contextlib
import copy
import sys
from typing import Callable, Optional

import torch
from torch import nn


@contextlib.contextmanager
def _deep_recursion(limit: int = 20000):
    """Room for `deepcopy` of a deep functional model: the node graph
    recurses once a node (a ResNet-50's passes Python's default limit)."""
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, limit))
    try:
        yield
    finally:
        sys.setrecursionlimit(old)


def owner_of(module: nn.Module, key: str):
    """`(submodule, leaf name)` of a state-dict key."""
    *path, leaf = key.split(".")
    owner = module
    for part in path:
        owner = getattr(owner, part)
    return owner, leaf


def copy_module(module: nn.Module,
                tensor_for: Callable[[str, torch.Tensor],
                                     Optional[torch.Tensor]]) -> nn.Module:
    """A deep copy of `module` in which each state-dict tensor `t` under
    `key` is `tensor_for(key, t)` (a Parameter stays a Parameter, with its
    `requires_grad`), or is removed when that returns None. Everything else
    is deep-copied as usual."""
    memo = {}
    # what a fit keeps on the model (its captured programs, its
    # device-resident data) belongs to that module: the copy starts
    # without it
    for name in ("_train_cache", "_device_data"):
        held = module.__dict__.get(name)
        if held is not None:
            memo[id(held)] = None
    dropped = []
    for key, t in module.state_dict(keep_vars=True).items():
        new = tensor_for(key, t)
        if new is None:
            dropped.append(key)
        elif isinstance(t, nn.Parameter) and not isinstance(new,
                                                             nn.Parameter):
            new = nn.Parameter(new, requires_grad=t.requires_grad)
        memo[id(t)] = new
    with _deep_recursion():
        out = copy.deepcopy(module, memo)
    for key in dropped:
        owner, leaf = owner_of(out, key)
        delattr(owner, leaf)
    return out
