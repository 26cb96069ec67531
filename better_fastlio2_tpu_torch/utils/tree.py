"""Selects over the port's state tuples (nested tuples and NamedTuples of
tensors), the counterpart of jax.tree_util.tree_map for the few places
that need it: the predicated ESIKF passes, the padded-scan select of the
window step and the state write-back of a captured CUDA graph.

A leaf that is not a tensor (a static flag such as MeasureAux.searched,
or None for an absent map table) is the same in both trees and passes
through.
"""

from __future__ import annotations

import torch

__all__ = ["tree_where", "tree_tensors"]


def _rebuild(a: tuple, items):
    """A tuple of a's type (plain or NamedTuple) holding `items`."""
    items = list(items)
    return type(a)(*items) if hasattr(a, "_fields") else tuple(items)


def tree_where(cond: torch.Tensor, a, b):
    """torch.where(cond, a, b) leaf by leaf over two trees of one
    structure (a device select: no host read)."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    if isinstance(a, tuple):
        return _rebuild(a, (tree_where(cond, x, y) for x, y in zip(a, b)))
    return a


def tree_tensors(a) -> list[torch.Tensor]:
    """The tensor leaves of a tree, depth first in field order."""
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, tuple):
        return [t for x in a for t in tree_tensors(x)]
    return []
