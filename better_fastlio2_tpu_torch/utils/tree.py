"""Selects over the port's state tuples (nested tuples and NamedTuples of
tensors), the counterpart of jax.tree_util.tree_map for the few places
that need it: the ESIKF passes and gates (utils.device.cond), the
padded-scan select of the window step and the state copies of a captured
CUDA graph.

A leaf that is not a tensor (a static flag such as MeasureAux.searched,
or None for an absent map table) is the same in both trees and passes
through.
"""

from __future__ import annotations

import torch

__all__ = ["tree_where", "tree_tensors", "tree_clone", "tree_copy_"]


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


def tree_clone(a):
    """A copy of the tree with every tensor leaf cloned."""
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple):
        return _rebuild(a, (tree_clone(x) for x in a))
    return a


def tree_copy_(dst, src) -> None:
    """copy_ every tensor leaf of `src` into the same leaf of `dst` (a leaf
    that already is its destination is left alone); the other leaves are
    static and must agree."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape:
            raise ValueError(f"tree_copy_: {type(src).__name__} "
                             f"{getattr(src, 'shape', '')} for a "
                             f"{tuple(dst.shape)} leaf")
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, x in zip(dst, src, strict=True):
            tree_copy_(d, x)
    elif dst is not src and dst != src:
        raise ValueError(f"tree_copy_: a static leaf differs ({dst!r} / "
                         f"{src!r})")
