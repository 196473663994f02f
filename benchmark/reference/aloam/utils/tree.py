"""Trees of tensors: tuples and named tuples (a state, a step's outputs,
a cloud) whose leaves are tensors or other values (an int, None)."""

from __future__ import annotations

import torch


def tensors(tree) -> list:
    """The tensor leaves of ``tree``, depth first (other leaves left
    out)."""
    if isinstance(tree, tuple):
        return [x for sub in tree for x in tensors(sub)]
    return [tree] if torch.is_tensor(tree) else []


def rebuild(tree, leaves):
    """``tree`` with its tensor leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(tree, tuple):
        subs = [rebuild(sub, leaves) for sub in tree]
        return type(tree)(*subs) if hasattr(tree, "_fields") \
            else type(tree)(subs)
    return next(leaves) if torch.is_tensor(tree) else tree


def map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to every tensor leaf."""
    return rebuild(tree, iter([fn(t) for t in tensors(tree)]))
