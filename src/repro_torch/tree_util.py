"""Pytree flatten and unflatten with ``jax.tree_util``'s leaf order, for the
nested dicts, tuples and lists the port ships (a KV cache, a parameter tree).

Dict keys are visited in sorted order and sequences in order; ``None`` is an
empty subtree; everything else is a leaf.  The structure (``treedef``) is a
hashable nested tuple, so it can key a plan cache.
"""
from __future__ import annotations

import torch


# The walkers are module functions that take what they fill: a nested
# function that calls itself is a reference cycle with its closure, which
# would keep every leaf it saw alive until the cyclic collector runs.

def _flatten(t, leaves: list) -> tuple:
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys, tuple(_flatten(t[k], leaves) for k in keys))
    if isinstance(t, (tuple, list)):
        return (type(t).__name__, None, tuple(_flatten(x, leaves) for x in t))
    if t is None:
        return ("none", None, ())
    leaves.append(t)
    return ("leaf", None, ())


def tree_flatten(tree) -> tuple:
    """``(leaves, treedef)`` of ``tree``."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _build(d, it):
    kind, keys, subs = d
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    kids = [_build(s, it) for s in subs]
    if kind == "dict":
        return dict(zip(keys, kids))
    return tuple(kids) if kind == "tuple" else kids


def tree_unflatten(treedef: tuple, leaves) -> object:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def _up_to(d, t, out: list) -> None:
    kind, keys, subs = d
    if kind == "leaf":
        out.append(t)
    elif kind == "dict":
        if not isinstance(t, dict) or tuple(sorted(t)) != keys:
            raise ValueError(f"tree does not match the structure: {t!r:.80}")
        for k, s in zip(keys, subs):
            _up_to(s, t[k], out)
    elif kind != "none":
        if not isinstance(t, (tuple, list)) or len(t) != len(subs):
            raise ValueError(f"tree does not match the structure: {t!r:.80}")
        for s, x in zip(subs, t):
            _up_to(s, x, out)


def tree_flatten_up_to(treedef: tuple, tree) -> list:
    """The subtrees of ``tree`` at the leaves of ``treedef`` (a prefix of
    ``tree``'s structure), in leaf order: ``jax`` treedefs'
    ``flatten_up_to``."""
    out: list = []
    _up_to(treedef, tree, out)
    return out


def bits_equal(a, b) -> bool:
    """Two trees of tensors hold the same leaves bit for bit."""
    la, lb = tree_leaves(a), tree_leaves(b)
    bytes_of = lambda t: t.detach().reshape(-1).view(torch.uint8)  # noqa: E731
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(bytes_of(x), bytes_of(y))
        for x, y in zip(la, lb))


def tree_map_up_to(fn, tree, *others):
    """``tree`` with every leaf replaced by ``fn(leaf, *subs)``, ``subs`` the
    subtrees of ``others`` at that leaf (``tree``'s structure a prefix of
    theirs): a map over spec trees, whose leaves are tuples."""
    leaves, treedef = tree_flatten(tree)
    cols = [tree_flatten_up_to(treedef, o) for o in others]
    return tree_unflatten(treedef, [fn(*a) for a in zip(leaves, *cols)])
