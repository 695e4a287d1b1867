"""Nested dicts, tuples and lists of tensors (the port's parameter,
optimizer-state and batch trees), walked as JAX walks a pytree: a dict's
keys in sorted order, a tuple's or list's entries in order, anything else
a leaf.  So a leaf's path name here is the reference's, and leaves come
in the reference's order (``jax.tree_util.tree_flatten_with_path``).
"""
from __future__ import annotations

from typing import Callable


def _is_node(x) -> bool:
    return isinstance(x, (dict, tuple, list))


def _children(x):
    if isinstance(x, dict):
        return [(k, x[k]) for k in sorted(x)]
    return list(enumerate(x))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), in the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unzip(tree, n: int) -> tuple:
    """``n`` trees from a dict tree whose leaves are ``n``-tuples (what a
    :func:`tree_map` of a function returning a tuple gives)."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tuple(tree)


def flatten_with_paths(tree, prefix: str = "") -> tuple[list, list]:
    """(names, leaves) in JAX's order; a name joins the path's keys and
    indices with ``/``."""
    if not _is_node(tree):
        return [prefix], [tree]
    names, leaves = [], []
    for k, v in _children(tree):
        n, l = flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
        names += n
        leaves += l
    return names, leaves


def tree_leaves(tree) -> list:
    return flatten_with_paths(tree)[1]


def unflatten_like(like, leaves: list):
    """A tree of ``like``'s structure holding ``leaves`` in JAX's order."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            out = {k: build(x[k]) for k in sorted(x)}
            return {k: out[k] for k in x}
        if isinstance(x, (tuple, list)):
            return type(x)(build(v) for v in x)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out

