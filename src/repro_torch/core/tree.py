"""Pytrees of tensors in the reference's order (the part of
``jax.tree_util`` the port uses: the gradient telemetry's leaf order, the
training path's maps and checkpoint paths).

A tree is a dict (its entries in sorted key order, as jax flattens
them), a list, a tuple or a ``NamedTuple`` (in order), or a leaf; None
holds no leaf.  ``tree_paths`` names each leaf as
``jax.tree_util.keystr`` does (``['params']['blocks'][0]['attn']['wq']``,
``['opt'].step``), so a checkpoint's manifest is the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _children(t) -> List[Tuple[str, Any]]:
    """(path step, child) pairs in flattening order; [] for a leaf."""
    if isinstance(t, dict):
        return [(f"[{k!r}]", t[k]) for k in sorted(t)]
    if _is_namedtuple(t):
        return [(f".{f}", getattr(t, f)) for f in t._fields]
    if isinstance(t, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(t)]
    return []


def _is_node(t) -> bool:
    return isinstance(t, (dict, list, tuple))


def tree_paths(tree, is_leaf: Optional[Callable] = None
               ) -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` for every leaf, in the reference's order."""
    if tree is None:
        return []
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return [("", tree)]
    return [(step + path, leaf) for step, child in _children(tree)
            for path, leaf in tree_paths(child, is_leaf)]


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    return [leaf for _, leaf in tree_paths(tree, is_leaf)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` of each leaf of ``tree`` and the leaves at the same places of
    ``rest``, in ``tree``'s structure."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    kids = [tree_map(fn, c, *(r[i] for r in rest))
            for i, c in enumerate(tree)]
    return type(tree)(*kids) if _is_namedtuple(tree) else type(tree)(kids)


def tree_unflatten(like, leaves: list, is_leaf: Optional[Callable] = None):
    """``like``'s structure with ``leaves`` (in ``tree_leaves`` order) in
    place of its leaves."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if (is_leaf is not None and is_leaf(t)) or not _is_node(t):
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        kids = [build(c) for c in t]
        return type(t)(*kids) if _is_namedtuple(t) else type(t)(kids)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out
