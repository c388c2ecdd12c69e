"""Nested-dict trees of tensors, walked in JAX's order.

``jax.tree_util`` flattens a dict in SORTED key order, whatever order
its keys were inserted in; the port's params are plain dicts built in
insertion order. Every walk that the reference's results depend on (the
order ``global_norm`` sums its leaves in, a checkpoint's key paths) goes
through these helpers, so it visits the leaves as the reference does.
A leaf is anything that is not a dict.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_items", "tree_leaves", "tree_map", "tree_from_items"]


def tree_items(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(key path, leaf)] in sorted key order, depth first."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [item for k in sorted(tree)
            for item in tree_items(tree[k], prefix + (k,))]


def tree_leaves(tree) -> list:
    """The leaves in sorted key order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), leaf by leaf in sorted key order; returns a tree of
    ``tree``'s structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def tree_from_items(items) -> dict:
    """The nested dict of ``[(key path, leaf)]`` (``tree_items``'s
    inverse)."""
    tree: dict = {}
    for path, leaf in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
