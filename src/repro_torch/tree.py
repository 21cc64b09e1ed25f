"""Nested dicts and lists of tensors, walked the way ``jax.tree`` walks a
pytree: dict keys in sorted order, list items in order.  The port keeps
parameters, gradients and optimiser state as such plain trees."""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves", "tree_unflatten", "tree_paths"]


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leafwise to ``tree`` and the trees of ``rest``, which
    share its structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    out = {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in kids}
    return out if isinstance(tree, dict) else type(tree)(out.values())


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Any, leaves: list) -> Any:
    """The structure of ``like`` filled with ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) pairs, each name the keys and indices of its path
    joined by ``_``, as ``repro.checkpoint`` names its files."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += tree_paths(v, f"{prefix}_{k}" if prefix else str(k))
    return out
