"""Nested-dict trees in the JAX pytree's leaf order (keys sorted), the
port's stand-in for ``jax.tree`` over parameter, gradient and spec trees.
A leaf is anything that is not a dict; a None leaf is a frozen parameter's
missing gradient."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten", "unflatten", "tree_map"]


def flatten(tree, path=()) -> List[Tuple[tuple, Any]]:
    """(key path, leaf) pairs, keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], path + (k,))
        return out
    return [(path, tree)]


def unflatten(paths, values):
    """The nested dict with ``values[i]`` at ``paths[i]``."""
    out = {}
    for path, v in zip(paths, values):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over ``tree``'s structure; the
    other trees are read at the same key paths."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
