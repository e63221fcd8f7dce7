"""Nested param trees of the port: dicts (keys in sorted order, as
``jax.tree_util`` flattens them), lists and tuples of tensors or arrays.

``tree_map`` maps one function over the leaves of trees of the same
structure; ``flatten`` names every leaf by its path, the keys (list
positions as their index) joined with ``/``: the reference's checkpoint
key rule (``repro/train/checkpoint.py::_flatten``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

__all__ = ["tree_map", "tree_leaves", "flatten", "unflatten_like"]


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def flatten(tree) -> Dict[str, Any]:
    """{path: leaf} in flattening order."""
    out: Dict[str, Any] = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + [str(k)])
        elif isinstance(t, (list, tuple)):
            for i, s in enumerate(t):
                walk(s, path + [str(i)])
        else:
            out["/".join(path)] = t
    walk(tree, [])
    return out


def unflatten_like(like, leaves: List[Any]):
    """``like``'s structure with ``leaves`` (in flattening order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
