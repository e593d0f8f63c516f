"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

A tree is a dict whose values are dicts or leaves. Leaves are addressed
by the same path strings ``jax.tree_util.keystr`` gives a dict pytree —
``['params']['dense']['w0']`` — and visited in sorted key order, as JAX
flattens dicts, so checkpoints written by either package name their
arrays alike.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def map_leaves(fn: Callable, tree):
    """Same structure, ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def map_with_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """Same structure, ``fn(path, leaf)`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    return fn(prefix, tree)
