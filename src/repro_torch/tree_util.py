"""Trees of tensors with paths, as ``jax.tree_util`` walks pytrees.

A tree is nested dicts, lists, tuples and NamedTuples; ``None`` is an empty
subtree (no leaf); anything else is a leaf.  Dicts are walked in sorted key
order, as JAX walks them.  A path is a tuple of keys of the same three kinds
as JAX's, with the same attributes and the same ``str``: ``DictKey`` (``key``,
``['a']``), ``GetAttrKey`` for a NamedTuple field (``name``, ``.a``) and
``SequenceKey`` (``idx``, ``[0]``), so a rule that names a leaf from its path
reads the same in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple


class DictKey(NamedTuple):
    key: Any

    def __str__(self) -> str:
        return f"[{self.key!r}]"


class GetAttrKey(NamedTuple):
    name: str

    def __str__(self) -> str:
        return f".{self.name}"


class SequenceKey(NamedTuple):
    idx: int

    def __str__(self) -> str:
        return f"[{self.idx}]"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> list | None:
    """``[(key, child), ...]`` of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(DictKey(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(GetAttrKey(f), getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(SequenceKey(i), c) for i, c in enumerate(node)]
    return None


def leaves_with_path(tree) -> list:
    """``[(path, leaf), ...]`` in JAX's flattening order."""
    out = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for key, child in kids:
            walk(child, path + (key,))

    walk(tree, ())
    return out


def map_with_path(fn: Callable, tree):
    """``tree`` with each leaf replaced by ``fn(path, leaf)`` (dicts rebuilt in
    sorted key order, ``None`` kept)."""

    def walk(node, path):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return fn(path, node)
        new = [walk(child, path + (key,)) for key, child in kids]
        if isinstance(node, dict):
            return {k.key: v for (k, _), v in zip(kids, new)}
        if _is_namedtuple(node):
            return type(node)(*new)
        return type(node)(new)

    return walk(tree, ())
