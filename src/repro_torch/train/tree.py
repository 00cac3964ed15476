"""Pytrees of tensors walked in ``jax.tree_util``'s order: dict keys
sorted, tuple and list entries by position.  A node is a dict, tuple or
list; anything else is a leaf.  The flattened paths are the strings
``"/".join(str(k) for k in path)`` that ``tree_flatten_with_path`` gives
(``['key']`` for a dict entry, ``[i]`` for a sequence entry), which the
checkpoint manifest stores."""
from __future__ import annotations

from typing import Any, Callable


_END = object()


def _children(node) -> list[tuple[str, Any]] | None:
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    return None


def flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in flattened order."""
    kids = _children(tree)
    if kids is None:
        return [("", tree)]
    out = []
    for key, child in kids:
        out.extend((key if not p else f"{key}/{p}", leaf)
                   for p, leaf in flatten_with_paths(child))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, flat: list):
    """``like``'s structure with its leaves replaced, in order, by ``flat``."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), as ``jax.tree.map``."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
