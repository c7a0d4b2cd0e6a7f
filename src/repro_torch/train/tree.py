"""Nested containers of tensors ("trees"), flattened as JAX flattens pytrees.

A dict flattens in sorted key order, a tuple or list by index, a NamedTuple
by its fields, and ``None`` holds no leaf; anything else is a leaf. So the
port's optimizer states list their leaves in the JAX package's order, and
``leaf_paths`` names each leaf as ``repro.distributed.checkpoint`` does
(``params/layers/attn/wq``, ``opt/0/.mu/embed/embedding``, ``opt/2``: a
NamedTuple field shows as ``.name``), which the checkpoint format relies on.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["leaves", "leaf_paths", "leaves_up_to", "unflatten", "tree_map"]


def _children(node) -> Optional[Tuple[List[str], list]]:
    """(key names, children) of an inner node; None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return [str(k) for k in keys], [node[k] for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return ["." + f for f in node._fields], list(node)
    if isinstance(node, (tuple, list)):
        return [str(i) for i in range(len(node))], list(node)
    if node is None:
        return [], []
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        by_key = dict(zip(sorted(node), children))
        return {k: by_key[k] for k in node}  # the caller's key order
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, tuple):
        return tuple(children)
    if isinstance(node, list):
        return list(children)
    return None


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in flattening order; the path joins keys with '/'."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in zip(*kids):
        out += leaf_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaf_paths(tree)]


def leaves_up_to(like, tree) -> list:
    """The subtrees of ``tree`` at the leaf positions of ``like`` (JAX's
    ``flatten_up_to``): adafactor's column moments hold ``()`` where a
    parameter is not factored."""
    kids = _children(like)
    if kids is None:
        return [tree]
    tkids = _children(tree)
    if tkids is None or len(tkids[1]) != len(kids[1]):
        raise ValueError(f"tree structure mismatch: {type(tree).__name__} "
                         f"against {type(like).__name__}")
    out = []
    for a, b in zip(kids[1], tkids[1]):
        out += leaves_up_to(a, b)
    return out


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in order."""
    it = iter(new_leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(c) for c in kids[1]])

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest``."""
    others = [leaves_up_to(tree, r) for r in rest]
    return unflatten(tree, [fn(x, *ys) for x, *ys in
                            zip(leaves(tree), *others)])
