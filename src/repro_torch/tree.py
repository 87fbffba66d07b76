"""Trees of tensors: nested dicts, tuples, lists and NamedTuples.

The reference walks its parameter and optimizer trees with ``jax.tree``,
which visits a dict's entries in **sorted key order**, a tuple's or
list's in order and a NamedTuple's fields in order, treats ``None`` as an
empty subtree and any other object — a tensor, or a tuple subclass such
as a ``PartitionSpec`` — as a leaf.  The port's dicts keep insertion
order, so every walk that sums over leaves (the global gradient norm),
flattens them (checkpoints) or pairs them with gradients goes through
this module and visits the leaves in the reference's order.  Paths are
the reference checkpoint's: dict keys and sequence indices as written, a
NamedTuple field as ``.name`` (what ``jax.tree_util.GetAttrKey``
prints), joined by ``/``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    """(path part, child) of an inner node in the reference's order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if type(node) in (tuple, list):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def flatten_with_paths(tree) -> Tuple[List[str], List[Any]]:
    """The leaves of ``tree`` and their ``/``-joined paths, in the
    reference's order."""
    paths, leaves = [], []

    def walk(node, prefix):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            paths.append("/".join(prefix))
            leaves.append(node)
            return
        for part, child in kids:
            walk(child, prefix + [part])

    walk(tree, [])
    return paths, leaves


def leaves(tree) -> List[Any]:
    return flatten_with_paths(tree)[1]


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: None for k in node}          # keep insertion order
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if type(node) in (tuple, list):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure)."""
    cols = [leaves(tree)] + [leaves(t) for t in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
