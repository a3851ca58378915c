"""Flatten and unflatten the nested containers the port's verbs take.

The port's counterpart of the part of ``jax.tree`` that the JAX package's
in-axis verbs and recipes use: a tree is a dict, a list or a tuple (a
NamedTuple included) of trees, or a leaf (a tensor, or anything else).
Dict keys are flattened in sorted order, as ``jax.tree`` flattens them, so
that a tree's leaves come out in the JAX package's order and its fused
buckets take the JAX package's layout.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

# A flattened tree's structure, hashable (a plan key): ("leaf",), or
# (container type, dict keys or None, child structures).
TreeDef = Tuple


def _children(node) -> Tuple[Any, list]:
    """(keys or None, children) of a container node."""
    if isinstance(node, dict):
        keys = tuple(sorted(node))  # a tuple: a structure is hashable
        return keys, [node[k] for k in keys]
    return None, list(node)


def flatten(tree) -> Tuple[List, TreeDef]:
    """The leaves of ``tree`` in order, and its structure."""
    leaves: List = []

    def walk(node) -> TreeDef:
        if isinstance(node, (dict, list, tuple)):
            keys, kids = _children(node)
            return (type(node), keys, tuple(walk(k) for k in kids))
        leaves.append(node)
        return ("leaf",)

    return leaves, walk(tree)


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of structure ``treedef`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td == ("leaf",):
            return next(it)
        kind, keys, kids = td
        vals = [build(k) for k in kids]
        if keys is not None:
            return kind(zip(keys, vals))
        if kind is not tuple and issubclass(kind, tuple):
            return kind(*vals)  # a NamedTuple
        return kind(vals)

    out = build(treedef)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree structure holds")
    return out


def leaves(tree) -> List:
    return flatten(tree)[0]


def map(fn: Callable, tree) -> Any:  # noqa: A001 - jax.tree.map's name
    """``fn`` applied to every leaf, in the same structure."""
    ls, td = flatten(tree)
    return unflatten(td, [fn(x) for x in ls])
