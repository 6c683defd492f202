"""Nested-dict pytrees of tensors, flattened as `jax.tree.flatten` does.

The port keeps the reference's functional trees (parameters, gradients,
optimizer moments, error-feedback residuals are nested dicts of tensors),
so every per-leaf loop visits the leaves in the SAME order as the
reference: dict keys sorted, lists and tuples in order. That order fixes
each leaf's bucket offsets in a sketch. Anything that is not a dict, list
or tuple is a leaf (tensors, TT/CP containers, scalars).
"""
from __future__ import annotations

from typing import Any, Callable


# The recursions are module-level functions that take their accumulator:
# a nested function that calls itself is a reference cycle (the function
# and its closure cell), which would keep the leaves it captured alive
# until Python's cyclic collector runs; a train step's whole trees would
# outlive the step.

def _flatten(node, leaves: list):
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys),
                tuple(_flatten(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, len(node),
                tuple(_flatten(c, leaves) for c in node))
    leaves.append(node)
    return None


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, treedef); `treedef` is a hashable description of the
    containers."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _unflatten(d, it):
    if d is None:
        return next(it)
    kind, keys, children = d
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(keys, children)}
    out = [_unflatten(c, it) for c in children]
    return tuple(out) if kind == "tuple" else out


def tree_unflatten(treedef: Any, leaves) -> Any:
    """Inverse of `tree_flatten`."""
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, it) is not it:
        raise ValueError("tree_unflatten got more leaves than the treedef has")
    return out


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over corresponding leaves of trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for t in rest:
        lv, td = tree_flatten(t)
        if td != treedef:
            raise ValueError("tree_map over trees of different structure")
        others.append(lv)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


__all__ = ["tree_flatten", "tree_leaves", "tree_map", "tree_unflatten"]
