"""Nested-dict trees of tensors (the port's stand-in for JAX pytrees).

Leaves are visited in dict insertion order, the same order by every
function here, so `tree_unflatten(tree, tree_leaves(tree))` rebuilds
`tree`."""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List


def tree_leaves(tree) -> List:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """fn applied leafwise over `tree` and trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves: Iterable) -> Dict:
    """A tree shaped like `tree` whose leaves come from `leaves`, in
    `tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
