"""Nested-dict parameter trees: the tree operations the training stack
needs.  Leaves are visited with dict keys in sorted order, as the
reference flattens dicts, so sums over leaves add in the reference's
order."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
