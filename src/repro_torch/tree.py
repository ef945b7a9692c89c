"""Parameter trees of the port: nested dicts whose leaves are tensors or
arrays (what ``jax.tree`` does for the reference's pytrees)."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same keys); anything that is not a dict is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in key order (the order ``tree_map`` visits them)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves) -> dict:
    """A tree shaped like ``tree`` holding ``leaves`` in key order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
