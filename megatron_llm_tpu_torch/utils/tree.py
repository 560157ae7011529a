"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

Leaves are tensors (or None); order is the dicts' insertion order, the
same for every tree built from one parameter dict.
"""

from __future__ import annotations


def tree_leaves_with_path(tree, path=()):
    """``[(path tuple, leaf), ...]`` in insertion order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(tree_leaves_with_path(v, path + (k,)))
        return out
    return [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(like, leaves) -> dict:
    """A tree shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
