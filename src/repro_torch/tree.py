"""Nested containers of tensors (the port's pytrees): dicts, lists and
tuples, with anything else a leaf and ``None`` an empty subtree.

The port keeps params, gradients and optimizer moments as plain nested
dicts and lists.  Traversal follows the containers' own order (a dict's
insertion order); ``sort_keys=True`` walks a dict's keys sorted instead,
the order ``jax.tree.flatten`` gives the JAX package's trees.
"""
from __future__ import annotations


def _children(tree, sort_keys: bool):
    if isinstance(tree, dict):
        keys = sorted(tree) if sort_keys else tree
        return [tree[k] for k in keys]
    return list(tree)


def tree_leaves(tree, *, sort_keys: bool = False) -> list:
    """The leaves of ``tree`` in traversal order (``None`` holds none)."""
    if tree is None:
        return []
    if isinstance(tree, (dict, list, tuple)):
        return [leaf for child in _children(tree, sort_keys)
                for leaf in tree_leaves(child, sort_keys=sort_keys)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves, *, sort_keys: bool = False):
    """A tree of ``like``'s structure whose leaves are ``leaves``, taken in
    the order :func:`tree_leaves` walks ``like`` with the same
    ``sort_keys``."""
    it = iter(leaves)
    missing = object()

    def take():
        leaf = next(it, missing)
        if leaf is missing:
            raise ValueError("fewer leaves than the tree holds")
        return leaf

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = sorted(node) if sort_keys else list(node)
            built = {k: build(node[k]) for k in keys}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)([build(v) for v in node])
        return take()

    out = build(like)
    if next(it, missing) is not missing:
        raise ValueError("more leaves than the tree holds")
    return out
