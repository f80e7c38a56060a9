"""Trees of tensors: nested dicts, lists or tuples with tensor leaves, a
dict's leaves in sorted-key order, as ``jax.tree.leaves`` orders them.
The optimizer and the collectives both walk gradient trees this way."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """The tensors of ``tree``: a dict's in sorted-key order, a list's or
    tuple's in order, depth first."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn, tree):
    """``tree``'s structure with ``fn`` applied to each leaf."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key]) for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, node) for node in tree)
    return fn(tree)


def tree_unflatten(tree, leaves):
    """``tree``'s structure over ``leaves`` (an iterable), in
    :func:`tree_leaves`' order."""
    leaves = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {key: build(node[key]) for key in sorted(node)}
            return {key: out[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(child) for child in node)
        return next(leaves)

    return build(tree)
