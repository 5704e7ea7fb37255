"""Nested dicts and lists of tensors (the params, optimizer-state, shift and
cache trees), walked as ``jax.tree`` walks them.

``tree_map`` keeps each dict's own key order.  ``tree_flatten`` lists the
leaves in JAX's order, which sorts dict keys: the reference numbers its
gradient leaves in that order (``jax.tree.flatten``), and the number of a
leaf sets its random key and the order in which sums over leaves are
taken, so the port walks the same order wherever that matters.
"""
from __future__ import annotations


def tree_map(fn, *trees):
    """Map over nested dicts and lists of tensors."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_flatten(tree):
    """(leaves in ``jax.tree.flatten`` order, treedef); ``tree_unflatten``
    rebuilds the tree, dicts in their original key order."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        else:
            leaves.append(t)

    walk(tree)
    return leaves, tree_map(lambda _: None, tree)


def tree_leaves(tree):
    return tree_flatten(tree)[0]


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(x) for x in t]
        return next(it)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_paths(tree):
    """The path of every leaf in ``tree_flatten`` order, as the reference
    names it from ``jax.tree_util.tree_flatten_with_path``: dict keys and
    list indices joined by "/"."""
    paths = []

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], prefix + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, prefix + (str(i),))
        else:
            paths.append("/".join(prefix))

    walk(tree, ())
    return paths
