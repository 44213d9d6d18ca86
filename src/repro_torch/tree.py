"""Trees of tensors (nested dicts and lists): the port's stand-in for the
few ``jax.tree`` functions its optimizers use.

Leaves come in JAX's order (dict keys sorted, lists in order), so a
global norm sums them as JAX does and flattened trees line up with the
JAX package's.
"""

from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``tree``."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            filled = {k: fill(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if isinstance(t, list):
            return [fill(v) for v in t]
        return next(it)

    return fill(tree)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the leaves of a tree; ``path`` holds the
    dict keys (as str) and list indices down to the leaf, as
    ``jax.tree_util.tree_map_with_path`` gives them."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)
