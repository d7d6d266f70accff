"""Walkers over the port's parameter trees: nested dicts and lists of
tensors, as ``models.init_params`` builds them (``params["layers"]`` a list
of per-layer dicts).  The optimizer state's m and v are trees of the same
shape."""
from __future__ import annotations


def param_leaves(tree):
    """The tensors of a parameter tree, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from param_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from param_leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a parameter tree, in the same
    nesting of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
