"""Nested-container helpers — the port's counterpart of ``jax.tree_util``.

A tree is a nest of dicts, lists and tuples whose leaves are tensors (or
any non-container).  Flattening follows JAX's order: dict entries by
sorted key, sequences by index.  A leaf's path renders as JAX's
``leaf_key`` does: dict keys and list indices joined by ``/``, so
``{"groups": [[{"k": t}]]}`` names its leaf ``groups/0/0/k``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaf_key(path) -> str:
    return "/".join(str(p) for p in path)


def flatten_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]`` in JAX's flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_with_path(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out.extend(flatten_with_path(x, prefix + (i,)))
        return out
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [x for _, x in flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over one or more trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, prefix: Tuple = ()):
    """``fn(path, leaf)`` leafwise, same structure out — the counterpart
    of ``jax.tree_util.tree_map_with_path``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], prefix + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, x, prefix + (i,))
                          for i, x in enumerate(tree))
    return fn(prefix, tree)


def replace_leaves(tree, new: dict):
    """Same tree with the leaves whose ``leaf_key`` is in ``new`` swapped
    for ``new[key]``; every other leaf is kept (not copied)."""
    return map_with_path(lambda p, x: new.get(leaf_key(p), x), tree)
