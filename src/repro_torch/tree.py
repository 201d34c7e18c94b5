"""Trees of tensors: nested dicts, tuples and lists, the port's
counterpart of the ``jax.tree_util`` calls the reference makes.

Dicts flatten in sorted key order, as ``jax.tree_util`` flattens them, so
the leaves of a tree come out in the reference's order; ``None`` is an
empty subtree.  A leaf's path is a tuple of :class:`DictKey` /
:class:`SequenceKey`, as ``jax.tree_util.tree_flatten_with_path`` gives
it (the checkpoint's file names and the sharding rules read it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


@dataclasses.dataclass(frozen=True)
class DictKey:
    key: Any


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    idx: int


def tree_map_with_path(fn: Callable, tree, *rest, is_leaf=None, _path=()):
    """``fn(path, leaf, *other_leaves)`` over every leaf, in the tree's
    structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(_path, tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      is_leaf=is_leaf,
                                      _path=_path + (DictKey(k),))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               is_leaf=is_leaf,
                               _path=_path + (SequenceKey(i),))
            for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(_path, tree, *rest)


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """``jax.tree_util.tree_map``."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest,
                              is_leaf=is_leaf)


def tree_flatten_with_path(tree, is_leaf=None) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in the reference's leaf order."""
    out = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree,
                       is_leaf=is_leaf)
    return out


def tree_leaves(tree, is_leaf=None):
    return [x for _, x in tree_flatten_with_path(tree, is_leaf=is_leaf)]
