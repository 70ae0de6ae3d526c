"""Minimal pytree helpers over the nested dict / tuple / list / None trees the
port keeps its parameters, adapters and caches in (the JAX package uses
``jax.tree`` for the same trees)."""
from __future__ import annotations

from typing import Any, Callable, Optional


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    ``rest``, which share its structure).  ``None`` stays ``None``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any,
                is_leaf: Optional[Callable[[Any], bool]] = None) -> list:
    out: list = []
    tree_map(lambda x: out.append(x), tree, is_leaf=is_leaf)
    return out


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` for every leaf of ``tree``; ``path`` is the tuple
    of dict keys and sequence indices that leads to the leaf.  ``None``
    stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)
