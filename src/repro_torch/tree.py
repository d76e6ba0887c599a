"""Nested containers of tensors, walked as ``jax.tree_util`` walks them.

Dicts (keys sorted), lists, tuples and NamedTuples are nodes; ``None`` is
an empty node; anything else is a leaf.  Paths are spelled as
``jax.tree_util.keystr`` spells them (``['stack']['slots'][0]['attn_wq']``,
``.m`` for a NamedTuple field), which is what the checkpoint manifest
records, so both packages name a leaf the same way.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_path(tree, prefix: str = "",
                     is_leaf: Callable | None = None
                     ) -> Iterator[tuple[str, Any]]:
    """(keystr path, leaf) for every leaf, in ``jax.tree`` order; a node
    for which ``is_leaf`` holds is a leaf."""
    if tree is None:
        return
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{prefix}[{k!r}]", is_leaf)
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, f"{prefix}.{name}", is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{prefix}[{i}]", is_leaf)
    else:
        yield prefix, tree


def leaves(tree, is_leaf: Callable | None = None) -> list:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf=is_leaf)]


def map_leaves(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``tree`` with every leaf replaced by ``fn(leaf, *same leaves of
    rest)``; the containers are rebuilt (NamedTuples as their type); a node
    for which ``is_leaf`` holds is a leaf."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest),
                              is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [map_leaves(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def unflatten_like(tree, new_leaves: list):
    """``tree``'s structure with ``new_leaves`` in ``jax.tree`` order."""
    paths = [p for p, _ in leaves_with_path(tree)]
    if len(paths) != len(new_leaves):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of "
                         f"{len(paths)}")
    by_path = dict(zip(paths, new_leaves))
    return map_with_path(lambda p, _: by_path[p], tree)


def map_with_path(fn: Callable, tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], f"{prefix}[{k!r}]")
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, v, f"{prefix}.{name}")
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
