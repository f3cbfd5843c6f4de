"""Small helpers over nested dicts, lists and tuples of tensors or arrays.

Names and order match ``repro/utils/tree.py`` exactly: a leaf's name is its
path joined as ``a/b/0/c``, dict keys are visited in SORTED order (as JAX's
pytree flattening does; ``torch.utils._pytree`` keeps insertion order, so it
is not used), and ``None`` is an empty subtree with no leaves.
"""
from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) or x is None


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return []


def _rebuild(node, values: list):
    if isinstance(node, dict):
        return {k: v for k, v in zip(sorted(node), values)}
    if isinstance(node, tuple):
        return tuple(values)
    if isinstance(node, list):
        return list(values)
    return None


def flatten_with_names(tree) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []

    def walk(node, path):
        if not _is_node(node):
            out.append(("/".join(path), node))
            return
        for k, child in _children(node):
            walk(child, path + (str(k),))

    walk(tree, ())
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_names(tree)]


def tree_map(f: Callable, tree, *rest) -> Any:
    """``f`` over the leaves of ``tree`` (and the matching leaves of ``rest``,
    which must have the same structure)."""
    if not _is_node(tree):
        return f(tree, *rest)
    if tree is None:
        return None
    kids = _children(tree)
    others = [_children(r) for r in rest]
    for r, o in zip(rest, others):
        if type(r) is not type(tree) or [k for k, _ in o] != [k for k, _ in kids]:
            raise ValueError("tree_map: trees differ in structure")
    return _rebuild(tree, [tree_map(f, c, *[o[i][1] for o in others])
                           for i, (_, c) in enumerate(kids)])


def tree_map_with_path(f: Callable, tree, path: tuple = ()) -> Any:
    """``f(path_str, leaf)`` over the leaves of ``tree``."""
    if not _is_node(tree):
        return f("/".join(path), tree)
    if tree is None:
        return None
    return _rebuild(tree, [tree_map_with_path(f, c, path + (str(k),))
                           for k, c in _children(tree)])


def unflatten_like(template, named: dict[str, Any]) -> Any:
    """Rebuild a tree shaped like ``template`` from a {path: leaf} dict."""
    def pick(name, _old):
        if name not in named:
            raise KeyError(f"missing leaf {name!r} while unflattening")
        return named[name]

    return tree_map_with_path(pick, template)


def tree_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in tree_leaves(tree) if hasattr(x, "shape"))


def tree_count(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree) if hasattr(x, "shape"))


_SAFE = re.compile(r"[^A-Za-z0-9_.\-]")


def safe_filename(name: str) -> str:
    return _SAFE.sub("_", name)
