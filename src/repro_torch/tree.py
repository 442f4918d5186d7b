"""Trees of tensors: nested dicts, lists, tuples and NamedTuples.

The port's parameter, gradient and optimizer trees are plain containers
(``params["segments"][seg][period]["b0"]["attn"]["wqkv"]``).  These
helpers walk them in one fixed order, the order ``jax.tree.flatten``
gives the same containers: dict keys sorted, sequences and NamedTuple
fields in order.  Anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def children(node) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of a container node in flatten order, or []
    for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return []


def is_leaf(node) -> bool:
    return not isinstance(node, (dict, tuple, list))


def leaves_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """Every leaf with the keys that lead to it, in flatten order."""
    if is_leaf(tree):
        return [(path, tree)]
    out = []
    for k, v in children(tree):
        out += leaves_with_path(v, path + (k,))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """`like`'s structure with its leaves replaced, in flatten order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """`fn` over the leaves of `tree` and of the trees in `rest`, which
    have its structure."""
    own = leaves(tree)
    others = [leaves(t) for t in rest]
    if any(len(o) != len(own) for o in others):
        raise ValueError("tree_map over trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(own, *others)])
