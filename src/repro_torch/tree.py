"""Trees of tensors, flattened in the reference's leaf order.

The reference keeps parameters, optimizer state and error-feedback state
as JAX pytrees, and its per-leaf loops (``comm/sparse.py``) walk them in
``jax.tree.leaves`` order, which sorts dict keys.  ``torch.utils._pytree``
keeps insertion order instead, so the port flattens with these helpers:
dicts by sorted key, lists, tuples and named tuples in order, ``None`` as
an empty node, anything else a leaf.  ``unflatten`` builds dicts with
their keys sorted, so a rebuilt tree iterates in leaf order too.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = "leaf"


def _flatten(tree: Any, out: List[Any]):
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return (dict, keys, tuple(_flatten(tree[k], out) for k in keys))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree), None, tuple(_flatten(v, out) for v in tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree), None, tuple(_flatten(v, out) for v in tree))
    if tree is None:
        return (None, None, ())
    out.append(tree)
    return (_LEAF, None, ())


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves in the reference's order, the tree's structure)."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def unflatten(treedef: Any, leaves_: List[Any]) -> Any:
    it = iter(leaves_)

    def build(node):
        kind, keys, children = node
        if kind == _LEAF:
            return next(it)
        if kind is None:
            return None
        built = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, built))
        if kind in (list, tuple):
            return kind(built)
        return kind(*built)                     # named tuple

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def flatten_up_to(treedef: Any, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``treedef``, in
    leaf order (``tree`` has ``treedef``'s structure down to them; what
    sits there may be any value, ``()`` included)."""
    out: List[Any] = []

    def walk(node, sub):
        kind, keys, children = node
        if kind == _LEAF:
            out.append(sub)
        elif kind is dict:
            for k, c in zip(keys, children):
                walk(c, sub[k])
        elif kind is not None:
            if len(sub) != len(children):
                raise ValueError("tree does not match the structure")
            for c, v in zip(children, sub):
                walk(c, v)

    walk(treedef, tree)
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``,
    which must have the same structure."""
    flat, treedef = flatten(tree)
    others = []
    for r in rest:
        lr, td = flatten(r)
        if td != treedef:
            raise ValueError("tree_map over trees of different structure")
        others.append(lr)
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def leaf_paths(tree: Any) -> List[str]:
    """Each leaf's path in leaf order, as the reference's
    ``parallel/sharding.py::_path_str`` spells it: dict keys, sequence
    indices and named-tuple field names joined by ``/``."""
    out: List[str] = []

    def walk(node, parts):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], parts + [str(k)])
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                walk(v, parts + [f])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, parts + [str(i)])
        elif node is not None:
            out.append("/".join(parts))

    walk(tree, [])
    return out
