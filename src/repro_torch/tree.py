"""Trees of tensors: nested dicts, lists and tuples (NamedTuples such as
``AdamWState`` included), walked in the order ``jax.tree_util`` walks
the reference's pytrees: dict keys sorted, sequences in order.  ``None``
holds no leaf, as in JAX.  The optimizer, the train step and the
checkpoint store share these."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

#: a leaf's path: dict keys, sequence indices and NamedTuple field names
Path = Tuple[str, ...]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    return [(str(i), v) for i, v in enumerate(node)]


def flatten_with_path(tree) -> List[Tuple[Path, Any]]:
    """Every leaf with its path, in ``jax.tree_util`` order."""
    return list(_walk(tree, ()))


def _walk(node, path: Path) -> Iterator[Tuple[Path, Any]]:
    if node is None:
        return
    if isinstance(node, (dict, list, tuple)):
        for name, child in _children(node):
            yield from _walk(child, path + (name,))
    else:
        yield path, node


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in _walk(tree, ())]


def tree_map(fn: Callable[..., Any], tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s
    structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *parts) for parts in zip(tree, *rest)]
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with ``new_leaves`` (in ``leaves`` order) in
    place of its leaves."""
    return _rebuild(like, iter(new_leaves))


def _rebuild(node, it: Iterator[Any]) -> Any:
    # a module-level function, not a closure: a recursive closure is a
    # reference cycle that would keep the new leaves alive until the
    # cyclic collector runs
    if node is None:
        return None
    if isinstance(node, dict):
        built = {k: _rebuild(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        out = [_rebuild(v, it) for v in node]
        return type(node)(*out) if _is_namedtuple(node) else type(node)(out)
    return next(it)
