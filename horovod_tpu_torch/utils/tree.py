"""Flatten nested dicts and lists of tensors in JAX's pytree leaf order.

``jax.tree_util.tree_flatten`` visits a dict's keys sorted and a list's
items in order.  The port flattens its parameter dicts the same way, so
fusion-bucket plans and broadcast names match the reference leaf for leaf
(``nn.Module`` registration order would not).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def tree_flatten(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                 ) -> Tuple[List[Any], Any]:
    """``(leaves, spec)``; :func:`tree_unflatten` rebuilds the tree.  A
    node for which ``is_leaf`` is true is a leaf (as jax's ``is_leaf``:
    an ``IndexedSlices``, a tuple, stays whole)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k], is_leaf) for k in keys]
        return ([leaf for leaves, _ in parts for leaf in leaves],
                ("dict", keys, [spec for _, spec in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(x, is_leaf) for x in tree]
        return ([leaf for leaves, _ in parts for leaf in leaves],
                (type(tree).__name__, None, [spec for _, spec in parts]))
    return [tree], None


def tree_unflatten(spec, leaves) -> Any:
    return _build(spec, iter(leaves))


def _build(spec, it):
    # A module-level function, not a nested recursive closure: such a
    # closure is a reference cycle that would hold ``leaves`` (and
    # whatever they view) until the garbage collector runs.
    if spec is None:
        return next(it)
    kind, keys, children = spec
    built = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, built))
    return tuple(built) if kind == "tuple" else built


def tree_map(fn: Callable, tree) -> Any:
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [fn(x) for x in leaves])


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_named_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in :func:`tree_leaves` order, the path of
    dict keys and list indices joined by ``/`` (``"layers/wq"``): the
    ``named_parameters`` of a parameter tree."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in tree_named_leaves(x, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]
