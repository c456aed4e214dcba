"""Trees of tensors: nested dicts, lists, tuples and dataclasses.

One walk order for the whole port: dict keys in insertion order, sequence
items by index, dataclass fields in declaration order.  A leaf is anything
else, or a node that ``is_leaf`` accepts (the optimizer passes its int8
moment, a ``(q, scale)`` pair, as one leaf).  A leaf's path joins the keys,
indices and field names above it with ``/``; the checkpoint manager stores
each leaf under its path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

IsLeaf = Callable[[Any], bool] | None


def _is_record(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def flatten(tree, is_leaf: IsLeaf = None,
            prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs of ``tree``, in walk order."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix[:-1], tree)]
    if _is_record(tree):
        return [x for f in dataclasses.fields(tree)
                for x in flatten(getattr(tree, f.name), is_leaf,
                                 f"{prefix}{f.name}/")]
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in flatten(v, is_leaf, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten(v, is_leaf, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def unflatten(template, leaves: dict[str, Any], is_leaf: IsLeaf = None,
              prefix: str = ""):
    """``template``'s structure with the leaf at each of its paths taken
    from ``leaves``."""
    if is_leaf is not None and is_leaf(template):
        return leaves[prefix[:-1]]
    if _is_record(template):
        return dataclasses.replace(template, **{
            f.name: unflatten(getattr(template, f.name), leaves, is_leaf,
                              f"{prefix}{f.name}/")
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: unflatten(v, leaves, is_leaf, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        items = [unflatten(v, leaves, is_leaf, f"{prefix}{i}/")
                 for i, v in enumerate(template)]
        return items if isinstance(template, list) else tuple(items)
    return leaves[prefix[:-1]]


def leaves(tree, is_leaf: IsLeaf = None) -> list:
    """The leaves of ``tree``, in walk order."""
    return [x for _, x in flatten(tree, is_leaf)]


def tree_map(fn: Callable, tree, *rest, is_leaf: IsLeaf = None):
    """``fn`` over the leaves of ``tree`` and the leaves at the same paths
    of ``rest``, in ``tree``'s structure."""
    others = [dict(flatten(r, is_leaf)) for r in rest]
    return unflatten(tree, {p: fn(x, *(o[p] for o in others))
                            for p, x in flatten(tree, is_leaf)}, is_leaf)


def with_leaves(tree, new: list, is_leaf: IsLeaf = None):
    """``new`` (in walk order) in ``tree``'s structure."""
    paths = [p for p, _ in flatten(tree, is_leaf)]
    if len(paths) != len(new):
        raise ValueError(f"{len(new)} leaves for a tree of {len(paths)}")
    return unflatten(tree, dict(zip(paths, new)), is_leaf)
