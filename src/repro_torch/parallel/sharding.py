"""The declarative half of the sharding layer: logical axes resolved
against a mesh.

Counterpart of the reference's ``parallel/sharding.py``.  Every parameter
declares its logical axes once (:class:`~repro_torch.models.params.
ParamDef`'s ``logical``), and so does every cache buffer and model input
(``models.cache_spec``, ``launch.specs.input_specs``).  Logical axes name
a role, resolved against the mesh:

  "fsdp"   → "data"                (ZeRO-3 sharding of params/opt state)
  "tp"     → "model"               (Megatron tensor parallelism)
  "ep"     → "model"               (expert parallelism)
  "dp"     → ("pod", "data")       (batch)
  "sp"     → "model"               (long-context sequence sharding)

Axes not on the mesh resolve to ``None`` (elastic down-scaling).  A
resolved spec is a tuple with one entry per dimension: ``None``, a mesh
axis name, or a tuple of names; it equals ``tuple(PartitionSpec)`` of the
reference's.  The mesh is a description, anything with ``axis_names``
and ``shape`` (axis name → size), such as :class:`repro_torch.launch.
mesh.MeshShape`: these functions place nothing on a device.  From a spec
come each rank's share of a tensor (:func:`local_shape`) and its bytes
(:func:`rank_bytes`), which the dry run records.
"""

from __future__ import annotations

import math

from .. import tree
from ..models.params import (  # noqa: F401  (the reference's names)
    ParamDef,
    abstract_params,
    count_params,
    init_params,
    is_def,
    param_specs,
)

LOGICAL_TO_PHYSICAL = {
    "fsdp": ("data",),
    "tp": ("model",),
    "ep": ("model",),
    "dp": ("pod", "data"),
    "sp": ("model",),
    None: (),
}

# per-architecture overrides of the logical → physical map:
#   default   — FSDP + TP, for multi-B dense models;
#   dp_only   — pure data parallelism, parameters replicated (a small
#               model, mamba2-130m, gains nothing from sharding 130M
#               parameters over hundreds of devices);
#   fsdp_only — ZeRO-3 without tensor parallelism.
RECIPES: dict[str, dict] = {
    "default": LOGICAL_TO_PHYSICAL,
    "dp_only": {
        **LOGICAL_TO_PHYSICAL,
        "fsdp": (),
        "tp": (),
        "ep": (),
        "sp": (),
        "dp": ("pod", "data", "model"),
    },
    "fsdp_only": {
        **LOGICAL_TO_PHYSICAL,
        "tp": (),
        "ep": (),
        "dp": ("pod", "data", "model"),
    },
}


def resolve_spec(logical: tuple, mesh, shape: tuple[int, ...] | None = None,
                 recipe: str = "default") -> tuple:
    """Map logical axis names to mesh axes, dropping absent ones.

    With ``shape``, axes that do not evenly divide their dimension are
    dropped (the rightmost first for a dimension of several axes, then
    retried): kv-heads fewer than the TP axis fall back to replication, a
    batch of 1 falls off DP, a vocabulary not divisible by 16 keeps the
    embedding unsharded.  A mesh axis serves at most one dimension."""
    table = RECIPES[recipe]
    out = []
    used: set[str] = set()
    for i, ax in enumerate(logical):
        if ax is None:
            out.append(None)
            continue
        phys = [a for a in table.get(ax, (ax,))
                if a in mesh.axis_names and a not in used]
        if shape is not None:
            dim = shape[i] if i < len(shape) else 0
            while phys and dim % math.prod(mesh.shape[a] for a in phys):
                phys = phys[:-1]
        used.update(phys)
        if not phys:
            out.append(None)
        elif len(phys) == 1:
            out.append(phys[0])
        else:
            out.append(tuple(phys))
    return tuple(out)


def is_logical(x) -> bool:
    """A logical-axes tuple (a leaf of a logical tree; ``()`` for a
    scalar)."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def param_shardings(defs, mesh, recipe: str = "default"):
    """``defs`` with each declaration replaced by its resolved spec."""
    return tree.tree_map(
        lambda d: resolve_spec(d.logical, mesh, d.shape, recipe), defs,
        is_leaf=is_def)


def flat_specs(abstract_tree, logical_tree, mesh,
               recipe: str = "default") -> list[tuple[str, object, tuple]]:
    """``(path, abstract leaf, resolved spec)`` of every leaf of a tree
    of tensors and its parallel tree of logical-axes tuples (the two
    must have the same leaf paths)."""
    logical = tree.flatten(logical_tree, is_logical)
    abstract = tree.flatten(abstract_tree)
    if [p for p, _ in logical] != [p for p, _ in abstract]:
        raise ValueError(f"{len(logical)} logical vs {len(abstract)} "
                         "abstract leaves, or other paths")
    return [(p, a, resolve_spec(log, mesh, tuple(a.shape), recipe))
            for (p, a), (_, log) in zip(abstract, logical)]


def logical_shardings(abstract_tree, logical_tree, mesh,
                      recipe: str = "default"):
    """Shape-aware specs for a tree of tensors (a batch, a cache, the
    optimizer or training state) and its parallel tree of logical-axes
    tuples, in the logical tree's structure."""
    return tree.unflatten(logical_tree, {
        p: spec for p, _, spec in flat_specs(abstract_tree, logical_tree,
                                             mesh, recipe)}, is_logical)


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """One rank's share of a tensor of ``shape`` under ``spec``: each
    dimension divided by the product of the mesh axes it is split over
    (``NamedSharding(mesh, spec).shard_shape(shape)`` of the reference's
    mesh)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n = math.prod(mesh.shape[a] for a in axes)
        if dim % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"split over {axes} ({n})")
        out.append(dim // n)
    return tuple(out)


def rank_bytes(abstract_tree, logical_tree, mesh,
               recipe: str = "default") -> int:
    """The bytes one rank holds of a tree of tensors under the resolved
    specs of its logical tree (replicated tensors whole)."""
    return sum(math.prod(local_shape(tuple(a.shape), spec, mesh))
               * a.element_size()
               for _, a, spec in flat_specs(abstract_tree, logical_tree,
                                            mesh, recipe))
