"""The sharding layer: logical axes resolved against a mesh, and tensors
placed on a live one.

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

The live half places tensors on a ``torch.distributed`` ``DeviceMesh``
(:func:`repro_torch.launch.mesh.make_host_mesh`): a :class:`Placement`
cuts this rank's block of a tensor under its resolved spec, gathers the
whole tensor from the blocks, and reduces a gradient over the batch axes
to this rank's block.  On a mesh of one rank each is the identity on the
same storage.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .. import tree
from ..launch.mesh import MeshShape
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
        axes = spec_axes(spec[i] if i < len(spec) else None)
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


# ----------------------------------------------------------------------
# live placement on a DeviceMesh
# ----------------------------------------------------------------------
def describe(mesh) -> MeshShape:
    """A live ``DeviceMesh``'s axis names and sizes, for
    :func:`resolve_spec`."""
    return MeshShape(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one entry of a resolved spec, slowest first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def batch_axes(mesh, recipe: str = "default") -> tuple[str, ...]:
    """The mesh axes a batch's leading dimension is split over: the
    logical ``"dp"`` resolved under ``recipe``."""
    return spec_axes(resolve_spec(("dp",), describe(mesh), None, recipe)[0])


def axes_group(mesh, axes: tuple[str, ...]):
    """The process group of this rank's ranks along ``axes`` (the others'
    coordinates fixed), its ranks in the order of a dimension split over
    ``axes``, the first the slowest; ``None`` where every axis has size
    1.  More than one axis of size > 1 makes new groups: every rank of
    the run must call it with the same ``axes``."""
    sizes = describe(mesh).shape
    live = [a for a in axes if sizes[a] > 1]
    if not live:
        return None
    if len(live) == 1:
        return mesh.get_group(live[0])
    names = list(mesh.mesh_dim_names)
    order = [names.index(a) for a in names if a not in live] + [
        names.index(a) for a in live]
    rows = mesh.mesh.permute(order).reshape(-1, math.prod(
        sizes[a] for a in live)).tolist()
    mine = None
    for row in rows:
        group = dist.new_group(row)
        if dist.get_rank() in row:
            mine = group
    return mine


class Placement:
    """One tensor's place on a live mesh under its resolved ``spec``
    (:func:`local_shape`'s semantics): a dimension split over a tuple of
    axes is cut into their product of blocks, the first axis the slowest,
    as ``NamedSharding`` cuts it.  An axis of size 1 splits nothing, so
    on a mesh of one rank :meth:`block`, :meth:`gather` and
    :meth:`reduce` return the tensor they were given: no copy and no
    collective."""

    def __init__(self, mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.sizes = describe(mesh).shape
        # (dimension, the axes of size > 1 it is split over)
        self.splits = [(d, axes) for d, axes in (
            (d, tuple(a for a in spec_axes(e) if self.sizes[a] > 1))
            for d, e in enumerate(self.spec)) if axes]
        self.split_axes = tuple(a for _, axes in self.splits for a in axes)
        # this rank counts the tensor's block once in a sum over the run:
        # it is first along every axis the tensor is replicated over
        self.counted = all(mesh.get_local_rank(a) == 0
                           for a in mesh.mesh_dim_names
                           if a not in self.split_axes)

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``: a tensor of its own (``full``
        itself where the spec splits nothing here)."""
        if not self.splits:
            return full
        out = full
        for d, axes in self.splits:
            n = math.prod(self.sizes[a] for a in axes)
            if full.shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(full.shape)} does "
                                 f"not split over {axes} ({n})")
            i = 0
            for a in axes:
                i = i * self.sizes[a] + self.mesh.get_local_rank(a)
            size = full.shape[d] // n
            out = out.narrow(d, i * size, size)
        return out.clone(memory_format=torch.contiguous_format)

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's ``block``: one all-gather
        per split axis, the fastest first (``block`` itself where the
        spec splits nothing here)."""
        out = block
        for d, axes in self.splits:
            for a in reversed(axes):
                parts = [torch.empty_like(out) for _ in range(self.sizes[a])]
                dist.all_gather(parts, out.contiguous(),
                                group=self.mesh.get_group(a))
                out = torch.cat(parts, d)
        return out

    def reduce(self, grad: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
        """This rank's block of the mean of ``grad`` over the ranks along
        ``axes`` (the batch axes): summed in place by one all-reduce per
        axis of size > 1, then divided by their product."""
        n = 1
        for a in axes:
            if self.sizes[a] > 1:
                dist.all_reduce(grad, group=self.mesh.get_group(a))
                n *= self.sizes[a]
        if n > 1:
            grad.div_(n)
        return self.block(grad)
