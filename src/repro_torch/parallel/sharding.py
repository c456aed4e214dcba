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

The sharded step computes on the blocks as the reference's ``default``
recipe does (FSDP + TP): :func:`gather_for_compute` all-gathers one
parameter's block over the dimensions the compute does not keep split
(its backward: this rank's block of the sum over the ranks that hold
other batch rows), and :class:`TensorParallel` carries a rank's place
along "model" for the products split over it, with the two Megatron
conjugates :func:`tp_enter` (identity forward, all-reduce backward) and
:func:`tp_leave` (all-reduce forward, identity backward), and
:func:`tp_sum` for a statistic over a split dimension (all-reduce both
ways).  Only ``all_gather`` on lists and ``all_reduce`` are used.
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
    collective.

    For a parameter, ``keep`` names the dimensions the sharded step's
    compute keeps split (those of the logical "tp" and "ep" where its
    products are split over "model"); :func:`gather_for_compute` gathers
    the others, and over those of ``batch_axes`` among their axes its
    backward sums already (:attr:`summed`)."""

    def __init__(self, mesh, spec: tuple, keep: tuple[int, ...] = (),
                 batch_axes: tuple[str, ...] = ()):
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
        # the dimensions gathered for the compute, and the batch axes
        # among theirs, over which the gather's backward sums
        self.gathered = [(d, axes) for d, axes in self.splits
                         if d not in keep]
        self.summed = tuple(a for _, axes in self.gathered for a in axes
                            if a in batch_axes)

    def _index(self, axes: tuple[str, ...]) -> int:
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.mesh.get_local_rank(a)
        return i

    def _cut(self, full: torch.Tensor, splits) -> torch.Tensor:
        """A view of ``full`` narrowed to this rank's block along
        ``splits`` ((dimension, axes) pairs)."""
        out = full
        for d, axes in splits:
            n = math.prod(self.sizes[a] for a in axes)
            if full.shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(full.shape)} does "
                                 f"not split over {axes} ({n})")
            size = full.shape[d] // n
            out = out.narrow(d, self._index(axes) * size, size)
        return out

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``: a tensor of its own (``full``
        itself where the spec splits nothing here)."""
        if not self.splits:
            return full
        return self._cut(full, self.splits).clone(
            memory_format=torch.contiguous_format)

    def gather(self, block: torch.Tensor, splits=None) -> torch.Tensor:
        """The whole tensor from every rank's ``block``: one all-gather
        per split axis, the fastest first (``block`` itself where the
        spec splits nothing here).  ``splits`` (default: all) gathers
        only those (dimension, axes) pairs."""
        out = block
        for d, axes in (self.splits if splits is None else splits):
            for a in reversed(axes):
                parts = [torch.empty_like(out) for _ in range(self.sizes[a])]
                dist.all_gather(parts, out.contiguous(),
                                group=self.mesh.get_group(a))
                out = torch.cat(parts, d)
        return out

    def reduce(self, grad: torch.Tensor, axes: tuple[str, ...],
               of_block: bool = False) -> torch.Tensor:
        """This rank's block of the mean of ``grad`` over the ranks along
        ``axes`` (the batch axes): summed in place by one all-reduce per
        axis of size > 1, then divided by their product.  ``grad`` is a
        whole tensor's gradient, or with ``of_block`` (the sharded step)
        this rank's block's through :func:`gather_for_compute`, whose
        backward summed over :attr:`summed` already: those axes are not
        summed again."""
        done = self.summed if of_block else ()
        n = 1
        for a in axes:
            if self.sizes[a] > 1:
                if a not in done:
                    dist.all_reduce(grad, group=self.mesh.get_group(a))
                n *= self.sizes[a]
        if n > 1:
            grad.div_(n)
        return grad if of_block else self.block(grad)


class _GatherForCompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, place):
        ctx.place = place
        return place.gather(block.detach(), place.gathered)

    @staticmethod
    def backward(ctx, grad):
        place = ctx.place
        grad = grad.contiguous().clone()
        for a in place.summed:
            dist.all_reduce(grad, group=place.mesh.get_group(a))
        return place._cut(grad, place.gathered).contiguous(), None


def gather_for_compute(block: torch.Tensor, place: Placement) -> torch.Tensor:
    """``block`` (a parameter's, this rank's) all-gathered over the
    dimensions the compute does not keep split, as autograd sees it: the
    backward is this rank's block of the gradient's sum over the batch
    axes among them (the ranks that hold other rows; along an axis whose
    ranks hold the same rows, as "model" for the mixer's ``w_bc``, the
    gradients are equal and the block is taken).  ``block`` itself where
    nothing is gathered here."""
    if not place.gathered:
        return block
    return _GatherForCompute.apply(block, place)


class TensorParallel:
    """A rank's place along "model" for the products split over it: its
    index ``rank`` of ``size`` and the process ``group`` the conjugate
    ops all-reduce over.  Without a group (one rank's local block run
    alone, as ``parallel.tp_local`` runs it) every all-reduce is the
    identity: :func:`tp_enter` and :func:`tp_leave` then return their
    input."""

    def __init__(self, rank: int, size: int, group=None):
        self.rank, self.size, self.group = rank, size, group

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> None:
        """``x`` summed (or its maximum taken) over the group, in place."""
        if self.group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.SUM, group=self.group)

    def split(self, local: int, whole: int) -> bool:
        """Whether a dimension of ``whole`` entries held as ``local`` on
        this rank is split over "model" (else it is replicated: its
        product runs whole on every rank)."""
        if local == whole:
            return False
        if local * self.size != whole:
            raise ValueError(f"{local} of {whole} on {self.size} ranks")
        return True


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ctx.tp.all_reduce(grad)
        return grad, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        x = x.contiguous().clone()
        tp.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        x = x.contiguous().clone()
        tp.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ctx.tp.all_reduce(grad)
        return grad, None


def splits(tp: TensorParallel | None, local: int, whole: int) -> bool:
    """Whether ``tp`` splits a dimension of ``whole`` entries that this
    rank holds ``local`` of (:meth:`TensorParallel.split`; never without
    ``tp``)."""
    return tp is not None and tp.split(local, whole)


def tp_enter(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """Megatron's ``f`` at the entry of a region split over "model":
    identity forward, all-reduce backward (the ranks' partial input
    gradients summed).  Also applied to a tensor replicated over "model"
    that the region reads (a replicated ``wk``, the q/k norms), whose
    ranks' gradients are partial."""
    if tp is None or tp.group is None:
        return x
    return _Enter.apply(x, tp)


def tp_leave(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """Megatron's ``g`` at the exit of a row-parallel product: the ranks'
    partial outputs all-reduced forward, identity backward."""
    if tp is None or tp.group is None:
        return x
    return _Leave.apply(x, tp)


def tp_sum(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """A statistic summed over "model" inside a split region (the gated
    norm's sum of squares over a split ``d_inner``): all-reduce forward,
    and backward too, since every rank's output reads every rank's
    input.  It goes through ``tp.all_reduce`` even without a group (the
    identity there), so that ``parallel.tp_local`` can supply the other
    ranks' share."""
    if tp is None:
        return x
    return _Sum.apply(x, tp)


class ShardedCompute:
    """What a model computes with on a rank of the sharded step: the
    :class:`Placement` of each of its parameters (by the tensor's
    identity: the parameters are this rank's blocks) and ``tp``, the
    rank's :class:`TensorParallel` (``None`` where no product is split
    over "model")."""

    def __init__(self, places: dict[int, Placement],
                 tp: TensorParallel | None):
        self.places = places
        self.tp = tp

    def gather(self, x):
        """A parameter (or a dict of them, nested) as the compute reads
        it: :func:`gather_for_compute` of each block."""
        if isinstance(x, dict):
            return {k: self.gather(v) for k, v in x.items()}
        place = self.places.get(id(x))
        return x if place is None else gather_for_compute(x, place)
