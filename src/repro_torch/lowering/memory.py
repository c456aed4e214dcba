"""Lifetime-based buffer planning (Sec. III, Thm. 1 → a static memory plan).

The planner's width proxy (Eq. 2: ``max_e |s_e|``) bounds the *largest
single tensor*, but the executor's real footprint is the **live set** —
every buffer born and not yet consumed at some step.  The paper's central
observation is that tensor lifetimes are what determine both quantities,
and its runtime allocates buffers from a static lifetime-derived plan
instead of a dynamic heap.  This module is that plan for the PyTorch
executor:

  * :func:`plan_memory` runs the same lifetime machinery that drives
    two-phase hoisting (``lifetime_closure`` via
    :func:`~repro_torch.lowering.partition.partition_tree`, interval algebra
    via :func:`repro_torch.core.lifetime.step_lifetimes`) over a ``(tree, S)``
    pair and emits a :class:`MemoryPlan` with one :class:`SegmentPlan`
    per execution segment — the naive full-tree-per-slice program and,
    when ``S`` is non-empty, the hoisted prologue/epilogue pair;
  * each segment gets a **linear-scan slot assignment** (buffers with
    disjoint lifetimes share a slot — the classic register-allocation
    sweep over birth order) plus the **exact live-set peak** in bytes,
    per-step deterministic free lists, and slot-inheritance donation
    hints;
  * consumers: the executor drives its env frees from the plan (each
    tensor dropped at its planned last use goes back to PyTorch's
    caching allocator, which reuses it), ``PlanReport`` gains
    ``peak_bytes`` / ``peak_bytes_hoisted`` / ``buffer_slots``, and
    :mod:`repro_torch.core.slicing` uses the planned peak to *stop slicing
    early* — the width proxy must assume several width-sized tensors are
    live at once, so bounding the true peak admits strictly smaller
    slicing sets (fewer ``2^|S|`` subtasks, Eq. 4) at the same byte
    budget.

On the GPU PyTorch's caching allocator performs the actual reuse; the
plan's role is to *prove the bound at planning time* (and to schedule frees/donations
deterministically) so the slicer can trust it before anything executes.
"""

from __future__ import annotations

import dataclasses

from ..core.contraction_tree import ContractionTree
from ..core.lifetime import step_lifetimes
from ..core.tensor_network import bits
from .partition import partition_tree


def node_nbytes(
    tree: ContractionTree, v: int, smask: int, itemsize: int
) -> int:
    """Bytes of the buffer node ``v`` materializes under slicing mask
    ``S`` (sliced indices are fixed before execution, so they contribute
    no extent)."""
    size = 1
    labels = tree.tn.space.labels
    for b in bits(tree.emask[v] & ~smask):
        size *= tree.tn.size_of(labels[b])
    return size * itemsize


def _nbytes_map(
    tree: ContractionTree,
    smask: int,
    itemsize: int,
    itemsize_of: dict[int, int] | None,
) -> dict[int, int]:
    """Per-node buffer bytes, dtype-true under mixed precision:
    ``itemsize_of`` (from :func:`repro_torch.lowering.precision.
    storage_itemsizes`) overrides the uniform ``itemsize`` for nodes the
    precision planner stores as bf16 component pairs."""
    return {
        v: node_nbytes(
            tree, v, smask,
            itemsize_of.get(v, itemsize) if itemsize_of else itemsize,
        )
        for v in tree.emask
    }


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Static buffer plan for one execution segment.

    ``steps`` are ``(lhs, rhs, out)`` node ids in execution order.
    ``entry`` buffers are resident from the start (leaf arrays / hoisted
    frontier); ``pinned`` entries additionally survive the whole segment
    (the hoisted buffers are captured constants reused by every slice, so
    their bytes count at every step and their storage is never
    reusable).  ``slot_of`` maps every non-pinned buffer to a slot id;
    buffers sharing a slot have disjoint lifetimes, so
    ``sum(slot_bytes) + pinned`` is an executable upper bound on
    ``peak_bytes`` (the exact live-set maximum)."""

    name: str
    entry: tuple[int, ...]
    pinned: tuple[int, ...]
    steps: tuple[tuple[int, int, int], ...]
    outputs: tuple[int, ...]
    nbytes: dict[int, int]
    peak_bytes: int
    peak_step: int  # step index of the peak (-1: the entry state)
    slot_of: dict[int, int]
    slot_bytes: tuple[int, ...]
    frees: dict[int, tuple[int, ...]]  # out node -> env keys dead after it
    donations: dict[int, int]  # out node -> slot id inherited from a freed buffer

    @property
    def n_slots(self) -> int:
        return len(self.slot_bytes)

    @property
    def pinned_bytes(self) -> int:
        return sum(self.nbytes[v] for v in self.pinned)

    def slot_total_bytes(self) -> int:
        return sum(self.slot_bytes) + self.pinned_bytes


def _plan_segment(
    name: str,
    entry: tuple[int, ...],
    pinned: tuple[int, ...],
    steps: tuple[tuple[int, int, int], ...],
    outputs: tuple[int, ...],
    nbytes: dict[int, int],
) -> SegmentPlan:
    """One sweep over the segment: exact live-set peak, linear-scan slot
    assignment, free schedule, donation hints."""
    birth, death = step_lifetimes(list(steps), entry, outputs)
    pinned_set = set(pinned)
    end = len(steps)

    slots: list[int] = []  # slot id -> slot bytes (max over occupants)
    free_slots: list[int] = []
    slot_of: dict[int, int] = {}

    def take_slot(need: int) -> tuple[int, bool]:
        if free_slots:
            # best fit: the free slot that already holds `need` with the
            # least waste, else the one needing the least growth
            sid = min(
                free_slots,
                key=lambda s: (slots[s] < need, abs(slots[s] - need)),
            )
            free_slots.remove(sid)
            slots[sid] = max(slots[sid], need)
            return sid, True
        slots.append(need)
        return len(slots) - 1, False

    for v in entry:
        if v not in pinned_set:
            slot_of[v], _ = take_slot(nbytes[v])

    cur = sum(nbytes[v] for v in entry)
    peak, peak_step = cur, -1
    frees: dict[int, tuple[int, ...]] = {}
    donations: dict[int, int] = {}
    for t, (lhs, rhs, out) in enumerate(steps):
        # the output is allocated while both inputs are still resident
        # (no in-place GEMM), so it may only inherit a slot freed at a
        # *strictly earlier* step — exactly what free_slots holds here.
        sid, reused = take_slot(nbytes[out])
        slot_of[out] = sid
        if reused:
            donations[out] = sid
        cur += nbytes[out]
        if cur > peak:
            peak, peak_step = cur, t
        dead = []
        for u in (lhs, rhs):
            if death.get(u) == t and u not in pinned_set:
                cur -= nbytes[u]
                dead.append(u)
                free_slots.append(slot_of[u])
        frees[out] = tuple(dead)

    # sanity: what remains live is exactly the outputs + pinned + any
    # never-consumed entry
    expect = sum(
        nbytes[v] for v in birth if death[v] >= end and v not in pinned_set
    ) + sum(nbytes[v] for v in pinned_set)
    assert cur == expect, (name, cur, expect)
    return SegmentPlan(
        name=name,
        entry=tuple(entry),
        pinned=tuple(pinned),
        steps=tuple(steps),
        outputs=tuple(outputs),
        nbytes=dict(nbytes),
        peak_bytes=peak,
        peak_step=peak_step,
        slot_of=slot_of,
        slot_bytes=tuple(slots),
        frees=frees,
        donations=donations,
    )


def chain_segment_plan(
    name: str,
    entry,
    steps,
    outputs,
    nbytes: dict[int, int],
) -> SegmentPlan:
    """Chain-local buffer plan for a fused-GEMM run (the epilogue
    kernel, :func:`repro_torch.kernels.contract_gemm.chain_gemm`).

    Runs the same linear-scan allocator as :func:`plan_memory`'s
    segments over just the chained steps, with every ``entry`` buffer
    *pinned*: the chain kernel reads whole operands for the duration of
    the chain, so only the chain-interior intermediates compete for
    scratch slots.  The returned :class:`SegmentPlan`'s ``peak_bytes`` is
    therefore the certified live set of one chain execution (operands +
    intermediates + output), and ``slot_of``/``slot_bytes`` are the
    scratch-slot assignment the kernel's workspace is laid out by."""
    return _plan_segment(
        name, tuple(entry), tuple(entry), tuple(steps), tuple(outputs),
        dict(nbytes),
    )


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """Lifetime-derived buffer plan for one ``(tree, S)`` pair.

    ``naive`` covers the full-tree-per-slice program; ``prologue`` /
    ``epilogue`` cover the two-phase split (``None`` when ``S`` is empty
    or the tree has no steps).  All byte figures are per *subtask* —
    the executor's slice-batch ``vmap`` multiplies every non-pinned
    epilogue term by the batch size (see :meth:`epilogue_peak`)."""

    itemsize: int
    smask: int
    naive: SegmentPlan
    prologue: SegmentPlan | None
    epilogue: SegmentPlan | None

    @property
    def peak_bytes(self) -> int:
        """Exact live-set peak of the naive full-tree subtask."""
        return self.naive.peak_bytes

    @property
    def peak_bytes_hoisted(self) -> int:
        """Peak footprint of two-phase execution: the prologue runs
        first (full, unsliced invariant tensors), then every epilogue
        subtask runs with the hoisted frontier pinned."""
        if self.prologue is None or self.epilogue is None:
            return self.naive.peak_bytes
        return max(self.prologue.peak_bytes, self.epilogue.peak_bytes)

    @property
    def buffer_slots(self) -> int:
        """Linear-scan slot count of the naive segment — how many
        physical buffers a static allocator needs for the whole subtask
        (vs one per tree node for a no-reuse executor)."""
        return self.naive.n_slots

    def epilogue_peak(self, slice_batch: int = 1) -> int:
        """Per-scan-step peak of the vmapped epilogue: pinned hoisted
        buffers are shared across the batch, everything else scales."""
        seg = self.epilogue if self.epilogue is not None else self.naive
        pinned = seg.pinned_bytes
        return pinned + slice_batch * (seg.peak_bytes - pinned)

    def segment_for(self, name: str) -> SegmentPlan | None:
        return {
            "naive": self.naive,
            "prologue": self.prologue,
            "epilogue": self.epilogue,
        }[name]

    def summary(self) -> dict:
        return {
            "itemsize": self.itemsize,
            "peak_bytes": self.peak_bytes,
            "peak_bytes_hoisted": self.peak_bytes_hoisted,
            "buffer_slots": self.buffer_slots,
            "naive_slot_bytes": self.naive.slot_total_bytes(),
            "prologue_peak_bytes": (
                self.prologue.peak_bytes if self.prologue else 0
            ),
            "epilogue_peak_bytes": (
                self.epilogue.peak_bytes if self.epilogue else 0
            ),
        }


def plan_memory(
    tree: ContractionTree,
    smask: int = 0,
    itemsize: int = 8,
    hoist: bool = True,
    part=None,
    itemsize_of: dict[int, int] | None = None,
) -> MemoryPlan:
    """Build the lifetime-based :class:`MemoryPlan` for ``(tree, S)``.

    Pure planner algebra — no arrays are touched, so the slicer can call
    this inside its search loop.  ``itemsize`` is the execution dtype's
    width (8 for complex64); ``itemsize_of`` overrides it per node under
    a mixed-precision plan (bf16-stored nodes at half width), making the
    certified peaks dtype-true.  ``hoist=False`` skips the prologue/
    epilogue segments; ``part`` reuses a caller-held
    :class:`~repro_torch.lowering.partition.TreePartition` for the same
    ``(tree, smask)`` instead of recomputing it."""
    order = tree.contract_order()
    steps = tuple((*tree.children[v], v) for v in order)
    n_leaves = tree.tn.num_tensors
    nbytes = _nbytes_map(tree, smask, itemsize, itemsize_of)
    root = (tree.root,)
    naive = _plan_segment(
        "naive", tuple(range(n_leaves)), (), steps, root, nbytes
    )
    prologue = epilogue = None
    if hoist and smask and steps:
        if part is None:
            part = partition_tree(tree, smask)
        assert part.smask == smask
        # prologue consumes the full (unsliced) leaf arrays — but every
        # invariant node's mask is disjoint from S by construction, so
        # the sliced byte formula is already exact for them.
        pro_steps = tuple(
            (*tree.children[v], v) for v in part.invariant_nodes
        )
        if pro_steps:
            prologue = _plan_segment(
                "prologue", part.prologue_leaves, (), pro_steps,
                part.hoisted_nodes, nbytes,
            )
        epi_steps = tuple(
            (*tree.children[v], v) for v in part.epilogue_nodes
        )
        epilogue = _plan_segment(
            "epilogue",
            part.epilogue_leaves + part.hoisted_nodes,
            part.hoisted_nodes,
            epi_steps,
            root,
            nbytes,
        )
    return MemoryPlan(
        itemsize=itemsize,
        smask=smask,
        naive=naive,
        prologue=prologue,
        epilogue=epilogue,
    )


def certified_peak(
    tree: ContractionTree,
    smask: int = 0,
    itemsize: int = 8,
    part=None,
    itemsize_of: dict[int, int] | None = None,
) -> int:
    """The certified live-set peak for ``(tree, S)``: the worst case over
    the naive full-tree subtask and the hoisted prologue/epilogue pair —
    i.e. ``max(MemoryPlan.peak_bytes, MemoryPlan.peak_bytes_hoisted)`` —
    computed *without* slot assignment or free schedules.

    This is the byte-budget objective of the peak-aware slicer and the
    anytime co-optimizer (:mod:`repro_torch.optimize`), which call it once per
    candidate inside their search loops; skipping the allocator sweep
    keeps that evaluation cheap while matching :func:`plan_memory`'s
    peaks exactly (property-tested).  ``part`` reuses a caller-held
    partition for the same ``(tree, smask)``; ``itemsize_of`` makes the
    peak dtype-true under a mixed-precision plan."""
    order = tree.contract_order()
    steps = [(*tree.children[v], v) for v in order]
    nbytes = _nbytes_map(tree, smask, itemsize, itemsize_of)

    def seg_peak(entry, seg_steps, outputs, pinned=()):
        birth, death = step_lifetimes(list(seg_steps), entry, outputs)
        pinned_set = set(pinned)
        cur = sum(nbytes[v] for v in entry)
        peak = cur
        for t, (lhs, rhs, out) in enumerate(seg_steps):
            cur += nbytes[out]
            if cur > peak:
                peak = cur
            for u in (lhs, rhs):
                if death.get(u) == t and u not in pinned_set:
                    cur -= nbytes[u]
        return peak

    root = (tree.root,)
    peak = seg_peak(tuple(range(tree.tn.num_tensors)), steps, root)
    if not smask or not steps:
        return peak
    if part is None:
        part = partition_tree(tree, smask)
    pro_steps = [(*tree.children[v], v) for v in part.invariant_nodes]
    if pro_steps:
        peak = max(
            peak,
            seg_peak(part.prologue_leaves, pro_steps, part.hoisted_nodes),
        )
    epi_steps = [(*tree.children[v], v) for v in part.epilogue_nodes]
    peak = max(
        peak,
        seg_peak(
            part.epilogue_leaves + part.hoisted_nodes,
            epi_steps,
            root,
            pinned=part.hoisted_nodes,
        ),
    )
    return peak


def peak_bytes(
    tree: ContractionTree,
    smask: int,
    itemsize: int = 8,
    hoist: bool = False,
) -> int:
    """Planned live-set peak for ``(tree, S)`` — the quantity the
    peak-aware slicer bounds.  Defaults to the naive segment's peak: it
    is monotone in ``S`` (removing a sliced index only grows tensors on
    its lifetime), which is what makes the slicer's prune loop sound."""
    plan = plan_memory(tree, smask, itemsize, hoist=hoist)
    return plan.peak_bytes_hoisted if hoist else plan.peak_bytes
