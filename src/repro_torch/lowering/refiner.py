"""Adaptive tile refiner — the paper's Sec. V-B path refiner, priced on the
card the port runs on.

The refiner makes three per-node decisions over the normalized
:class:`~repro_torch.lowering.gemm_form.GemmForm` of every contraction
step:

  1. **backend** — the hand-written tiled GEMM kernel (``tiled``) or the
     fused transpose-GEMM kernel (``fused``) for kernel-sized GEMMs,
     ``torch.matmul`` (``dot``) for sub-tile shapes where tile
     quantization would dominate, plain ``torch.einsum`` for tiny or
     degenerate nodes where even the transpose/reshape plumbing costs
     more than the contraction;
  2. **block shapes** — (bm, bn, bk) from the card's block ladder, under
     the per-block on-chip working-set budget;
  3. **pad-vs-split** — for each candidate the model charges the padded
     FLOPs ``ceil(M/bm)·ceil(N/bn)·ceil(K/bk)`` tiles actually execute;
     the candidate with the lower modeled time wins.

The constants (peak rate, memory rate, tile edge, block ladder, budgets)
come from a :class:`~repro_torch.hardware.Hardware` object, default
:data:`~repro_torch.hardware.H100_SXM`.  The same per-node cost model is
summed into ``LoweredSchedule.modeled_time_s``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Hashable, Sequence

import torch

from ..hardware import DEFAULT_HARDWARE, Hardware
from .gemm_form import GemmForm, lower_step, real_component_bytes

KERNEL_BACKENDS = ("tiled", "fused")


def suffix_tile_split(shape: tuple[int, ...], target: int) -> tuple[int, int, int]:
    """Split a role group's dims into (grid prefix, tile suffix).

    Returns ``(n_prefix, grid, tile)``: the longest suffix of ``shape``
    whose product stays ``<= target`` becomes the tile (``tile`` = its
    product); the remaining prefix axes are enumerated by the grid
    (``grid`` = their product).  The boundary sits on an axis boundary,
    so every tile is an exact rectangular block of the operand's native
    layout."""
    tile = 1
    j = len(shape)
    while j > 0 and tile * shape[j - 1] <= target:
        j -= 1
        tile *= shape[j]
    grid = 1
    for d in shape[:j]:
        grid *= d
    return j, grid, tile


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a numpy-style name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class GemmSpec:
    """Refined, executable lowering of one contraction step.

    For ``backend="fused"`` the block shapes are the *effective*
    axis-suffix tiles (see :func:`suffix_tile_split`), which divide
    (B, M, N, K) exactly — no padding FLOPs, no materialized operand
    transpose.  ``transpose_bytes`` is the HBM permute traffic
    this spec pays (0 for fused/einsum — the fused saving is what
    ``LoweredSchedule.transpose_bytes_eliminated`` totals up).
    """

    form: GemmForm
    backend: str  # "tiled" | "fused" | "dot" | "einsum"
    bm: int
    bn: int
    bk: int
    modeled_time_s: float
    pad_waste: float  # fraction of executed kernel FLOPs that are padding
    transpose_bytes: float = 0.0  # HBM bytes moved permuting the operands
    precision: str = "fp32"  # "fp32" | "bf16" (bf16-input/fp32-accumulate)


def precision_itemsize(dtype, precision: str = "fp32") -> int:
    """Storage bytes per element at ``precision``: half the native width
    when the element's real components are held as bf16 (complex64 → a
    bf16 pair = 4 bytes, float32 → 2 bytes), the native width for fp32."""
    itemsize = as_dtype(dtype).itemsize
    return max(1, itemsize // 2) if precision == "bf16" else itemsize


def operand_transpose_bytes(
    form: GemmForm, dtype, precision: str = "fp32"
) -> float:
    """Device-memory traffic of materializing the operand permutations:
    one read + one write per operand whose native layout is not already
    in GEMM order — the ``2*(|A|+|B|)*bytes`` the fused kernel
    eliminates.  Operands consumed at bf16 are permuted at their (halved)
    storage width."""
    itemsize = precision_itemsize(dtype, precision)
    t = 0.0
    if form.perm_a != tuple(range(len(form.perm_a))):
        t += 2.0 * itemsize * form.B * form.M * form.K
    if form.perm_b != tuple(range(len(form.perm_b))):
        t += 2.0 * itemsize * form.B * form.K * form.N
    return t


def _ceil_to(x: float, t: int) -> float:
    return max(t, math.ceil(x / t) * t)


def _real_gemm_count(dtype, backend: str) -> int:
    """Real GEMMs per logical GEMM as the cost model charges them:
    Karatsuba on the tiled kernel runs 3, every other complex backend is
    charged 4, real dtypes run 1 (the reference's rule, kept so the same
    constants give the same schedule)."""
    if not as_dtype(dtype).is_complex:
        return 1
    return 3 if backend == "tiled" else 4


def step_traffic_bytes(
    form: GemmForm, dtype, precision: str = "fp32"
) -> float:
    """Modeled device-memory operand + output bytes for one execution of
    the step (excluding any transpose round-trip): inputs at their
    storage precision, the output at the full width (the kernels
    accumulate in fp32)."""
    itemsize = as_dtype(dtype).itemsize
    in_item = precision_itemsize(dtype, precision)
    return float(form.B) * (
        in_item * (form.M * form.K + form.K * form.N)
        + itemsize * form.M * form.N
    )


def modeled_step_time(
    form: GemmForm,
    dtype,
    backend: str,
    bm: int,
    bn: int,
    bk: int,
    hw: Hardware = DEFAULT_HARDWARE,
    precision: str = "fp32",
) -> tuple[float, float]:
    """(seconds, pad_waste) for one execution of this step.

    ``tiled`` is charged padded-tile FLOPs at the kernels' peak; the
    fused transpose-GEMM executes exact FLOPs (axis-suffix tiles never
    pad); dot/einsum are charged exact FLOPs at the non-kernel effective
    peak.  All are capped by the memory roofline on the operand + output
    traffic — and the backends that materialize permuted operand copies
    (``tiled``, ``dot``) additionally pay the ``2*(|A|+|B|)*bytes``
    transpose traffic that the fused kernel (and einsum) eliminates: a
    separate round-trip before the GEMM proper.

    ``precision="bf16"`` prices the kernel backends at
    ``hw.bf16_peak_flops`` and halves the operand-side traffic (bf16
    inputs, fp32 accumulation, full-width output).
    """
    n_real = _real_gemm_count(dtype, backend)
    flops = form.flops * n_real
    t_mem = step_traffic_bytes(form, dtype, precision) / hw.mem_bw
    peak = hw.bf16_peak_flops if precision == "bf16" else hw.peak_flops
    if backend == "tiled":
        padded = (
            2.0
            * form.B
            * _ceil_to(form.M, bm)
            * _ceil_to(form.N, bn)
            * _ceil_to(form.K, bk)
            * n_real
        )
        t_compute = padded / peak
        waste = 1.0 - flops / padded
    elif backend == "fused":
        t_compute = flops / peak
        waste = 0.0
    else:
        t_compute = flops / (hw.peak_flops * hw.non_kernel_peak_fraction)
        waste = 0.0
    t = max(t_compute, t_mem)
    if backend in ("tiled", "dot"):
        t += operand_transpose_bytes(form, dtype, precision) / hw.mem_bw
    return t, waste


def refine_step(
    form: GemmForm,
    dtype,
    *,
    min_kernel_dim: int | None = None,
    fused: bool = True,
    hw: Hardware = DEFAULT_HARDWARE,
    precision: str = "fp32",
) -> GemmSpec:
    """Pick backend + block shapes for one normalized contraction step.

    ``min_kernel_dim`` defaults to the kernels' tile edge ``hw.tile``.
    ``fused`` gates the fused transpose-GEMM candidates; ``fused=False``
    is the switch back to the materialized permute + tiled kernel path.
    A fused candidate is admissible when its effective axis-suffix tiles
    are still kernel-sized — its cost model pays no padding FLOPs and no
    operand transpose traffic, so it wins whenever admissible and
    strictly cheaper.

    ``precision="bf16"`` refines the step under the bf16-input/
    fp32-accumulate model: the working-set check counts 2-byte operand
    components (the fp32 accumulator tile stays 4-byte), and the cost
    model prices the bf16 rate and half the operand traffic.  Only the
    kernel backends carry the precision — dot/einsum fallbacks always
    execute fp32.
    """
    if min_kernel_dim is None:
        min_kernel_dim = hw.tile
    real_bytes = real_component_bytes(as_dtype(dtype))
    if form.flops < hw.einsum_flops_floor:
        t, w = modeled_step_time(form, dtype, "einsum", 1, 1, 1, hw)
        return GemmSpec(form, "einsum", 0, 0, 0, t, w)
    # 64-bit components (float64 / complex128) would be silently
    # truncated by the fp32 kernels — keep them on the library's matmul.
    if min(form.M, form.N, form.K) < min_kernel_dim or real_bytes > 4:
        t, w = modeled_step_time(form, dtype, "dot", 1, 1, 1, hw)
        return GemmSpec(
            form, "dot", 0, 0, 0, t, w, operand_transpose_bytes(form, dtype)
        )
    # per-component operand bytes at the requested precision; the fp32
    # accumulator/output tile is always 4-byte
    ob = 2 if precision == "bf16" else real_bytes
    best: GemmSpec | None = None
    tbytes = operand_transpose_bytes(form, dtype, precision)
    budget = hw.tile_budget_bytes
    for bm in hw.block_candidates:
        for bn in hw.block_candidates:
            for bk in hw.block_candidates:
                if ob * (bm * bk + bk * bn) + 4 * bm * bn > budget:
                    continue  # working set must fit one block's budget
                t, w = modeled_step_time(
                    form, dtype, "tiled", bm, bn, bk, hw, precision
                )
                if best is None or t < best.modeled_time_s:
                    best = GemmSpec(
                        form, "tiled", bm, bn, bk, t, w, tbytes, precision
                    )
                if not fused:
                    continue
                # fused candidate at the same targets: effective tiles are
                # the axis-suffix products, admissible while kernel-sized
                _, _, tm = suffix_tile_split(form.m_shape, bm)
                _, _, tn = suffix_tile_split(form.n_shape, bn)
                _, _, tk = suffix_tile_split(form.k_shape, bk)
                if min(tm, tn, tk) < min_kernel_dim:
                    continue
                if ob * (tm * tk + tk * tn) + 4 * tm * tn > budget:
                    continue
                tf, wf = modeled_step_time(
                    form, dtype, "fused", tm, tn, tk, hw, precision
                )
                if tf < best.modeled_time_s:
                    best = GemmSpec(
                        form, "fused", tm, tn, tk, tf, wf, 0.0, precision
                    )
    return best


@dataclasses.dataclass
class LoweredSchedule:
    """Refined kernel schedule for every step of a ContractionPlan.

    ``precision_mode``/``fidelity_tol``/``predicted_amp_error`` record
    the mixed-precision assignment (see :mod:`repro_torch.lowering.
    precision`): the mode the plan was built under, the XEB-fidelity
    budget it was certified against, and the error model's accumulated
    relative amplitude error over the bf16 steps.  All default to the
    pure-fp32 schedule."""

    specs: list[GemmSpec]
    dtype: torch.dtype
    precision_mode: str = "fp32"
    fidelity_tol: float = 0.0
    predicted_amp_error: float = 0.0

    @property
    def modeled_time_s(self) -> float:
        """Modeled seconds for one slice (sum over steps)."""
        return sum(s.modeled_time_s for s in self.specs)

    def backend_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for s in self.specs:
            counts[s.backend] = counts.get(s.backend, 0) + 1
        return counts

    def precision_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for s in self.specs:
            counts[s.precision] = counts.get(s.precision, 0) + 1
        return counts

    def pad_waste(self) -> float:
        """FLOPs-weighted padding fraction across the tiled nodes."""
        useful = padded = 0.0
        for s in self.specs:
            if s.backend != "tiled":
                continue
            f = s.form.flops
            useful += f
            padded += f / (1.0 - s.pad_waste) if s.pad_waste < 1.0 else f
        return 0.0 if padded == 0.0 else 1.0 - useful / padded

    def transpose_bytes_eliminated(self) -> float:
        """Operand-transpose traffic the fused nodes avoid (per slice):
        what the permute + tiled kernel path would have moved for every
        ``fused`` node."""
        return sum(
            operand_transpose_bytes(s.form, self.dtype)
            for s in self.specs
            if s.backend == "fused"
        )

    def summary_row(self) -> str:
        """One-line schedule summary (the reference's row, under the
        port's backend names)."""
        c = self.backend_counts()
        per = " ".join(
            f"{k}={c[k]}" for k in ("fused", "tiled", "dot", "einsum") if k in c
        )
        pc = self.precision_counts()
        prec = (
            f" bf16={pc['bf16']}/{len(self.specs)}"
            f" amp_err={self.predicted_amp_error:.2e}"
            if pc.get("bf16")
            else ""
        )
        dtype = str(self.dtype).removeprefix("torch.")
        return (
            f"lowered[{dtype}]: {len(self.specs)} nodes ({per}) "
            f"pad_waste={self.pad_waste()*100:.1f}% "
            f"t_model={self.modeled_time_s:.3e}s/slice{prec}"
        )


def refine_schedule(
    steps: Sequence[tuple[Sequence, Sequence, Sequence]],
    size_of: Callable[[Hashable], int],
    dtype=torch.complex64,
    *,
    min_kernel_dim: int | None = None,
    fused: bool = True,
    hw: Hardware = DEFAULT_HARDWARE,
) -> LoweredSchedule:
    """Lower + refine every ``(inds_a, inds_b, inds_out)`` step."""
    specs = [
        refine_step(
            lower_step(ia, ib, io, size_of), dtype,
            min_kernel_dim=min_kernel_dim, fused=fused, hw=hw,
        )
        for ia, ib, io in steps
    ]
    return LoweredSchedule(specs, as_dtype(dtype))


def refine_tree_schedule(
    tree,
    smask: int = 0,
    dtype=torch.complex64,
    *,
    min_kernel_dim: int | None = None,
    fused: bool = True,
    hw: Hardware = DEFAULT_HARDWARE,
) -> LoweredSchedule:
    """Refine the kernel schedule for every step of ``(tree, S)``
    directly from the contraction tree — planner-side usage on instances
    too large to instantiate an executor plan for.  Mirrors the
    executor's step construction: sliced indices are fixed before
    lowering, the output index order follows ``pair_contract_inds``."""
    from ..core.executor import pair_contract_inds  # lazy: avoid cycle
    from ..core.tensor_network import bits

    space = tree.tn.space
    sliced_labels = {space.labels[b] for b in bits(smask)}
    open_set = frozenset(tree.tn.open_inds)
    node_inds = {
        i: tuple(ix for ix in tree.tn.inputs[i] if ix not in sliced_labels)
        for i in range(tree.tn.num_tensors)
    }
    steps = []
    for v in tree.contract_order():
        l, r = tree.children[v]
        _, out = pair_contract_inds(node_inds[l], node_inds[r], open_set)
        steps.append((node_inds[l], node_inds[r], out))
        node_inds[v] = out
    return refine_schedule(
        steps, tree.tn.size_of, dtype=dtype,
        min_kernel_dim=min_kernel_dim, fused=fused, hw=hw,
    )


# ----------------------------------------------------------------------
# fusion-boundary pass: greedy chain growth along the schedule (the chain
# kernel's planning half)
# ----------------------------------------------------------------------

# batch cells of one chain step; the cap keeps open-batch sampling
# networks' chain steps to a bounded number of output tiles per cell
CHAIN_MAX_BATCH = 256


@dataclasses.dataclass(frozen=True)
class FusedChainSpec:
    """One planned GEMM chain.

    ``positions`` are consecutive entries of one execution segment's step
    sequence (never crossing the prologue/epilogue boundary — chains are
    planned per segment); step ``t``'s carry operand is step ``t-1``'s
    output (``carry_side[t]`` ∈ {"l", "r"}, ``""`` at the head).
    ``external_nodes`` are the env keys the executor gathers as kernel
    operands (step 0's pair, then one non-carry operand per step);
    ``slot_ids``/``slot_elems`` are the workspace-slot assignment of the
    interior intermediates from the chain-local linear scan
    (:func:`repro_torch.lowering.memory.chain_segment_plan`), and
    ``live_bytes`` is that scan's certified live set.

    The saved-traffic accounting keeps the two eliminations disjoint so
    nothing is double-charged: ``roundtrip_bytes_saved`` is the plain
    write+read of each interior intermediate, while
    ``transpose_bytes_saved`` is only the *extra* permute-copy traffic
    the unfused backends would have paid (``GemmSpec.transpose_bytes``,
    already zero on fused/einsum steps).
    """

    segment: str
    positions: tuple[int, ...]
    nodes: tuple[tuple[int, int, int], ...]  # (lhs, rhs, out) env keys
    carry_side: tuple[str, ...]
    external_nodes: tuple[int, ...]
    out_node: int
    live_bytes: int
    slot_ids: tuple[int, ...]
    slot_elems: tuple[int, ...]
    roundtrip_bytes_saved: float
    transpose_bytes_saved: float
    # per-slot storage precision: "bf16" when every interior intermediate
    # assigned to the slot is consumed at bf16 (the slot then holds bf16
    # (re, im) pairs at half the bytes), "fp32" otherwise; empty means
    # all-fp32
    slot_prec: tuple[str, ...] = ()

    @property
    def n_steps(self) -> int:
        return len(self.positions)

    @property
    def hbm_bytes_saved(self) -> float:
        """Modeled device-memory bytes one execution of this chain avoids."""
        return self.roundtrip_bytes_saved + self.transpose_bytes_saved


@dataclasses.dataclass
class ChainPlan:
    """All fused chains planned for one ``(tree, S)`` schedule."""

    chains: tuple[FusedChainSpec, ...]
    vmem_budget: int

    def by_segment(self, name: str) -> dict[int, FusedChainSpec]:
        """start position → chain, for one segment's dispatch loop."""
        return {
            c.positions[0]: c for c in self.chains if c.segment == name
        }

    def segment_chains(self, name: str) -> list[FusedChainSpec]:
        return [c for c in self.chains if c.segment == name]

    @property
    def num_multi(self) -> int:
        """Chains fusing ≥ 2 steps (all of them, per the planner's
        ``min_len`` — kept explicit for reporting/regression gates)."""
        return sum(1 for c in self.chains if c.n_steps >= 2)

    def max_live_bytes(self) -> int:
        return max((c.live_bytes for c in self.chains), default=0)

    def hbm_bytes_saved(self, segment: str = "naive") -> float:
        """Modeled bytes saved per execution of ``segment`` (for the
        epilogue that is once per slice)."""
        return sum(
            c.hbm_bytes_saved for c in self.chains if c.segment == segment
        )


def _chainable(spec: GemmSpec, real_bytes: int) -> bool:
    """Whether one step may participate in a fused chain: fp32-component
    dtypes only (the kernel accumulates in fp32), at least one axis per
    operand/output (the refiner's degenerate scalar nodes stay unfused),
    bounded batch.  The step's backend is not consulted: einsum and dot
    steps chain too, as in the reference."""
    f = spec.form
    return (
        real_bytes <= 4
        and len(f.inds_a) >= 1
        and len(f.inds_b) >= 1
        and len(f.inds_out) >= 1
        and f.B <= CHAIN_MAX_BATCH
    )


def _build_chain(
    segment: str,
    run: list[int],
    step_nodes,
    specs,
    nbytes: dict[int, int],
    itemsize: int,
    itemsize_of: dict[int, int] | None = None,
):
    """Assemble the FusedChainSpec for one candidate run of schedule
    positions.  Returns ``(spec, live_bytes)``.

    ``itemsize_of`` maps env keys to their *storage* itemsize when the
    precision planner stores some nodes as bf16 component pairs;
    ``nbytes`` is then precision-aware, and the slot element counts
    divide by each node's own itemsize."""
    from .memory import chain_segment_plan  # lazy: avoid cycle

    def isz(v: int) -> int:
        return itemsize_of.get(v, itemsize) if itemsize_of else itemsize

    nodes = tuple(step_nodes[p] for p in run)
    carry_side = [""]
    externals = [nodes[0][0], nodes[0][1]]
    for t in range(1, len(nodes)):
        prev_out = nodes[t - 1][2]
        l, r, _ = nodes[t]
        if l == prev_out:
            carry_side.append("l")
            externals.append(r)
        else:
            carry_side.append("r")
            externals.append(l)
    out_node = nodes[-1][2]
    seg = chain_segment_plan(
        f"chain:{segment}:{run[0]}", tuple(externals), nodes, (out_node,),
        nbytes,
    )
    interior = [nodes[t][2] for t in range(len(nodes) - 1)]
    used = sorted({seg.slot_of[v] for v in interior})
    remap = {s: d for d, s in enumerate(used)}
    slot_ids = tuple(remap[seg.slot_of[v]] for v in interior)
    slot_elems = [0] * len(used)
    slot_wide = [False] * len(used)
    for t, v in enumerate(interior):
        d = remap[seg.slot_of[v]]
        slot_elems[d] = max(slot_elems[d], nbytes[v] // isz(v))
        # the consuming step (t+1 within the run) fixes the interior's
        # storage precision; a slot is bf16 only if no occupant needs fp32
        if specs[run[t + 1]].precision != "bf16":
            slot_wide[d] = True
    roundtrip = sum(2.0 * nbytes[v] for v in interior)
    transpose = sum(specs[p].transpose_bytes for p in run)
    spec = FusedChainSpec(
        segment=segment,
        positions=tuple(run),
        nodes=nodes,
        carry_side=tuple(carry_side),
        external_nodes=tuple(externals),
        out_node=out_node,
        live_bytes=seg.peak_bytes,
        slot_ids=slot_ids,
        slot_elems=tuple(slot_elems),
        roundtrip_bytes_saved=roundtrip,
        transpose_bytes_saved=transpose,
        slot_prec=tuple("fp32" if wide else "bf16" for wide in slot_wide),
    )
    return spec, seg.peak_bytes


def plan_chains(
    schedule: LoweredSchedule,
    step_nodes: Sequence[tuple[int, int, int]],
    segments: dict[str, tuple[int, ...]],
    nbytes: dict[int, int],
    *,
    vmem_budget: int | None = None,
    min_len: int = 2,
    hw: Hardware = DEFAULT_HARDWARE,
    itemsize_of: dict[int, int] | None = None,
) -> ChainPlan:
    """The fusion-boundary pass: greedily grow runs of adjacent steps
    along each segment's execution order while the certified live set —
    whole operands pinned, intermediates slot-assigned by the chain-local
    linear scan — fits the chain budget.

    ``vmem_budget`` (the reference's name for the chain budget) defaults
    to ``hw.chain_budget_bytes``: on the card a chain's carries live in a
    device workspace that should stay in L2 between steps.
    ``step_nodes[p]`` are the ``(lhs, rhs, out)`` env keys of schedule
    position ``p``; ``segments`` maps each execution segment to its
    ordered positions, so a chain can never cross the prologue/epilogue
    boundary, and a segment *output* (the root, or a hoisted frontier
    buffer) can never be chain-interior.  ``nbytes`` is the per-node
    buffer size from the memory plan: dtype-true under a mixed-precision
    plan, with ``itemsize_of`` giving each node's storage itemsize."""
    if vmem_budget is None:
        vmem_budget = hw.chain_budget_bytes
    itemsize = schedule.dtype.itemsize
    real_bytes = real_component_bytes(schedule.dtype)
    chains: list[FusedChainSpec] = []
    for name, positions in segments.items():
        i = 0
        while i < len(positions):
            p = positions[i]
            if not _chainable(schedule.specs[p], real_bytes):
                i += 1
                continue
            run = [p]
            j = i
            while j + 1 < len(positions):
                q = positions[j + 1]
                prev_out = step_nodes[run[-1]][2]
                if (
                    step_nodes[q][0] != prev_out
                    and step_nodes[q][1] != prev_out
                ):
                    break
                if not _chainable(schedule.specs[q], real_bytes):
                    break
                _, live = _build_chain(
                    name, run + [q], step_nodes, schedule.specs, nbytes,
                    itemsize, itemsize_of,
                )
                if live > vmem_budget:
                    break
                run.append(q)
                j += 1
            if len(run) >= min_len:
                spec, _ = _build_chain(
                    name, run, step_nodes, schedule.specs, nbytes, itemsize,
                    itemsize_of,
                )
                chains.append(spec)
            i = j + 1
    return ChainPlan(chains=tuple(chains), vmem_budget=vmem_budget)


def plan_tree_chains(
    tree,
    smask: int = 0,
    dtype=torch.complex64,
    *,
    hoist: bool = True,
    fused: bool = True,
    vmem_budget: int | None = None,
    hw: Hardware = DEFAULT_HARDWARE,
) -> ChainPlan:
    """Planner-side chain plan for ``(tree, S)`` — the same pass the
    executor runs at plan construction, built directly from the tree."""
    from .memory import node_nbytes  # lazy: avoid cycle

    sched = refine_tree_schedule(tree, smask, dtype=dtype, fused=fused, hw=hw)
    order = tree.contract_order()
    step_nodes = tuple((*tree.children[v], v) for v in order)
    itemsize = as_dtype(dtype).itemsize
    nbytes = {
        v: node_nbytes(tree, v, smask, itemsize) for v in tree.emask
    }
    segments: dict[str, tuple[int, ...]] = {
        "naive": tuple(range(len(step_nodes)))
    }
    if hoist and smask and step_nodes:
        from .partition import partition_tree  # lazy: avoid cycle

        part = partition_tree(tree, smask)
        pos = {v: k for k, v in enumerate(order)}
        segments["prologue"] = tuple(pos[v] for v in part.invariant_nodes)
        segments["epilogue"] = tuple(pos[v] for v in part.epilogue_nodes)
    return plan_chains(
        sched, step_nodes, segments, nbytes, vmem_budget=vmem_budget, hw=hw
    )


def modeled_plan_time(
    tree,
    smask: int = 0,
    dtype=torch.complex64,
    *,
    part=None,
    fused: bool = True,
    precision: str = "fp32",
    fidelity_tol: float | None = None,
    hw: Hardware = DEFAULT_HARDWARE,
) -> float:
    """Modeled seconds of *two-phase* execution for ``(tree, S)``: the
    refined prologue runs once, the refined epilogue ``2^|S|`` times.

    Scores a candidate without building a ``ContractionPlan``, so the
    anytime co-optimizer (:func:`repro_torch.optimize.plan_search`,
    ``objective="modeled_time"``) can price candidates straight from
    planner state.  ``part`` reuses a caller-held
    :class:`~repro_torch.lowering.partition.TreePartition`.
    ``precision``/``fidelity_tol`` score with the mixed-precision
    assignment the plan would run under (see :mod:`repro_torch.lowering.
    precision`).  The model is the refiner's per-step cost: it prices no
    kernel launch, so steps the card runs in 10-100 µs calls (``chain``,
    ``einsum``) read as nanoseconds here."""
    from ..core.tensor_network import popcount  # lazy: avoid cycle

    sched = refine_tree_schedule(tree, smask, dtype=dtype, fused=fused, hw=hw)
    if not smask:
        if precision != "fp32":
            from .precision import assign_precision  # lazy: avoid cycle

            sched = assign_precision(
                sched, mode=precision, fidelity_tol=fidelity_tol,
                fused=fused, hw=hw,
            )
        return sched.modeled_time_s
    if part is None:
        from .partition import partition_tree  # lazy: avoid cycle

        part = partition_tree(tree, smask)
    invariant = set(part.invariant_nodes)
    order = tree.contract_order()
    n_slices = 1 << popcount(smask)
    if precision != "fp32":
        from .precision import assign_precision  # lazy: avoid cycle

        epilogue = tuple(
            i for i, v in enumerate(order) if v not in invariant
        )
        sched = assign_precision(
            sched, mode=precision, fidelity_tol=fidelity_tol,
            epilogue_positions=epilogue, n_slices=n_slices, fused=fused,
            hw=hw,
        )
    prologue_t = sum(
        spec.modeled_time_s
        for v, spec in zip(order, sched.specs)
        if v in invariant
    )
    return prologue_t + (sched.modeled_time_s - prologue_t) * n_slices
