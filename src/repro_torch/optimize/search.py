"""Planners: the staged one-shot pipeline and the anytime path–slice–memory
co-optimizer.

:func:`oneshot_plan` is the classic staged pipeline (multi-restart greedy
path, Alg.-2 tuning, branch merging, GEMM orientation, then slicing,
optionally peak-refined) — the default planner of
:func:`repro_torch.core.api.plan_contraction` and the seed of the search.

:func:`plan_search` runs the paper's in-place slicer *inside* an iterated
path search (the Fig. 8 result: every candidate tree is re-sliced on the
spot and judged by what would execute):

  * a pool of deterministic simulated-annealing workers mutates
    ``(tree, S)`` pairs with **subtree-reconfiguration** moves
    (:func:`repro_torch.core.pathfinder.reconfigure_subtree`) and
    **Boltzmann restarts** out of stalled basins;
  * after every tree move the slicer is re-invoked in place
    (:func:`repro_torch.core.slicing.reslice`, warm-started from the
    previous mask and peak-refined);
  * candidates are scored by **hoist-aware executed FLOPs** (one prologue
    + ``2^|S|`` epilogues, :func:`repro_torch.lowering.partition.
    partition_tree`) or by the refiner's modeled two-phase seconds,
    subject to the **certified live-set peak** fitting the byte budget;
  * the search is **anytime-monotone**: the best-so-far only moves to a
    strictly better feasible candidate, so stopping at any budget yields
    a valid plan no worse than its one-shot seed.

Workers are cooperative (round-robin on one thread) with per-worker
seeded RNGs, so a run is bit-reproducible for a given ``(seed,
num_workers)`` and returns the reference's plan for the same inputs and
cost constants — which is what lets the plan cache address a search
*result* by the network fingerprint plus the search parameters.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from ..core.contraction_tree import ContractionTree
from ..core.merging import merge_branches, orient_gemms
from ..core.pathfinder import (
    boltzmann_restart_tree,
    random_greedy_tree,
    reconfigure_subtree,
)
from ..core.slicing import (
    find_slices,
    peak_budget_for_width,
    refine_slices_for_peak,
    reslice,
)
from ..core.tensor_network import popcount
from ..core.tuning import tuning_slice_finder
from ..hardware import DEFAULT_HARDWARE, Hardware
from ..lowering.memory import certified_peak
from ..lowering.partition import partition_tree
from ..obs import metrics as _metrics, trace as _trace

OBJECTIVES = ("flops", "modeled_time")


@dataclasses.dataclass
class OneShot:
    """Result of the staged pathfinder → slicer → refiner pipeline."""

    tree: ContractionTree
    smask: int
    width_before: int  # width of the raw greedy tree, pre-tuning


def oneshot_plan(
    tn,
    target_dim: int,
    method: str = "lifetime",
    tune: bool = True,
    merge: bool = True,
    repeats: int = 8,
    seed: int = 0,
    slicing_mode: str = "width",
    itemsize: int = 8,
    budget_bytes: int | None = None,
    hw: Hardware = DEFAULT_HARDWARE,
    precision: str = "fp32",
    fidelity_tol: float | None = None,
) -> OneShot:
    """The classic staged pipeline, each stage run exactly once.  ``hw``
    prices the branch-merging surface (it changes the tree).

    Under a mixed-precision mode (``precision`` in {"bf16", "auto"}) with
    peak-mode slicing, the refined mask gets a second, prune-only pass at
    the same fp32-derived budget using the plan's per-node storage
    itemsizes: bf16-stored intermediates halve the certified peak, so the
    bf16 mask is always a subset of the fp32 one (|S| never larger)."""
    tree = random_greedy_tree(tn, repeats=repeats, seed=seed)
    width0 = tree.width()
    if tune and method == "lifetime":
        res = tuning_slice_finder(tree, target_dim)
        tree, smask = res.tree, res.smask
    else:
        smask = find_slices(tree, target_dim, method=method, seed=seed)
    if merge:
        tree = merge_branches(tree, smask, hw).tree
        smask = find_slices(tree, target_dim, method=method, seed=seed)
    tree = orient_gemms(tree)
    if slicing_mode == "peak" and smask:
        smask = refine_slices_for_peak(
            tree, smask, target_dim, itemsize=itemsize,
            budget_bytes=budget_bytes,
        )
        if smask and precision != "fp32":
            from ..lowering.precision import tree_storage_itemsizes

            iso = tree_storage_itemsizes(
                tree, smask, itemsize=itemsize, mode=precision,
                fidelity_tol=fidelity_tol, hw=hw,
            )
            if iso:
                fp32_budget = budget_bytes
                if fp32_budget is None:
                    fp32_budget = max(
                        peak_budget_for_width(target_dim, itemsize),
                        certified_peak(tree, smask, itemsize),
                    )
                smask = refine_slices_for_peak(
                    tree, smask, target_dim, itemsize=itemsize,
                    budget_bytes=fp32_budget, itemsize_of=iso,
                )
    elif slicing_mode not in ("width", "peak"):
        raise ValueError(f"unknown slicing_mode {slicing_mode!r}")
    return OneShot(tree, smask, width0)


def per_slice_cost_vector(tree: ContractionTree, smask: int) -> np.ndarray:
    """Modeled FLOPs of each of the ``2^|S|`` slice subtasks — the cost
    vector that seeds the multi-host scheduler's LPT queues
    (:class:`repro_torch.distributed.scheduler.SliceScheduler`).

    Every subtask fixes its sliced indices to one bit assignment of the
    *same* tree, so under the paper's cost model the vector is uniform at
    :attr:`~repro_torch.lowering.partition.TreePartition.per_slice_cost`.
    Raggedness enters from outside the model (measured per-slice walls,
    synthetic overlays); the scheduler only needs every host to see the
    same vector."""
    n_slices = 1 << popcount(smask)
    if smask == 0:
        return np.ones(1)
    part = partition_tree(tree, smask)
    return np.full(n_slices, float(part.per_slice_cost))


# ----------------------------------------------------------------------
# search state
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TracePoint:
    """One improvement of the global best-so-far.

    ``objective`` strictly decreases along the trace within a
    feasibility class: best-so-far ordering is feasibility-first, so the
    one upgrade from an infeasible seed to the first feasible candidate
    (possible only under an explicit ``budget_bytes`` tighter than the
    seed's certified peak) may raise it once; with the derived budget the
    seed is feasible and the trace strictly decreases throughout."""

    evaluation: int  # 1-based evaluation count when the best improved
    wall_s: float
    objective: float  # hoist-aware executed FLOPs (or modeled seconds)
    log2_objective: float
    num_sliced: int
    peak_bytes: int
    worker: int
    move: str  # "init" | "reconfigure" | "restart"


@dataclasses.dataclass
class SearchResult:
    """Best ``(tree, S)`` found plus the anytime search trace.

    ``objective``/``peak_bytes``/``feasible`` describe the *returned*
    tree, re-certified after the final GEMM orientation pass, so the
    budget guarantee holds for the object that will execute."""

    tree: ContractionTree
    smask: int
    objective: float
    peak_bytes: int
    budget_bytes: int
    feasible: bool  # certified peak fits the budget
    evaluations: int
    wall_s: float
    trace: list[TracePoint]
    baseline_objective: float | None  # one-shot seed (init="oneshot")
    num_workers: int
    seed: int
    objective_kind: str
    width_before: int = 0  # width of the raw greedy seed tree, pre-search

    @property
    def num_sliced(self) -> int:
        return popcount(self.smask)

    @property
    def improvement(self) -> float:
        """baseline / best executed cost (>= 1.0 when seeded one-shot)."""
        if not self.baseline_objective:
            return 1.0
        return self.baseline_objective / self.objective

    def summary(self) -> dict:
        return {
            "objective": self.objective,
            "log2_objective": math.log2(self.objective),
            "num_sliced": self.num_sliced,
            "peak_bytes": self.peak_bytes,
            "budget_bytes": self.budget_bytes,
            "feasible": self.feasible,
            "evaluations": self.evaluations,
            "wall_s": self.wall_s,
            "improvement": self.improvement,
            "trace_points": len(self.trace),
            "num_workers": self.num_workers,
            "seed": self.seed,
        }


@dataclasses.dataclass
class _Worker:
    rng: object  # random.Random
    tree: ContractionTree
    smask: int
    log2_obj: float
    steps: int = 0
    stall: int = 0


@dataclasses.dataclass
class _Eval:
    smask: int
    objective: float
    peak_bytes: int
    feasible: bool


# ----------------------------------------------------------------------
# the co-optimizer
# ----------------------------------------------------------------------
def plan_search(
    tn,
    target_dim: int,
    *,
    budget_bytes: int | None = None,
    itemsize: int = 8,
    num_workers: int = 4,
    max_evals: int = 64,
    wall_clock_s: float | None = None,
    seed: int = 0,
    objective: str = "flops",
    dtype=None,
    init: str = "oneshot",
    method: str = "lifetime",
    tune: bool = True,
    merge: bool = True,
    repeats: int = 8,
    slicing_mode: str = "peak",
    max_roots: int = 8,
    stall_limit: int = 6,
    temperature: float = 1.0,
    cooling: float = 0.95,
    precision: str = "fp32",
    fidelity_tol: float | None = None,
    hw: Hardware = DEFAULT_HARDWARE,
) -> SearchResult:
    """Anytime co-optimization of ``(tree, S)`` under a certified peak
    budget.

    ``max_evals`` bounds candidate evaluations (each slicer + partition
    scoring pass counts one, worker seeds included) and is the
    deterministic budget; ``wall_clock_s`` also stops the loop on elapsed
    time.  ``budget_bytes=None`` derives the budget from the seed
    candidate, ``max(peak_budget_for_width(target_dim),
    certified_peak(seed))``, so the comparison with the one-shot pipeline
    is at equal memory.

    ``objective="flops"`` scores hoist-aware executed FLOPs;
    ``"modeled_time"`` scores the refiner's modeled two-phase seconds on
    ``hw`` (:func:`repro_torch.lowering.refiner.modeled_plan_time`, at
    ``dtype``, default complex64).  ``hw`` also prices the one-shot
    seed's branch merging.

    ``init="oneshot"`` seeds worker 0 with the staged pipeline's result,
    so the search never returns a worse plan than the one-shot baseline
    at the derived budget; ``init="greedy"`` seeds every worker with a
    fresh Boltzmann-greedy tree (an ablation with no such guarantee).
    """
    import random as _random

    import torch

    if objective not in OBJECTIVES:
        raise ValueError(f"objective {objective!r} not in {OBJECTIVES}")
    if init not in ("oneshot", "greedy"):
        raise ValueError(f"init {init!r} not in ('oneshot', 'greedy')")
    if num_workers < 1:
        raise ValueError("num_workers must be >= 1")
    if max_evals < 1:
        raise ValueError("max_evals must be >= 1")
    t0 = time.perf_counter()

    if objective == "modeled_time":
        from ..lowering.refiner import as_dtype, modeled_plan_time

        obj_dtype = as_dtype(dtype) if dtype is not None else torch.complex64

    def score(tree: ContractionTree, smask: int, part) -> float:
        if objective == "flops":
            return part.hoisted_cost() if part else tree.total_cost()
        return modeled_plan_time(
            tree, smask, dtype=obj_dtype, part=part,
            precision=precision or "fp32", fidelity_tol=fidelity_tol, hw=hw,
        )

    budget = budget_bytes  # resolved after the first seed evaluation
    evals = 0

    def evaluate(tree: ContractionTree, smask: int) -> _Eval:
        """Score one candidate; re-invokes the peak slicer in place when
        the mask overshoots the budget (top-up), never mutates ``tree``."""
        nonlocal evals
        evals += 1
        with _trace.span("search.eval", cat="search", evaluation=evals):
            part = partition_tree(tree, smask) if smask else None
            peak = certified_peak(tree, smask, itemsize, part=part)
            if budget is not None and peak > budget:
                refined = refine_slices_for_peak(
                    tree, smask, target_dim, itemsize=itemsize,
                    budget_bytes=budget,
                )
                if refined != smask:
                    smask = refined
                    part = partition_tree(tree, smask) if smask else None
                    peak = certified_peak(tree, smask, itemsize, part=part)
            feasible = budget is None or peak <= budget
            res = _Eval(smask, score(tree, smask, part), peak, feasible)
        _metrics.inc("search.evals")
        return res

    # ------------------------------------------------------------------
    # seed the workers
    # ------------------------------------------------------------------
    workers: list[_Worker] = []
    best_tree: ContractionTree | None = None
    best: _Eval | None = None
    baseline_objective: float | None = None
    width_before = 0
    trace: list[TracePoint] = []

    def consider(tree: ContractionTree, ev: _Eval, w: int, move: str) -> None:
        """The anytime-monotone contract: the global best only ever
        moves to a strictly better feasible candidate."""
        nonlocal best, best_tree
        better = best is None or (
            (ev.feasible and not best.feasible)
            or (ev.feasible == best.feasible and ev.objective < best.objective)
        )
        if better:
            best = ev
            best_tree = tree.copy()
            trace.append(
                TracePoint(
                    evaluation=evals,
                    wall_s=time.perf_counter() - t0,
                    objective=ev.objective,
                    log2_objective=math.log2(ev.objective),
                    num_sliced=popcount(ev.smask),
                    peak_bytes=ev.peak_bytes,
                    worker=w,
                    move=move,
                )
            )

    for w in range(num_workers):
        if evals >= max_evals and workers:
            break
        rng = _random.Random(seed * 1_000_003 + w)
        if w == 0 and init == "oneshot":
            shot = oneshot_plan(
                tn, target_dim, method=method, tune=tune, merge=merge,
                repeats=repeats, seed=seed, slicing_mode=slicing_mode,
                itemsize=itemsize, budget_bytes=budget_bytes, hw=hw,
                precision=precision or "fp32", fidelity_tol=fidelity_tol,
            )
            tree, warm = shot.tree, shot.smask
            width_before = shot.width_before
        else:
            tree = boltzmann_restart_tree(tn, rng)
            warm = best.smask if best is not None else 0
            if not workers:
                width_before = tree.width()
        if budget is None and not workers:
            # the seed's certified envelope fixes the budget for the
            # whole run (equal-memory comparison with the staged pipeline)
            seed_mask = (
                warm
                if init == "oneshot"
                else reslice(tree, target_dim, warm=warm, mode="width")
            )
            budget = max(
                peak_budget_for_width(target_dim, itemsize),
                certified_peak(tree, seed_mask, itemsize),
            )
            warm = seed_mask  # the full reslice below warm-starts here
        smask = reslice(
            tree, target_dim, warm=warm, mode=slicing_mode,
            itemsize=itemsize, budget_bytes=budget,
        )
        ev = evaluate(tree, smask)
        if w == 0 and init == "oneshot" and ev.feasible:
            # an infeasible seed (explicit budget tighter than its
            # certified peak) is no baseline: "never worse than one-shot"
            # only means something at equal budget
            baseline_objective = ev.objective
        workers.append(
            _Worker(rng, tree, ev.smask, math.log2(ev.objective))
        )
        consider(tree, ev, w, "init")

    # ------------------------------------------------------------------
    # the anytime loop
    # ------------------------------------------------------------------
    while evals < max_evals:
        if wall_clock_s is not None and time.perf_counter() - t0 >= (
            wall_clock_s
        ):
            break
        w = evals % len(workers)
        worker = workers[w]
        rng = worker.rng
        temp = temperature * (cooling ** worker.steps)
        worker.steps += 1
        if worker.stall >= stall_limit:
            # Boltzmann restart out of the stalled basin
            tree = boltzmann_restart_tree(tn, rng)
            smask = reslice(
                tree, target_dim, warm=worker.smask, mode=slicing_mode,
                itemsize=itemsize, budget_bytes=budget,
            )
            ev = evaluate(tree, smask)
            worker.tree = tree
            worker.smask = ev.smask
            worker.log2_obj = math.log2(ev.objective)
            worker.stall = 0
            _metrics.inc("search.restarts")
            consider(tree, ev, w, "restart")
            continue
        res = reconfigure_subtree(
            worker.tree, rng, max_roots=max_roots,
            temperature=0.1 + 0.5 * rng.random(),
        )
        if res is None:
            worker.stall += 1
            continue
        # tight inner loop: the local move leaves the warm mask
        # near-optimal, so skip reslice's fresh slice_finder comparison
        # (seeds and restarts, far from the warm mask, keep it)
        smask = reslice(
            worker.tree, target_dim, warm=worker.smask, mode=slicing_mode,
            itemsize=itemsize, budget_bytes=budget, compare_fresh=False,
        )
        ev = evaluate(worker.tree, smask)
        dlog = math.log2(ev.objective) - worker.log2_obj
        accept = ev.feasible and (
            dlog < 0.0
            or rng.random() < math.exp(-dlog / max(temp, 1e-3))
        )
        if accept:
            worker.smask = ev.smask
            worker.log2_obj = math.log2(ev.objective)
            worker.stall = 0 if dlog < 0.0 else worker.stall + 1
            _metrics.inc("search.accepted")
            consider(worker.tree, ev, w, "reconfigure")
        else:
            worker.tree.unsplice(res)
            worker.stall += 1
            _metrics.inc("search.rejected")

    assert best is not None and best_tree is not None
    # GEMM orientation swaps children, which changes the post-order
    # schedule and so step lifetimes: re-certify the oriented tree so the
    # returned peak/feasibility describe the object that will execute,
    # and keep the unoriented (certified) tree when orientation would
    # break a tight budget.
    oriented = orient_gemms(best_tree)
    part = partition_tree(oriented, best.smask) if best.smask else None
    peak = certified_peak(oriented, best.smask, itemsize, part=part)
    if budget is None or peak <= budget or peak <= best.peak_bytes:
        best_tree = oriented
        best = _Eval(
            best.smask,
            score(oriented, best.smask, part),
            peak,
            budget is None or peak <= budget,
        )
    return SearchResult(
        tree=best_tree,
        smask=best.smask,
        objective=best.objective,
        peak_bytes=best.peak_bytes,
        budget_bytes=int(budget) if budget is not None else 0,
        feasible=best.feasible,
        evaluations=evals,
        wall_s=time.perf_counter() - t0,
        trace=trace,
        baseline_objective=baseline_objective,
        num_workers=num_workers,
        seed=seed,
        objective_kind=objective,
        width_before=width_before,
    )
