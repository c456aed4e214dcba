"""The staged one-shot planner: pathfinder → slicer → refiner.

Multi-restart greedy path, Alg.-2 tuning, branch merging, GEMM
orientation, then slicing (optionally peak-refined).  This is the default
planner of :func:`repro_torch.core.api.plan_contraction`.
"""

from __future__ import annotations

import dataclasses

from ..core.contraction_tree import ContractionTree
from ..core.merging import merge_branches, orient_gemms
from ..core.pathfinder import random_greedy_tree
from ..core.slicing import (
    find_slices,
    peak_budget_for_width,
    refine_slices_for_peak,
)
from ..core.tuning import tuning_slice_finder
from ..hardware import DEFAULT_HARDWARE, Hardware


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
            from ..lowering.memory import certified_peak
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
