"""Planners: the staged one-shot pipeline (:func:`oneshot_plan`) and the
anytime path–slice–memory co-optimizer (:func:`plan_search`), which runs
the paper's in-place slicer and the lifetime machinery *inside* an
iterated tree search, scoring every ``(tree, S)`` candidate by hoist-aware
executed FLOPs under a certified live-set peak budget.  See
:mod:`repro_torch.optimize.search`."""

from .search import (
    OBJECTIVES,
    OneShot,
    SearchResult,
    TracePoint,
    oneshot_plan,
    per_slice_cost_vector,
    plan_search,
)

__all__ = [
    "OBJECTIVES",
    "OneShot",
    "SearchResult",
    "TracePoint",
    "oneshot_plan",
    "per_slice_cost_vector",
    "plan_search",
]
