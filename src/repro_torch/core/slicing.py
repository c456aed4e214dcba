"""Slicing-set selection (Sec. IV).

Three strategies, all returning an index bitmask ``S``:

* :func:`slice_finder` — the paper's Algorithm 1.  In-place, lifetime-guided:
  repeatedly take the *smallest dimension-exceeded* stem tensor, slice its
  longest-lifetime indices until it fits, peel fitted tensors off the stem
  ends, repeat.  One pass over stem indices — this is what gives the
  100-200x planner speedup over repeated greedy.

* :func:`greedy_slicer` — the Cotengra-style baseline: repeatedly add the
  single index that minimizes the post-slice total cost (Eq. 6), optionally
  restarted ``repeats`` times with randomized tie-breaking, keeping the
  best.  Implemented with the same incremental cost trick cotengra uses so
  the comparison is fair.

* :func:`interval_optimal_slicer` — beyond-paper: on the stem-interval
  relaxation (every lifetime ∩ stem is a contiguous interval, demands
  ``dim_i - t`` per position), the farthest-right-endpoint sweep is provably
  minimal.  Used to verify the paper's "smallest slicing set" claim.

All strategies are followed by :func:`ensure_width` which tops up ``S``
greedily until the *whole tree* satisfies the memory bound (the paper notes
stems occasionally miss a huge off-stem tensor).

Beyond the width proxy, :func:`refine_slices_for_peak` (the
``mode="peak"`` leg of :func:`find_slices`) re-judges the finished mask
against the *planned live-set peak* from :mod:`repro_torch.lowering.memory`:
the width bound must conservatively assume several width-sized tensors
are simultaneously live, so once the schedule's true peak is known,
slicing can stop earlier — indices whose removal keeps the planned peak
within the byte budget are pruned, shrinking ``2^|S|`` (a direct
multiplicative saving on ``contract_all``, Eq. 4).
"""

from __future__ import annotations

import random

from .contraction_tree import ContractionTree
from .lifetime import Stem, detect_stem
from .tensor_network import bits, popcount


# ----------------------------------------------------------------------
# Algorithm 1 — sliceFinder
# ----------------------------------------------------------------------
def slice_finder(
    tree: ContractionTree,
    target_dim: int,
    stem: Stem | None = None,
) -> int:
    """Paper Algorithm 1 (in-place slicing on the stem)."""
    if stem is None:
        stem = detect_stem(tree)
    open_m = tree.tn.open_mask
    # M: dimension-exceeded stem tensors, in stem order (contiguity holds:
    # dropping tensors only shortens stem-scoped lifetimes).
    masks = [m for m in stem.masks() if popcount(m) > target_dim]
    S = 0
    guard = 0
    while masks:
        guard += 1
        if guard > 10_000:  # pragma: no cover - safety valve
            break
        # stem-scoped lifetimes of currently sliceable indices
        lo: dict[int, int] = {}
        hi: dict[int, int] = {}
        for pos, m in enumerate(masks):
            for b in bits(m & ~open_m):
                if b not in lo:
                    lo[b] = pos
                hi[b] = pos
        lf = {b: hi[b] - lo[b] + 1 for b in lo}
        dims = [popcount(m) for m in masks]
        exceeded = [i for i, d in enumerate(dims) if d > target_dim]
        if not exceeded:
            break
        k = min(exceeded, key=lambda i: dims[i])
        while dims[k] > target_dim:
            cand = list(bits(masks[k] & ~open_m))
            if not cand:
                break  # only open indices left; ensure_width must finish
            b = max(cand, key=lambda b_: (lf.get(b_, 1), b_))
            S |= 1 << b
            bm = ~(1 << b)
            for i in range(lo.get(b, 0), hi.get(b, len(masks) - 1) + 1):
                if masks[i] & (1 << b):
                    masks[i] &= bm
                    dims[i] -= 1
        # peel fitted tensors from both ends (keeps M contiguous)
        while masks and popcount(masks[0]) <= target_dim:
            masks.pop(0)
        while masks and popcount(masks[-1]) <= target_dim:
            masks.pop()
        if not any(popcount(m) > target_dim for m in masks):
            break
    return S


# ----------------------------------------------------------------------
# Cotengra-style greedy baseline
# ----------------------------------------------------------------------
def greedy_slicer(
    tree: ContractionTree,
    target_dim: int,
    repeats: int = 1,
    seed: int = 0,
    temperature: float = 0.0,
) -> int:
    """Repeated greedy SliceFinder baseline (Cotengra's strategy).

    Each step evaluates *every* candidate index against the full Eq. 6 cost
    and takes the cheapest; restarts keep the best overall.  Intentionally
    the same cost structure as cotengra's SliceFinder so the Fig. 8 speed
    comparison is apples-to-apples.
    """
    rng = random.Random(seed)
    open_m = tree.tn.open_mask
    node_masks = [tree.node_mask(v) for v in tree.children]
    edge_masks = list(tree.emask.values())

    best_S = None
    best_cost = float("inf")
    for _ in range(max(1, repeats)):
        S = 0
        while True:
            width = max(popcount(m & ~S) for m in edge_masks)
            if width <= target_dim:
                break
            # candidates: indices of any still-exceeded tensor
            cand_mask = 0
            for m in edge_masks:
                if popcount(m & ~S) > target_dim:
                    cand_mask |= m
            cand_mask &= ~open_m & ~S
            cands = list(bits(cand_mask))
            if not cands:
                break
            # incremental Eq.6: base_v = 2^(|nm|-|S∩nm|); adding index i
            # doubles every node not containing i.
            total = 0.0
            per_index: dict[int, float] = {c: 0.0 for c in cands}
            for nm in node_masks:
                base = 2.0 ** (popcount(nm) - popcount(S & nm))
                total += base
                hit = nm & cand_mask
                for b in bits(hit):
                    per_index[b] += base
            scores = {c: 2.0 * total - per_index[c] for c in cands}
            lo = min(scores.values())
            if temperature > 0.0:
                pool = [c for c in cands if scores[c] <= lo * (1 + temperature)]
                choice = rng.choice(pool)
            else:
                choice = min(cands, key=lambda c: (scores[c], c))
            S |= 1 << choice
        c = tree.sliced_cost(S)
        if c < best_cost:
            best_cost, best_S = c, S
    return best_S if best_S is not None else 0


# ----------------------------------------------------------------------
# beyond-paper: interval-optimal slicing on the stem relaxation
# ----------------------------------------------------------------------
def interval_optimal_slicer(
    tree: ContractionTree,
    target_dim: int,
    stem: Stem | None = None,
) -> int:
    """Minimal slicing set under the stem-interval model.

    Every stem position ``i`` demands ``c_i = dim_i - t`` sliced indices
    among its own; lifetimes are intervals, so the classic sweep (when a
    position is deficient, add the available indices with the farthest
    right endpoint) is optimal by an exchange argument.
    """
    if stem is None:
        stem = detect_stem(tree)
    open_m = tree.tn.open_mask
    masks = stem.masks()
    n = len(masks)
    lo: dict[int, int] = {}
    hi: dict[int, int] = {}
    for pos, m in enumerate(masks):
        for b in bits(m & ~open_m):
            if b not in lo:
                lo[b] = pos
            hi[b] = pos
    S = 0
    for i in range(n):
        deficit = popcount(masks[i] & ~S) - target_dim
        if deficit <= 0:
            continue
        avail = [
            b
            for b in bits(masks[i] & ~open_m & ~S)
        ]
        avail.sort(key=lambda b: (hi[b], b), reverse=True)
        for b in avail[:deficit]:
            S |= 1 << b
    return S


# ----------------------------------------------------------------------
# global memory-bound guarantee
# ----------------------------------------------------------------------
def ensure_width(tree: ContractionTree, S: int, target_dim: int) -> int:
    """Greedy top-up until every tree tensor fits the bound (handles huge
    off-stem tensors the stem pass cannot see)."""
    open_m = tree.tn.open_mask
    edge_masks = list(tree.emask.values())
    node_masks = [tree.node_mask(v) for v in tree.children]
    guard = 0
    while True:
        guard += 1
        if guard > 5_000:  # pragma: no cover
            break
        worst = max(edge_masks, key=lambda m: popcount(m & ~S))
        if popcount(worst & ~S) <= target_dim:
            return S
        cands = list(bits(worst & ~open_m & ~S))
        if not cands:
            raise ValueError(
                "cannot satisfy memory bound: open indices exceed target"
            )
        # pick the candidate minimizing Eq. 6 (incremental form)
        best_b, best_pen = None, float("inf")
        pen = {c: 0.0 for c in cands}
        cand_mask = 0
        for c in cands:
            cand_mask |= 1 << c
        total = 0.0
        for nm in node_masks:
            base = 2.0 ** (popcount(nm) - popcount(S & nm))
            total += base
            for b in bits(nm & cand_mask):
                pen[b] += base
        for c in cands:
            p = 2.0 * total - pen[c]
            if p < best_pen:
                best_pen, best_b = p, c
        S |= 1 << best_b
    return S


# ----------------------------------------------------------------------
# peak-aware refinement (lifetime-based memory plan, not the width proxy)
# ----------------------------------------------------------------------
# live tensors the width proxy must budget for (operands + output of the
# running GEMM plus headroom for leaves/branches): width target t with
# itemsize w therefore implies a byte budget of LIVE_FACTOR * w * 2^t
DEFAULT_LIVE_FACTOR = 4


def peak_budget_for_width(
    target_dim: int, itemsize: int = 8, live_factor: int = DEFAULT_LIVE_FACTOR
) -> int:
    """The byte budget a width-``target_dim`` schedule implicitly
    guarantees under the proxy's live-set assumption."""
    return live_factor * itemsize * (1 << target_dim)


def refine_slices_for_peak(
    tree: ContractionTree,
    S: int,
    target_dim: int,
    itemsize: int = 8,
    budget_bytes: int | None = None,
    itemsize_of: dict[int, int] | None = None,
) -> int:
    """Shrink (or, for a hard explicit budget, grow) a slicing mask so
    the *planned live-set peak* — not the width proxy — meets the byte
    budget.

    ``itemsize_of`` (per-node storage itemsizes from the precision
    planner) makes the certified peak dtype-true under a mixed-precision
    plan: bf16-stored nodes count half bytes, so re-certifying an
    fp32-derived mask against the *same* budget can only prune further —
    peak-mode slicing under bf16 finds a never-larger ``|S|``.

    The *certified* peak is the worst case over both execution modes:
    the naive full-tree subtask and the two-phase hoisted pair
    (``max(prologue, epilogue)`` — the epilogue counting the pinned
    hoisted frontier), each at ``slice_batch=1``; the executor's vmap
    scales the non-pinned epilogue share by the slice batch
    (:meth:`~repro_torch.lowering.memory.MemoryPlan.epilogue_peak`), an
    execution-time choice the planner cannot see.

    The naive peak is monotone in ``S`` (removing a sliced index only
    grows tensors on its lifetime), which drives the top-up loop (same
    Eq. 6 greedy as :func:`ensure_width`; only reachable with a tight
    explicit budget).  The prune loop needs no monotonicity — every
    candidate removal is re-certified against the full budget — so it
    also covers the non-monotone hoisted segments: repeatedly drop the
    sliced index whose removal keeps the certified peak within budget at
    the lowest resulting Eq. 6 cost.  Each drop halves the subtask count
    outright.

    With ``budget_bytes=None`` the budget is
    ``max(peak_budget_for_width(target_dim, itemsize),
    certified_peak(S))`` — never demanding more than the width-proxy
    schedule already uses, which makes peak mode a strict refinement:
    ``|S_peak| <= |S_width|`` always, with strict improvement whenever
    the width pipeline sliced an index the true peak never needed.
    """
    from ..lowering.memory import certified_peak as _peak  # lazy: cycle

    def certified_peak(mask: int) -> int:
        return _peak(tree, mask, itemsize, itemsize_of=itemsize_of)

    if budget_bytes is None:
        budget_bytes = max(
            peak_budget_for_width(target_dim, itemsize),
            certified_peak(S),
        )
    open_m = tree.tn.open_mask
    node_masks = [tree.node_mask(v) for v in tree.children]
    guard = 0
    # top-up: only an explicit budget tighter than the width result's own
    # peak can trigger this
    while certified_peak(S) > budget_bytes:
        guard += 1
        if guard > 5_000:  # pragma: no cover - safety valve
            break
        worst = max(tree.emask.values(), key=lambda m: popcount(m & ~S))
        cands = list(bits(worst & ~open_m & ~S))
        if not cands:
            break  # only open indices left: budget unreachable
        best_b, best_pen = None, float("inf")
        for c in cands:
            pen = sum(
                2.0 ** (popcount(nm) - popcount((S | (1 << c)) & nm))
                for nm in node_masks
            )
            if pen < best_pen:
                best_pen, best_b = pen, c
        S |= 1 << best_b
    # prune: drop indices the true peak never needed
    while True:
        guard += 1
        if guard > 5_000:  # pragma: no cover
            break
        removable = [
            b
            for b in bits(S)
            if certified_peak(S & ~(1 << b)) <= budget_bytes
        ]
        if not removable:
            return S
        b = min(removable, key=lambda b_: (tree.sliced_cost(S & ~(1 << b_)), b_))
        S &= ~(1 << b)
    return S


def reslice(
    tree: ContractionTree,
    target_dim: int,
    warm: int = 0,
    mode: str = "width",
    itemsize: int = 8,
    budget_bytes: int | None = None,
    compare_fresh: bool = True,
) -> int:
    """Incremental re-slice after a tree move, warm-starting from the
    previous mask — the in-place slicer invocation the anytime
    co-optimizer (:mod:`repro_torch.optimize`) runs after every accepted tree
    mutation.

    The warm mask is adapted to the new tree: bits are first topped up
    to restore the width bound (the move may have widened an edge), then
    greedily pruned while the bound holds (the move may have shortened a
    lifetime, making a previously needed bit redundant — pruning halves
    the subtask count per dropped bit).  With ``compare_fresh`` a fresh
    :func:`slice_finder` pass also runs and the cheaper mask (Eq. 6)
    wins, so warm starting never costs quality; pass
    ``compare_fresh=False`` inside tight search loops where the warm
    mask is expected to stay near-optimal.  ``mode="peak"`` finishes
    with :func:`refine_slices_for_peak` against ``budget_bytes``."""
    open_m = tree.tn.open_mask
    S = warm & ~open_m
    if tree.sliced_width(S) > target_dim:
        S = ensure_width(tree, S, target_dim)
    while True:
        removable = [
            b
            for b in bits(S)
            if tree.sliced_width(S & ~(1 << b)) <= target_dim
        ]
        if not removable:
            break
        b = min(
            removable, key=lambda b_: (tree.sliced_cost(S & ~(1 << b_)), b_)
        )
        S &= ~(1 << b)
    if compare_fresh:
        fresh = ensure_width(tree, slice_finder(tree, target_dim), target_dim)
        if tree.sliced_cost(fresh) < tree.sliced_cost(S):
            S = fresh
    if mode == "peak":
        S = refine_slices_for_peak(
            tree, S, target_dim, itemsize=itemsize, budget_bytes=budget_bytes
        )
    elif mode != "width":
        raise ValueError(f"unknown slicing mode {mode!r}")
    return S


def find_slices(
    tree: ContractionTree,
    target_dim: int,
    method: str = "lifetime",
    mode: str = "width",
    itemsize: int = 8,
    budget_bytes: int | None = None,
    **kw,
) -> int:
    """Unified entry point.  ``method``: lifetime (paper Alg. 1), greedy
    (Cotengra baseline), interval (beyond-paper optimal sweep).
    ``mode="peak"`` re-judges the finished mask against the planned
    live-set peak (:func:`refine_slices_for_peak`) instead of stopping at
    the width proxy."""
    if method == "lifetime":
        S = slice_finder(tree, target_dim, stem=kw.get("stem"))
    elif method == "greedy":
        S = greedy_slicer(
            tree,
            target_dim,
            repeats=kw.get("repeats", 1),
            seed=kw.get("seed", 0),
            temperature=kw.get("temperature", 0.0),
        )
    elif method == "interval":
        S = interval_optimal_slicer(tree, target_dim, stem=kw.get("stem"))
    else:
        raise ValueError(f"unknown slicing method {method!r}")
    S = ensure_width(tree, S, target_dim)
    if mode == "peak":
        S = refine_slices_for_peak(
            tree, S, target_dim, itemsize=itemsize, budget_bytes=budget_bytes
        )
    elif mode != "width":
        raise ValueError(f"unknown slicing mode {mode!r}")
    return S


def partition_slice_ids(
    n_slices: int, n_parts: int
) -> list[tuple[int, int]]:
    """The paper's static process split: contiguous ``[start, end)``
    runs of slice ids, near-equal in *count* (first ``n_slices mod
    n_parts`` parts get one extra id).  This is the Sec. V-D baseline the
    work-stealing scheduler (:mod:`repro_torch.distributed`) is measured
    against; empty parts (``n_parts > n_slices``) come back as empty
    ranges so host indices stay aligned."""
    if n_parts < 1:
        raise ValueError("n_parts must be >= 1")
    base, extra = divmod(int(n_slices), int(n_parts))
    out = []
    pos = 0
    for p in range(n_parts):
        take = base + (1 if p < extra else 0)
        out.append((pos, pos + take))
        pos += take
    return out
