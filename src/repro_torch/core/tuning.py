"""Iterative tree tuning via branch exchange (Sec. IV-C, Algorithm 2).

The paper interleaves sliceFinder with *branch exchanges* on the stem:
swapping two neighbouring branches B1, B2,

    q = (T, B1), p = (q, B2)   →   q' = (T, B2), p' = (q', B1)

changes only the middle tensor (q's result) and therefore only the two
node costs — the exchange condition (Eq. 8/9) reduces to comparing those
two local sliced costs, O(1) with bitmask popcounts.  We evaluate the gain
*exactly* under Eq. 6 instead of the paper's closed-form inequality (same
decision, fewer special cases) and sweep the stem until a fixed point,
re-running sliceFinder between sweeps exactly as Algorithm 2 prescribes.

Deviation from the paper, recorded in DESIGN.md: Algorithm 2 picks a random
stem position and retries with a fail counter; we use deterministic full
sweeps (strictly a superset of the moves, reproducible in tests).
"""

from __future__ import annotations

import dataclasses

from .contraction_tree import ContractionTree
from .lifetime import detect_stem
from .slicing import ensure_width, slice_finder
from .tensor_network import popcount


def _local_sliced_cost(tree: ContractionTree, nodes, S: int) -> float:
    tot = 0.0
    for v in nodes:
        nm = tree.node_mask(v)
        tot += 2.0 ** (popcount(nm) - popcount(S & nm))
    return tot


def exchange_gain(
    tree: ContractionTree,
    p: int,
    q: int,
    branch_q: int,
    branch_p: int,
    S: int,
) -> tuple[float, int]:
    """(gain, new_mid_width): positive gain ⇒ exchanging lowers the local
    Eq. 6 cost.  ``new_mid_width`` is the post-slicing width of the new
    intermediate (memory guard)."""
    em = tree.emask
    spine = [c for c in tree.children[q] if c != branch_q][0]
    open_m = tree.tn.open_mask

    def res(ma: int, mb: int) -> int:
        return (ma ^ mb) | (ma & mb & open_m)

    before = _local_sliced_cost(tree, (p, q), S)
    new_q = res(em[spine], em[branch_p])
    nm_q = em[spine] | em[branch_p]
    nm_p = new_q | em[branch_q]
    after = (
        2.0 ** (popcount(nm_q) - popcount(S & nm_q))
        + 2.0 ** (popcount(nm_p) - popcount(S & nm_p))
    )
    return before - after, popcount(new_q & ~S)


@dataclasses.dataclass
class TuningResult:
    tree: ContractionTree
    smask: int
    sliced_cost: float
    rounds: int
    exchanges: int


def tuning_slice_finder(
    tree: ContractionTree,
    target_dim: int,
    max_rounds: int = 20,
    slicer=slice_finder,
) -> TuningResult:
    """Algorithm 2: alternate sliceFinder and branch-exchange sweeps.

    Keeps the best (tree, S) seen by total sliced cost; stops after a sweep
    with no improving exchange or ``max_rounds``.
    """
    work = tree.copy()
    best_tree = work.copy()
    best_S = ensure_width(work, slicer(work, target_dim), target_dim)
    best_cost = work.sliced_cost(best_S)
    total_exchanges = 0
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        stem = detect_stem(work)
        S = ensure_width(work, slicer(work, target_dim, stem=stem), target_dim)
        width_cap = max(target_dim, work.sliced_width(S))
        swept = 0
        for i in range(len(stem.nodes) - 1):
            args = stem.exchange_args(i)
            if args is None:
                continue
            pp, qq, bq, bp = args
            # surgery from earlier sweeps may have detached this pair
            if work.parent.get(qq) != pp:
                continue
            if bq not in work.children.get(qq, ()) or (
                bp not in work.children.get(pp, ())
            ):
                continue
            gain, new_w = exchange_gain(work, pp, qq, bq, bp, S)
            if gain > 0 and new_w <= width_cap:
                work.exchange_at(pp, qq, bq, bp)
                swept += 1
        total_exchanges += swept
        S2 = ensure_width(work, slicer(work, target_dim), target_dim)
        c2 = work.sliced_cost(S2)
        if c2 < best_cost:
            best_cost = c2
            best_S = S2
            best_tree = work.copy()
        if swept == 0:
            break
    return TuningResult(best_tree, best_S, best_cost, rounds, total_exchanges)
