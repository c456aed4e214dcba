"""Contraction-order search.

The paper (and its baselines Cotengra/Alibaba) rely on anytime heuristics:
randomized greedy search over pairwise contractions, graph-partition guided
orders, and local tuning.  We implement:

  * ``greedy_ssa_path``     — opt_einsum/cotengra-style greedy with Boltzmann
                              (temperature) randomization.
  * ``random_greedy_tree``  — multi-restart greedy, keep the best tree by
                              C(B) (Eq. 3).
  * ``partition_ssa_path``  — recursive bisection (KL-style refinement of a
                              BFS grown cut), the kahypar/GN analogue.
  * ``dp_optimal_tree``     — exact subset DP (Pfeifer et al.) for small
                              networks; used as test oracle.
"""

from __future__ import annotations

import heapq
import math
import random
from typing import Sequence

from .contraction_tree import ContractionTree
from .tensor_network import TensorNetwork, bits, popcount


def _gumbel(rng: random.Random) -> float:
    """Standard Gumbel noise — the Boltzmann-randomization primitive
    shared by the greedy pathfinder and the reconfiguration moves."""
    return -math.log(-math.log(rng.random() + 1e-12) + 1e-12)


# ----------------------------------------------------------------------
# greedy
# ----------------------------------------------------------------------
def greedy_ssa_path(
    tn: TensorNetwork,
    seed: int = 0,
    temperature: float = 0.0,
) -> list[tuple[int, int]]:
    """Greedy pairwise contraction minimizing ``size(out) - size(a) -
    size(b)`` with optional Boltzmann noise (temperature in log2-size
    units)."""
    rng = random.Random(seed)
    masks: dict[int, int] = {i: m for i, m in enumerate(tn.masks)}
    open_m = tn.open_mask
    owners: dict[int, set[int]] = {}
    for i, m in masks.items():
        for b in bits(m & ~open_m):
            owners.setdefault(b, set()).add(i)

    def result(ma: int, mb: int) -> int:
        return (ma ^ mb) | (ma & mb & open_m)

    def score(ma: int, mb: int) -> float:
        r = result(ma, mb)
        s = 2.0 ** popcount(r) - 2.0 ** popcount(ma) - 2.0 ** popcount(mb)
        if temperature > 0.0:
            s -= temperature * _gumbel(rng) * max(abs(s), 1.0)
        return s

    heap: list[tuple[float, int, int]] = []
    seen_pairs: set[tuple[int, int]] = set()

    def push_pairs_of(i: int) -> None:
        cands: set[int] = set()
        for b in bits(masks[i] & ~open_m):
            cands |= owners.get(b, set())
        cands.discard(i)
        for j in cands:
            key = (min(i, j), max(i, j))
            if key not in seen_pairs:
                seen_pairs.add(key)
                heapq.heappush(heap, (score(masks[i], masks[j]), *key))

    for i in list(masks):
        push_pairs_of(i)

    ssa = len(masks)
    path: list[tuple[int, int]] = []
    n_alive = len(masks)
    while n_alive > 1:
        contracted = False
        while heap:
            _, a, b = heapq.heappop(heap)
            if a in masks and b in masks:
                contracted = True
                break
        if not contracted:
            # disconnected components: contract two arbitrary survivors
            alive = sorted(masks)
            a, b = alive[0], alive[1]
        ma, mb = masks.pop(a), masks.pop(b)
        for b_ in bits(ma & ~open_m):
            owners[b_].discard(a)
        for b_ in bits(mb & ~open_m):
            owners[b_].discard(b)
        nid = ssa
        ssa += 1
        masks[nid] = result(ma, mb)
        for b_ in bits(masks[nid] & ~open_m):
            owners.setdefault(b_, set()).add(nid)
        path.append((a, b))
        push_pairs_of(nid)
        n_alive -= 1
    return path


def random_greedy_tree(
    tn: TensorNetwork,
    repeats: int = 16,
    seed: int = 0,
    temperatures: Sequence[float] = (0.0, 0.3, 1.0),
) -> ContractionTree:
    best: ContractionTree | None = None
    best_cost = float("inf")
    for r in range(repeats):
        temp = temperatures[r % len(temperatures)] if r else 0.0
        path = greedy_ssa_path(tn, seed=seed + r, temperature=temp)
        tree = ContractionTree.from_ssa_path(tn, path)
        c = tree.total_cost()
        if c < best_cost:
            best, best_cost = tree, c
    assert best is not None
    return best


# ----------------------------------------------------------------------
# local reconfiguration moves (anytime co-optimizer, repro_torch.optimize)
# ----------------------------------------------------------------------
def local_ssa_order(
    masks: Sequence[int],
    open_m: int,
    rng: random.Random | None = None,
    temperature: float = 0.0,
) -> list[tuple[int, int]]:
    """Greedy pairwise order over a small set of tensors, as an SSA path
    over *positions* (result of pair ``j`` takes position
    ``len(masks) + j``) — the format :meth:`ContractionTree.
    splice_subtree` consumes.  Minimizes result size, prefers connected
    pairs, with optional Boltzmann noise for randomized reconfiguration
    moves."""
    masks = list(masks)
    alive = list(range(len(masks)))
    pairs: list[tuple[int, int]] = []

    def result(ma: int, mb: int) -> int:
        return (ma ^ mb) | (ma & mb & open_m)

    while len(alive) > 1:
        best = None
        best_s = float("inf")
        for i in range(len(alive)):
            for j in range(i + 1, len(alive)):
                ma, mb = masks[alive[i]], masks[alive[j]]
                shared = popcount(ma & mb & ~open_m)
                s = 2.0 ** popcount(result(ma, mb))
                if not shared:
                    s *= 1e6  # prefer connected pairs
                if temperature > 0.0 and rng is not None:
                    s *= math.exp(-temperature * _gumbel(rng))
                if s < best_s:
                    best_s, best = s, (i, j)
        i, j = best
        pa, pb = alive[i], alive[j]
        masks.append(result(masks[pa], masks[pb]))
        pairs.append((pa, pb))
        alive = [x for k, x in enumerate(alive) if k not in (i, j)]
        alive.append(len(masks) - 1)
    return pairs


def reconfigure_subtree(
    tree: ContractionTree,
    rng: random.Random,
    max_roots: int = 8,
    temperature: float = 0.3,
):
    """One subtree-reconfiguration move: pick an internal node (sampled
    with probability proportional to its contraction cost, so expensive
    regions are reworked most often), cut its subtree at a ≤``max_roots``
    frontier, and splice a freshly searched local order back in place.

    Returns the :class:`~repro_torch.core.contraction_tree.SpliceResult` (undo
    record + incremental cost delta), or ``None`` when no productive
    region exists.  The caller owns accept/reject:
    ``tree.unsplice(result)`` reverts the move exactly."""
    internal = tree.internal_nodes()
    if not internal:
        return None
    # cost-weighted sample over log2 costs (avoids overflow on wide trees)
    log2s = [(popcount(tree.node_mask(v)), v) for v in internal]
    top = max(c for c, _ in log2s)
    weights = [2.0 ** (c - top) for c, _ in log2s]
    r = rng.random() * sum(weights)
    v = log2s[-1][1]
    for w, (_, cand) in zip(weights, log2s):
        r -= w
        if r <= 0:
            v = cand
            break
    frontier = tree.subtree_frontier(v, max_roots=max_roots)
    if len(frontier) < 3:
        return None
    pairs = local_ssa_order(
        [tree.emask[f] for f in frontier],
        tree.tn.open_mask,
        rng=rng,
        temperature=temperature,
    )
    return tree.splice_subtree(v, frontier, pairs)


def boltzmann_restart_tree(
    tn: TensorNetwork,
    rng: random.Random,
    temperatures: Sequence[float] = (0.0, 0.2, 0.5, 1.0),
) -> ContractionTree:
    """A fresh greedy tree at a randomly drawn Boltzmann temperature —
    the co-optimizer's escape hatch out of a stalled basin."""
    return ContractionTree.from_ssa_path(
        tn,
        greedy_ssa_path(
            tn,
            seed=rng.randrange(1 << 31),
            temperature=rng.choice(list(temperatures)),
        ),
    )


# ----------------------------------------------------------------------
# recursive bisection (GN/kahypar analogue)
# ----------------------------------------------------------------------
def partition_ssa_path(
    tn: TensorNetwork, seed: int = 0, leaf_size: int = 8
) -> list[tuple[int, int]]:
    """Recursive bisection: grow a balanced cut by BFS, refine KL-style,
    recurse, contract each side greedily, then join."""
    rng = random.Random(seed)
    # Partitioning acts as an ordering constraint on greedy: build the
    # hierarchy of vertex groups, then emit contractions bottom-up.
    adj = tn.neighbors()

    def bisect(vs: list[int]) -> tuple[list[int], list[int]]:
        vset = set(vs)
        start = rng.choice(vs)
        side = {start}
        frontier = [start]
        target = len(vs) // 2
        while len(side) < target and frontier:
            nxt: list[int] = []
            for v in frontier:
                for u in adj[v]:
                    if u in vset and u not in side and len(side) < target:
                        side.add(u)
                        nxt.append(u)
            frontier = nxt
            if not frontier and len(side) < target:
                rest = [v for v in vs if v not in side]
                side.add(rng.choice(rest))
                frontier = [next(iter(side))]
        part = [0 if v in side else 1 for v in vs]
        part = _refine_cut_sub(vs, part)
        a = [v for v, p in zip(vs, part) if p == 0]
        b = [v for v, p in zip(vs, part) if p == 1]
        if not a or not b:
            half = len(vs) // 2
            a, b = vs[:half], vs[half:]
        return a, b

    def _refine_cut_sub(vs: list[int], part: list[int]) -> list[int]:
        pos = {v: i for i, v in enumerate(vs)}
        n = len(vs)

        def gain(i: int) -> int:
            g = 0
            for u in adj[vs[i]]:
                j = pos.get(u)
                if j is not None:
                    g += 1 if part[j] != part[i] else -1
            return g

        for _ in range(4):
            moved = False
            sizes = [part.count(0), part.count(1)]
            for i in sorted(range(n), key=gain, reverse=True):
                g = gain(i)
                src = part[i]
                if g > 0 and sizes[src] - 1 >= max(1, int(0.4 * n)):
                    part[i] = 1 - src
                    sizes[src] -= 1
                    sizes[1 - src] += 1
                    moved = True
            if not moved:
                break
        return part

    def groups(vs: list[int]) -> list:
        if len(vs) <= leaf_size:
            return vs  # leaf group
        a, b = bisect(vs)
        return [groups(a), groups(b)]

    hierarchy = groups(list(range(tn.num_tensors)))

    # emit contractions: within each leaf group greedily (by shared-index
    # result size), then join group representatives pairwise up the tree.
    masks: dict[int, int] = {i: m for i, m in enumerate(tn.masks)}
    open_m = tn.open_mask
    ssa_counter = [tn.num_tensors]
    path: list[tuple[int, int]] = []

    def result(ma: int, mb: int) -> int:
        return (ma ^ mb) | (ma & mb & open_m)

    def contract_ids(ids: list[int]) -> int:
        ids = list(ids)
        while len(ids) > 1:
            best = None
            best_s = float("inf")
            for i in range(len(ids)):
                for j in range(i + 1, len(ids)):
                    ma, mb = masks[ids[i]], masks[ids[j]]
                    shared = popcount(ma & mb & ~open_m)
                    s = 2.0 ** popcount(result(ma, mb))
                    s = s if shared else s * 1e6  # prefer connected pairs
                    if s < best_s:
                        best_s, best = s, (i, j)
            i, j = best
            a, b = ids[i], ids[j]
            nid = ssa_counter[0]
            ssa_counter[0] += 1
            masks[nid] = result(masks[a], masks[b])
            path.append((a, b))
            ids = [x for k, x in enumerate(ids) if k not in (i, j)] + [nid]
        return ids[0]

    def emit(h) -> int:
        if isinstance(h, list) and len(h) == 2 and isinstance(h[0], list):
            a = emit(h[0])
            b = emit(h[1])
            nid = ssa_counter[0]
            ssa_counter[0] += 1
            masks[nid] = result(masks[a], masks[b])
            path.append((a, b))
            return nid
        # leaf group (flat list of ints)
        return contract_ids(h if isinstance(h, list) else [h])

    emit(hierarchy)
    return path


# ----------------------------------------------------------------------
# exact DP (test oracle for small networks)
# ----------------------------------------------------------------------
def dp_optimal_tree(tn: TensorNetwork) -> ContractionTree:
    """Exact minimum-C(B) tree over all binary contraction orders.

    Subset DP over tensors; feasible up to ~13 tensors.
    """
    n = tn.num_tensors
    if n > 14:
        raise ValueError("dp_optimal_tree limited to <= 14 tensors")
    open_m = tn.open_mask
    full_masks = list(tn.masks)

    # union of index occurrences per subset, to derive the subset's result
    # mask: an index survives iff it appears an odd number of... no — degree
    # model: index appears in exactly 2 tensors; survives the subset iff
    # exactly one owner is inside (or it is open).
    owners0: dict[int, list[int]] = {}
    for i, m in enumerate(full_masks):
        for b in bits(m):
            owners0.setdefault(b, []).append(i)

    def subset_mask(ss: int) -> int:
        out = 0
        for b, ow in owners0.items():
            inside = sum(1 for i in ow if ss >> i & 1)
            if inside == 0:
                continue
            if (1 << b) & open_m:
                out |= 1 << b
            elif inside < len(ow):
                out |= 1 << b
        return out

    smask_cache = {1 << i: full_masks[i] for i in range(n)}
    cost: dict[int, float] = {1 << i: 0.0 for i in range(n)}
    plan: dict[int, tuple[int, int] | None] = {1 << i: None for i in range(n)}

    by_size: list[list[int]] = [[] for _ in range(n + 1)]
    for ss in range(1, 1 << n):
        by_size[ss.bit_count()].append(ss)

    for size in range(2, n + 1):
        for ss in by_size[size]:
            best = float("inf")
            bplan = None
            sub = (ss - 1) & ss
            while sub:
                other = ss ^ sub
                if sub < other:  # canonical split order; visit each once
                    if sub in cost and other in cost:
                        ma = smask_cache.setdefault(sub, subset_mask(sub))
                        mb = smask_cache.setdefault(other, subset_mask(other))
                        c = (
                            cost[sub]
                            + cost[other]
                            + 2.0 ** popcount(ma | mb)
                        )
                        if c < best:
                            best = c
                            bplan = (sub, other)
                sub = (sub - 1) & ss
            if bplan is not None:
                cost[ss] = best
                plan[ss] = bplan
                smask_cache.setdefault(ss, subset_mask(ss))

    # reconstruct ssa path
    ssa_of: dict[int, int] = {1 << i: i for i in range(n)}
    counter = [n]
    path: list[tuple[int, int]] = []

    def build(ss: int) -> int:
        if plan[ss] is None:
            return ssa_of[ss]
        a, b = plan[ss]
        ia, ib = build(a), build(b)
        nid = counter[0]
        counter[0] += 1
        path.append((ia, ib))
        ssa_of[ss] = nid
        return nid

    build((1 << n) - 1)
    return ContractionTree.from_ssa_path(tn, path)
