"""Rooted binary contraction trees with the paper's complexity algebra.

A contraction tree B = (N_B, E_B): every tree edge carries the index set of
an (input or intermediate) tensor, every internal node is a pairwise
contraction.  We keep the paper's quantities:

  width  W(B)   = max_e |s_e|                       (Eq. 2, log2 memory)
  cost   C(B)   = sum_node 2^{|s_node|}             (Eq. 3)
  sliced C(B,S) = sum_node 2^{|s_node|+|S|-|S∩s_node|}   (Eq. 6)

Index sets are int bitmasks (see tensor_network.py).  The tree is mutable:
branch exchange and branch merging (Secs. IV-C / V-B) are local surgeries
with incremental mask updates.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from .tensor_network import TensorNetwork, bits, popcount


class ContractionTree:
    """Binary contraction tree over a :class:`TensorNetwork`.

    Leaves are node ids ``0..n-1`` (matching ``tn.inputs``); internal nodes
    get fresh ids.  ``emask[v]`` is the index bitmask of the tensor produced
    by the subtree rooted at ``v`` (for leaves: the input tensor's mask).
    """

    def __init__(self, tn: TensorNetwork):
        self.tn = tn
        n = tn.num_tensors
        self.children: dict[int, tuple[int, int]] = {}
        self.parent: dict[int, int] = {}
        self.emask: dict[int, int] = {i: tn.masks[i] for i in range(n)}
        self.root: int | None = None
        self._next_id = n

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_ssa_path(
        cls, tn: TensorNetwork, ssa_path: Sequence[tuple[int, int]]
    ) -> "ContractionTree":
        """Build from an SSA path: leaves are 0..n-1; contraction ``k``
        combines two existing ssa ids and produces ssa id ``n + k``."""
        t = cls(tn)
        if tn.num_tensors == 1:
            t.root = 0
            return t
        if len(ssa_path) != tn.num_tensors - 1:
            raise ValueError(
                f"path has {len(ssa_path)} contractions for "
                f"{tn.num_tensors} tensors"
            )
        for a, b in ssa_path:
            t._contract(a, b)
        t.root = t._next_id - 1
        return t

    def _result_mask(self, ma: int, mb: int) -> int:
        open_m = self.tn.open_mask
        return (ma ^ mb) | (ma & mb & open_m)

    def _contract(self, a: int, b: int) -> int:
        nid = self._next_id
        self._next_id += 1
        self.children[nid] = (a, b)
        self.parent[a] = nid
        self.parent[b] = nid
        self.emask[nid] = self._result_mask(self.emask[a], self.emask[b])
        return nid

    def is_leaf(self, v: int) -> bool:
        return v not in self.children

    # ------------------------------------------------------------------
    # complexity algebra
    # ------------------------------------------------------------------
    def node_mask(self, v: int) -> int:
        """s_node = union of the two contracted tensors' indices."""
        l, r = self.children[v]
        return self.emask[l] | self.emask[r]

    def internal_nodes(self) -> list[int]:
        return list(self.children.keys())

    def width(self) -> int:
        return max(popcount(m) for m in self.emask.values())

    def node_cost(self, v: int) -> float:
        """2^|s_node| — one term of Eq. 3."""
        return 2.0 ** popcount(self.node_mask(v))

    def cost_log2s(self) -> dict[int, int]:
        return {v: popcount(self.node_mask(v)) for v in self.children}

    def total_cost(self) -> float:
        return sum(2.0 ** popcount(self.node_mask(v)) for v in self.children)

    def log2_total_cost(self) -> float:
        import math

        return math.log2(self.total_cost())

    def sliced_cost(self, smask: int) -> float:
        """Eq. 6: total cost over all 2^|S| subtasks."""
        s = popcount(smask)
        tot = 0.0
        for v in self.children:
            nm = self.node_mask(v)
            tot += 2.0 ** (popcount(nm) + s - popcount(smask & nm))
        return tot

    def slicing_overhead(self, smask: int) -> float:
        """Eq. 4: O(B,S) = C_slice(B)·2^|S| / C(B)."""
        return self.sliced_cost(smask) / self.total_cost()

    def sliced_width(self, smask: int) -> int:
        return max(popcount(m & ~smask) for m in self.emask.values())

    # ------------------------------------------------------------------
    # traversal / export
    # ------------------------------------------------------------------
    def contract_order(self) -> list[int]:
        """Internal nodes in a valid (post-order) execution order."""
        order: list[int] = []
        stack = [(self.root, False)]
        while stack:
            v, done = stack.pop()
            if self.is_leaf(v):
                continue
            if done:
                order.append(v)
            else:
                l, r = self.children[v]
                stack.append((v, True))
                stack.append((r, False))
                stack.append((l, False))
        return order

    def leaves_under(self, v: int) -> list[int]:
        out: list[int] = []
        stack = [v]
        while stack:
            u = stack.pop()
            if self.is_leaf(u):
                out.append(u)
            else:
                stack.extend(self.children[u])
        return out

    def check_valid(self) -> None:
        """Structural invariants (used by property tests)."""
        leaves = sorted(self.leaves_under(self.root))
        assert leaves == list(range(self.tn.num_tensors)), "leaf cover broken"
        for v, (l, r) in self.children.items():
            assert self.parent[l] == v and self.parent[r] == v
            expect = self._result_mask(self.emask[l], self.emask[r])
            assert self.emask[v] == expect, f"stale mask at node {v}"

    def copy(self) -> "ContractionTree":
        t = ContractionTree(self.tn)
        t.children = dict(self.children)
        t.parent = dict(self.parent)
        t.emask = dict(self.emask)
        t.root = self.root
        t._next_id = self._next_id
        return t

    # ------------------------------------------------------------------
    # local surgery (branch exchange / merge) — Secs. IV-C, V-B
    # ------------------------------------------------------------------
    def _replace_child(self, p: int, old: int, new: int) -> None:
        l, r = self.children[p]
        self.children[p] = (new, r) if l == old else (l, new)
        self.parent[new] = p

    def _refresh_up(self, v: int) -> None:
        """Recompute emasks from ``v`` up to the root (stops early when a
        mask is unchanged)."""
        while v is not None and v in self.children:
            l, r = self.children[v]
            m = self._result_mask(self.emask[l], self.emask[r])
            if m == self.emask[v]:
                return
            self.emask[v] = m
            v = self.parent.get(v)

    def exchange_at(self, p: int, q: int, branch_q: int, branch_p: int) -> None:
        """Exchange ``branch_q`` (child of q) with ``branch_p`` (child of p),
        where p is the parent of q.  The spine child of q stays put."""
        assert self.parent[q] == p
        assert branch_q in self.children[q], "stale branch id"
        assert branch_p in self.children[p], "stale branch id"
        self._replace_child(q, branch_q, branch_p)
        self._replace_child(p, branch_p, branch_q)
        # q's result changes; p's does not (same leaves), but refresh both
        # for safety (refresh stops as soon as masks stabilize).
        l, r = self.children[q]
        self.emask[q] = self._result_mask(self.emask[l], self.emask[r])
        self._refresh_up(p)

    def merge_branches_at(self, p: int, q: int, branch_q: int, branch_p: int) -> int:
        """Pre-contract two adjacent branches (Sec. V-B):

        q = (T, B1), p = (q, B2)  →  p' = (T, M), M = (B1, B2).

        Node q is re-purposed as the merge node M to keep ids stable.
        Returns the id of the merge node.
        """
        assert self.parent[q] == p
        assert branch_q in self.children[q], "stale branch id"
        assert branch_p in self.children[p], "stale branch id"
        spine = [c for c in self.children[q] if c != branch_q][0]
        # rewire: p takes the spine tensor directly plus the merged branch
        self.children[q] = (branch_q, branch_p)
        self.parent[branch_p] = q
        self.parent[branch_q] = q
        self.children[p] = (spine, q)
        self.parent[spine] = p
        self.parent[q] = p
        l, r = self.children[q]
        self.emask[q] = self._result_mask(self.emask[l], self.emask[r])
        self._refresh_up(p)
        return q

    # ------------------------------------------------------------------
    # subtree splice (reconfiguration surgery for the anytime co-optimizer)
    # ------------------------------------------------------------------
    def subtree_frontier(self, v: int, max_roots: int = 8) -> list[int]:
        """A frontier of subtree roots under ``v``: start from v's two
        children and repeatedly expand the *most expensive* internal
        frontier member until ``max_roots`` roots (or all leaves).  The
        frontier partitions the leaves under ``v``, so any pairwise
        order over it rebuilds a valid subtree with the same result
        mask.  Deterministic (ties broken by node id)."""
        assert not self.is_leaf(v), "frontier needs an internal node"
        frontier = list(self.children[v])
        while len(frontier) < max_roots:
            cands = [u for u in frontier if not self.is_leaf(u)]
            if not cands:
                break
            u = max(cands, key=lambda u_: (self.node_cost(u_), u_))
            frontier.remove(u)
            frontier.extend(self.children[u])
        return frontier

    def _internal_between(self, v: int, frontier: Sequence[int]) -> list[int]:
        """Internal nodes of the subtree at ``v`` above the frontier
        (``v`` included, frontier roots excluded)."""
        stop = set(frontier)
        out: list[int] = []
        stack = [v]
        while stack:
            u = stack.pop()
            assert not self.is_leaf(u), "frontier does not cover subtree"
            out.append(u)
            for c in self.children[u]:
                if c not in stop:
                    stack.append(c)
        return out

    def splice_subtree(
        self,
        v: int,
        frontier: Sequence[int],
        ssa_pairs: Sequence[tuple[int, int]],
    ) -> "SpliceResult":
        """Rebuild the internal structure joining ``frontier`` up to ``v``
        along a new pairwise order, in place.

        ``ssa_pairs`` is an SSA path over *positions*: entry ``j`` pairs
        two members of the growing list ``frontier + results``, its
        result taking position ``len(frontier) + j``.  The freed internal
        ids are recycled (the last rebuilt node is ``v`` itself, so the
        linkage above ``v`` never changes), and ``emask[v]`` is invariant
        — the leaf set under ``v`` is untouched — so no upward refresh is
        needed.  Returns a :class:`SpliceResult` carrying the undo record
        and the local Eq. 3 cost delta; :meth:`unsplice` reverts the
        surgery exactly."""
        frontier = list(frontier)
        internal = self._internal_between(v, frontier)
        if len(ssa_pairs) != len(frontier) - 1 or len(internal) != len(
            ssa_pairs
        ):
            raise ValueError(
                f"splice needs |frontier|-1 = {len(frontier) - 1} pairs "
                f"over {len(internal)} recycled ids"
            )
        # validate the whole SSA sequence BEFORE the first mutation, so a
        # bad input raises with the tree untouched (no undo needed)
        used: set[int] = set()
        for j, (pa, pb) in enumerate(ssa_pairs):
            if pa == pb or pa in used or pb in used:
                raise ValueError(f"ssa pair {j} reuses a position")
            if not (0 <= pa < len(frontier) + j and 0 <= pb < len(frontier) + j):
                raise ValueError(f"ssa pair {j} out of range")
            used.update((pa, pb))
        old_children = {u: self.children[u] for u in internal}
        old_emask = {u: self.emask[u] for u in internal}
        old_parent = {u: self.parent.get(u) for u in frontier}
        cost_before = sum(self.node_cost(u) for u in internal)
        # recycle ids; v must come last so the subtree root keeps its id
        recycled = sorted(u for u in internal if u != v) + [v]
        ids = list(frontier)
        for j, (pa, pb) in enumerate(ssa_pairs):
            a, b = ids[pa], ids[pb]
            nid = recycled[j]
            self.children[nid] = (a, b)
            self.parent[a] = nid
            self.parent[b] = nid
            self.emask[nid] = self._result_mask(self.emask[a], self.emask[b])
            ids.append(nid)
        assert ids[-1] == v
        assert self.emask[v] == old_emask[v], "leaf cover changed by splice"
        cost_after = sum(self.node_cost(u) for u in internal)
        return SpliceResult(
            v=v,
            frontier=tuple(frontier),
            rebuilt=tuple(recycled),
            old_children=old_children,
            old_emask=old_emask,
            old_parent=old_parent,
            cost_before=cost_before,
            cost_after=cost_after,
        )

    def unsplice(self, res: "SpliceResult") -> None:
        """Exactly revert a :meth:`splice_subtree` (cheap: only the
        rebuilt internal nodes and their child links are restored)."""
        for u, (l, r) in res.old_children.items():
            self.children[u] = (l, r)
            self.parent[l] = u
            self.parent[r] = u
            self.emask[u] = res.old_emask[u]
        for u, p in res.old_parent.items():
            if p is not None:
                self.parent[u] = p


@dataclasses.dataclass(frozen=True)
class SpliceResult:
    """Undo record + incremental deltas for one subtree splice."""

    v: int
    frontier: tuple[int, ...]
    rebuilt: tuple[int, ...]
    old_children: dict[int, tuple[int, int]]
    old_emask: dict[int, int]
    old_parent: dict[int, int | None]
    cost_before: float  # Σ 2^|s_node| over the rebuilt region, before
    cost_after: float  # … after — total_cost delta without a full resum

    @property
    def cost_delta(self) -> float:
        return self.cost_after - self.cost_before


def ssa_to_linear(ssa_path: Sequence[tuple[int, int]], n: int) -> list[tuple[int, int]]:
    """Convert an SSA path to opt_einsum-style linear format (positions in a
    shrinking list)."""
    ids = list(range(n))
    out = []
    for k, (a, b) in enumerate(ssa_path):
        ia, ib = ids.index(a), ids.index(b)
        if ia > ib:
            ia, ib = ib, ia
        out.append((ia, ib))
        ids.pop(ib)
        ids.pop(ia)
        ids.append(n + k)
    return out


def linear_to_ssa(linear_path: Sequence[tuple[int, int]], n: int) -> list[tuple[int, int]]:
    ids = list(range(n))
    out = []
    for k, (ia, ib) in enumerate(linear_path):
        if ia > ib:
            ia, ib = ib, ia
        a, b = ids[ia], ids[ib]
        out.append((a, b))
        ids.pop(ib)
        ids.pop(ia)
        ids.append(n + k)
    return out
