"""Lifetime of indices and quantitative stem detection (Secs. III-A/III-C).

Definitions (paper):
  * lifetime(k)   — the set of tree edges (tensors) whose index set contains
                    k.  By conservation (Lemma 1) this is exactly the
                    leaf-to-leaf path between the two input tensors that own
                    k (Theorem 1).
  * correlated contractions(k) — the tree nodes on that path.
  * stem          — the leaf-to-leaf path of maximum total contraction cost
                    (the paper's quantitative generalization of Alibaba's
                    observed stem).  Branches are the off-path subtrees.

The :class:`Stem` view linearizes the stem: ``tensors[i]`` are the tree-edge
ids along the path (dims rise toward the apex and fall after it), and
``nodes[i]`` joins ``tensors[i]`` and ``tensors[i+1]``.  The intersection of
any index's lifetime with the stem is a contiguous interval of positions
(intersection of two tree paths is a path) — this is what makes the
in-place sliceFinder linear-time.
"""

from __future__ import annotations

import dataclasses

from .contraction_tree import ContractionTree
from .tensor_network import bits, popcount


def lifetime_edges(tree: ContractionTree, bit: int) -> list[int]:
    """All tree edges (node ids, incl. leaves) whose tensor contains index
    ``bit``."""
    m = 1 << bit
    return [v for v, em in tree.emask.items() if em & m]


def lifetime_closure(tree: ContractionTree, smask: int) -> set[int]:
    """Slice-dependent node set for a slicing mask ``S``: every tree node
    (leaf or internal) whose subtree result depends on the bit assignment
    of some index in ``smask``.

    This is the upward closure (toward the root) of the union of the
    sliced indices' lifetimes: by Thm. 1 each lifetime is the leaf-to-leaf
    path between the index's two owners, and every ancestor of that path
    inherits the dependence even after the index has been contracted away
    inside the subtree.  The complement — nodes with no sliced index in
    their lifetime-closure — is the slice-invariant prologue of two-phase
    execution: those contractions are identical across all 2^|S| subtasks
    and can be hoisted out of the slice loop (Sec. III, Eq. 4 — the
    interpretable part of the slicing overhead)."""
    dependent: set[int] = set()
    for v, em in tree.emask.items():
        if tree.is_leaf(v) and em & smask:
            dependent.add(v)
    for v in tree.contract_order():
        l, r = tree.children[v]
        if l in dependent or r in dependent:
            dependent.add(v)
    return dependent


def correlated_contractions(tree: ContractionTree, bit: int) -> list[int]:
    m = 1 << bit
    return [v for v in tree.children if tree.node_mask(v) & m]


def step_lifetimes(
    steps: list[tuple[int, int, int]],
    entry: tuple[int, ...],
    outputs: tuple[int, ...] = (),
) -> tuple[dict[int, int], dict[int, int]]:
    """(birth, death) step indices for every buffer of an execution
    segment — the *buffer* counterpart of the paper's index lifetimes
    (Thm. 1 is about when an index exists; this is about when a tensor
    occupies memory).

    ``steps`` are ``(lhs, rhs, out)`` node ids in execution order;
    ``entry`` buffers (leaf arrays, hoisted frontier tensors) are born at
    step ``-1``.  A buffer dies at the step that consumes it — in a
    contraction *tree* every node has exactly one consumer — except the
    segment ``outputs`` (and any never-consumed entry), which live to the
    segment end.  A buffer is live at step ``t`` iff
    ``birth[v] <= t <= death[v]``: during step ``t`` both inputs and the
    output are resident simultaneously (an out-of-place GEMM cannot
    alias its operands), which is what makes these closed intervals the
    exact live-set algebra for the planner in
    :mod:`repro_torch.lowering.memory`.
    """
    end = len(steps)
    birth = {v: -1 for v in entry}
    death = {v: end for v in entry}
    for t, (lhs, rhs, out) in enumerate(steps):
        birth[out] = t
        death[out] = end
        death[lhs] = t
        death[rhs] = t
    for v in outputs:
        death[v] = end
    return birth, death


def leaf_path(tree: ContractionTree, a: int, b: int) -> tuple[list[int], list[int]]:
    """The unique tree path between leaves ``a`` and ``b``.

    Returns (tensors, nodes): tensors are the tree-edge ids along the path
    (starting at ``a``, ending at ``b``), nodes are the internal nodes
    joining consecutive tensors (len(nodes) == len(tensors) - 1).
    """
    anc_a = [a]
    v = a
    while v in tree.parent:
        v = tree.parent[v]
        anc_a.append(v)
    pos = {v: i for i, v in enumerate(anc_a)}
    chain_b = [b]
    v = b
    while v not in pos:
        v = tree.parent[v]
        chain_b.append(v)
    apex = v
    chain_b.pop()  # drop apex itself: it is a *node*, not a path tensor
    a_side = anc_a[: pos[apex]]  # tensors a .. child-of-apex (a side)
    tensors = a_side + list(reversed(chain_b))
    # nodes: on the a-side the parent of each tensor; then the apex; then on
    # the b-side each tensor *is* the node producing the next one.
    nodes: list[int] = []
    for i in range(len(a_side) - 1):
        nodes.append(tree.parent[a_side[i]])
    nodes.append(apex)
    for t in reversed(chain_b[1:]):
        nodes.append(t)
    assert len(nodes) == len(tensors) - 1
    return tensors, nodes


@dataclasses.dataclass
class Stem:
    """Linearized stem view over a contraction tree."""

    tree: ContractionTree
    tensors: list[int]  # tree-edge ids along the path
    nodes: list[int]  # joining nodes, len == len(tensors) - 1
    apex_pos: int  # index into ``nodes`` of the apex

    # ------------------------------------------------------------------
    def masks(self) -> list[int]:
        return [self.tree.emask[t] for t in self.tensors]

    def dims(self) -> list[int]:
        return [popcount(m) for m in self.masks()]

    def node_cost_log2(self, i: int) -> int:
        return popcount(self.tree.node_mask(self.nodes[i]))

    def branch_of(self, i: int) -> int | None:
        """The off-path child subtree absorbed at ``nodes[i]`` (None at the
        apex, whose both children are on the path)."""
        if i == self.apex_pos:
            return None
        n = self.nodes[i]
        on_path = {self.tensors[i], self.tensors[i + 1]}
        l, r = self.tree.children[n]
        if l not in on_path:
            return l
        if r not in on_path:
            return r
        return None

    def total_cost(self) -> float:
        return sum(
            2.0 ** popcount(self.tree.node_mask(n)) for n in self.nodes
        )

    def index_intervals(self) -> dict[int, tuple[int, int]]:
        """For every index bit present on the stem, its contiguous position
        interval [lo, hi] (inclusive) over ``tensors``.  This is the
        stem-scoped lifetime."""
        lo: dict[int, int] = {}
        hi: dict[int, int] = {}
        for pos, m in enumerate(self.masks()):
            for b in bits(m):
                if b not in lo:
                    lo[b] = pos
                hi[b] = pos
        return {b: (lo[b], hi[b]) for b in lo}

    def check_contiguous(self) -> None:
        """Property check: every index occupies a contiguous stem segment."""
        for b, (l, h) in self.index_intervals().items():
            m = 1 << b
            for p in range(l, h + 1):
                assert self.tree.emask[self.tensors[p]] & m, (
                    f"lifetime of bit {b} not contiguous on stem at {p}"
                )

    # adjacency info needed for exchange/merge surgery ------------------
    def exchange_args(self, i: int) -> tuple[int, int, int, int] | None:
        """Arguments (p, q, branch_q, branch_p) to swap the branches of
        ``nodes[i]`` and ``nodes[i+1]`` via tree.exchange_at, or None when
        the pair straddles the apex (chain broken there) or lacks a
        branch."""
        if i + 1 >= len(self.nodes):
            return None
        if self.apex_pos in (i, i + 1):
            return None
        b0, b1 = self.branch_of(i), self.branch_of(i + 1)
        if b0 is None or b1 is None:
            return None
        n0, n1 = self.nodes[i], self.nodes[i + 1]
        if i + 1 <= self.apex_pos:  # a-side: parent(n0) == n1
            if self.tree.parent.get(n0) != n1:
                return None
            return (n1, n0, b0, b1)
        else:  # b-side: parent(n1) == n0
            if self.tree.parent.get(n1) != n0:
                return None
            return (n0, n1, b1, b0)


def detect_stem(tree: ContractionTree) -> Stem:
    """Quantitative stem: leaf-to-leaf path maximizing summed node cost.

    Classic two-pass tree DP (max node-weighted path), O(n).
    """
    order = tree.contract_order()  # post-order: children before parents
    down: dict[int, float] = {}
    down_leaf: dict[int, int] = {}
    for v in tree.emask:
        if tree.is_leaf(v):
            down[v] = 0.0
            down_leaf[v] = v
    best_val = -1.0
    best_apex = None
    for v in order:
        l, r = tree.children[v]
        c = 2.0 ** popcount(tree.node_mask(v))
        if down[l] >= down[r]:
            down[v] = c + down[l]
            down_leaf[v] = down_leaf[l]
        else:
            down[v] = c + down[r]
            down_leaf[v] = down_leaf[r]
        through = c + down[l] + down[r]
        if through > best_val:
            best_val = through
            best_apex = v
    l, r = tree.children[best_apex]
    leaf_a, leaf_b = down_leaf[l], down_leaf[r]
    tensors, nodes = leaf_path(tree, leaf_a, leaf_b)
    apex_pos = nodes.index(best_apex)
    return Stem(tree, tensors, nodes, apex_pos)
