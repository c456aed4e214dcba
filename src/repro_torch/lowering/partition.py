"""Lifetime-based two-phase partition of a sliced contraction tree.

The paper's central interpretability claim (Sec. III, Eq. 4) is that
slicing overhead is *localized*: only the contractions whose
lifetime-closure touches a sliced index change across the ``2^|S|``
subtasks.  Everything else — branch subtrees and stem segments untouched
by ``S`` — computes the exact same tensors in every subtask, so a naive
executor recomputes them ``2^|S|`` times for nothing.

This module turns that observation into an executable split.  Given a
:class:`~repro_torch.core.contraction_tree.ContractionTree` and a slicing mask,
:func:`partition_tree` classifies every node via
:func:`repro_torch.core.lifetime.lifetime_closure` and emits a
:class:`TreePartition`:

  * the **prologue** — slice-invariant internal nodes, executed once per
    plan with the full (unsliced) leaf arrays;
  * the **epilogue** — slice-dependent nodes, the only contractions run
    (and vmapped) inside the slice loop;
  * the **hoisted frontier** — maximal invariant subtree roots whose
    parent is slice-dependent: their materialized tensors are the buffer
    interface handed from the prologue to every epilogue invocation.

The partition also carries the executed-FLOPs accounting that makes the
runtime win measurable: ``hoisted_overhead() <= slicing_overhead`` (Eq.
4) always, with equality only when no node is invariant.
"""

from __future__ import annotations

import dataclasses

from ..core.contraction_tree import ContractionTree
from ..core.lifetime import lifetime_closure
from ..core.tensor_network import popcount


@dataclasses.dataclass(frozen=True)
class TreePartition:
    """Two-phase (prologue/epilogue) split of one ``(tree, S)`` pair.

    Node lists are in contraction (post-)order, so executing
    ``invariant_nodes`` then, per slice, ``epilogue_nodes`` respects every
    data dependency; ``hoisted_nodes ⊆ invariant_nodes`` is the cross-phase
    buffer interface (each one's parent is slice-dependent)."""

    smask: int
    num_sliced: int
    dependent: frozenset[int]  # lifetime-closure of S (leaves + internal)
    invariant_nodes: tuple[int, ...]  # prologue, contract order
    epilogue_nodes: tuple[int, ...]  # per-slice, contract order
    hoisted_nodes: tuple[int, ...]  # prologue outputs consumed per slice
    prologue_leaves: tuple[int, ...]  # leaves consumed by the prologue
    epilogue_leaves: tuple[int, ...]  # leaves consumed inside the slice loop
    invariant_cost: float  # sum of 2^|s_node| over invariant nodes
    per_slice_cost: float  # dependent cost of ONE subtask (Eq. 6 / 2^|S|)
    total_cost: float  # dense C(B) (Eq. 3)

    @property
    def n_slices(self) -> int:
        return 1 << self.num_sliced

    @property
    def invariant_fraction(self) -> float:
        """Fraction of the dense tree cost C(B) that is slice-invariant,
        i.e. hoistable out of the slice loop."""
        return self.invariant_cost / self.total_cost if self.total_cost else 0.0

    def hoisted_cost(self) -> float:
        """Executed FLOPs (in the paper's 2^|s| cost units) of two-phase
        execution: one prologue plus 2^|S| epilogues."""
        return self.invariant_cost + self.n_slices * self.per_slice_cost

    def naive_cost(self) -> float:
        """Eq. 6: what a naive executor runs — the full tree per slice."""
        return self.invariant_cost * self.n_slices + (
            self.n_slices * self.per_slice_cost
        )

    def hoisted_overhead(self) -> float:
        """Executed-FLOPs overhead of two-phase execution over the dense
        C(B) — the runtime counterpart of Eq. 4, always <= the naive
        ``tree.slicing_overhead(S)``."""
        return self.hoisted_cost() / self.total_cost if self.total_cost else 1.0

    def summary(self) -> dict:
        return {
            "num_sliced": self.num_sliced,
            "invariant_nodes": len(self.invariant_nodes),
            "epilogue_nodes": len(self.epilogue_nodes),
            "hoisted_buffers": len(self.hoisted_nodes),
            "invariant_fraction": self.invariant_fraction,
            "hoisted_overhead": self.hoisted_overhead(),
        }


def partition_tree(tree: ContractionTree, smask: int) -> TreePartition:
    """Classify every tree node as slice-invariant or slice-dependent and
    build the two-phase execution partition for ``(tree, smask)``."""
    dependent = lifetime_closure(tree, smask)
    order = tree.contract_order()
    invariant_nodes = tuple(v for v in order if v not in dependent)
    epilogue_nodes = tuple(v for v in order if v in dependent)

    # maximal invariant subtree roots: invariant internal nodes whose
    # parent runs in the slice loop (the root only qualifies when S is
    # empty, in which case the "prologue" is the whole tree).
    hoisted = tuple(
        v
        for v in invariant_nodes
        if tree.parent.get(v) is None or tree.parent[v] in dependent
    )
    prologue_leaves: list[int] = []
    epilogue_leaves: list[int] = []
    for i in range(tree.tn.num_tensors):
        p = tree.parent.get(i)
        if p is not None and p not in dependent:
            prologue_leaves.append(i)
        else:
            # sliced leaves (dependent themselves) and invariant leaves
            # feeding a dependent contraction both enter the slice loop;
            # the latter pass through unsliced (their slice spec is empty).
            epilogue_leaves.append(i)

    invariant_cost = per_slice = total = 0.0
    for v in tree.children:
        nm = tree.node_mask(v)
        c = 2.0 ** popcount(nm)
        total += c
        if v in dependent:
            per_slice += 2.0 ** (popcount(nm) - popcount(nm & smask))
        else:
            invariant_cost += c
    return TreePartition(
        smask=smask,
        num_sliced=popcount(smask),
        dependent=frozenset(dependent),
        invariant_nodes=invariant_nodes,
        epilogue_nodes=epilogue_nodes,
        hoisted_nodes=hoisted,
        prologue_leaves=tuple(prologue_leaves),
        epilogue_leaves=tuple(epilogue_leaves),
        invariant_cost=invariant_cost,
        per_slice_cost=per_slice,
        total_cost=total,
    )
