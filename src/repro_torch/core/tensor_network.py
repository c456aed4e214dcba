"""Tensor-network graph representation.

The planner side of the paper works on an undirected (multi-)graph
G = (V, E): vertices are tensors, edges are shared indices, and every edge
in an RQC network has weight 2 (qubit dimension). We keep the general
integer-weight form but the fast paths assume weight 2 (log2 size == index
count), matching the paper's complexity algebra (Eq. 2/3/6).

Index sets are represented as Python int bitmasks over a dense index space:
union/intersection/popcount are single machine ops, which is what makes the
lifetime/tuning inner loops cheap (the paper's "traverse all indices once").
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Hashable, Iterable, Mapping, Sequence


def popcount(mask: int) -> int:
    return mask.bit_count()


def bits(mask: int):
    """Iterate set bit positions of ``mask`` in ascending order."""
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


@dataclasses.dataclass(frozen=True)
class IndexSpace:
    """Dense bijection between user index labels and bit positions."""

    labels: tuple[Hashable, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "_pos", {lab: i for i, lab in enumerate(self.labels)}
        )

    def __len__(self) -> int:
        return len(self.labels)

    def bit(self, label: Hashable) -> int:
        return self._pos[label]

    def mask(self, labels: Iterable[Hashable]) -> int:
        m = 0
        for lab in labels:
            m |= 1 << self._pos[lab]
        return m

    def labels_of(self, mask: int) -> tuple[Hashable, ...]:
        return tuple(self.labels[b] for b in bits(mask))


class TensorNetwork:
    """A tensor network over binary (size-2) indices.

    Parameters
    ----------
    tensors: sequence of index-label tuples, one per tensor (ordered — the
        executor uses the ordering to map onto array axes).
    open_inds: output indices (appear in exactly one tensor; never
        contracted, never sliced).
    ind_sizes: optional per-index dimension (default 2 everywhere). The
        planner's log2 algebra requires uniform size 2; non-2 sizes are
        allowed only for executor-level generality.
    """

    def __init__(
        self,
        tensors: Sequence[Sequence[Hashable]],
        open_inds: Sequence[Hashable] = (),
        ind_sizes: Mapping[Hashable, int] | None = None,
    ):
        seen: dict[Hashable, None] = {}
        for t in tensors:
            for ix in t:
                seen.setdefault(ix, None)
        for ix in open_inds:
            if ix not in seen:
                raise ValueError(f"open index {ix!r} not present in any tensor")
        self.space = IndexSpace(tuple(seen.keys()))
        self.inputs: tuple[tuple[Hashable, ...], ...] = tuple(
            tuple(t) for t in tensors
        )
        self.open_inds: tuple[Hashable, ...] = tuple(open_inds)
        self.masks: tuple[int, ...] = tuple(
            self.space.mask(t) for t in self.inputs
        )
        self.open_mask: int = self.space.mask(self.open_inds)
        self.ind_sizes = dict(ind_sizes or {})
        # Degree check: every non-open index must appear exactly twice for
        # the graph (non-hyper) contraction model the paper uses.
        counts: dict[Hashable, int] = {}
        for t in self.inputs:
            for ix in t:
                counts[ix] = counts.get(ix, 0) + 1
            if len(set(t)) != len(t):
                raise ValueError(f"repeated index within one tensor: {t}")
        self.ind_degree = counts

    # ------------------------------------------------------------------
    @property
    def num_tensors(self) -> int:
        return len(self.inputs)

    @property
    def num_inds(self) -> int:
        return len(self.space)

    def size_of(self, ix: Hashable) -> int:
        return self.ind_sizes.get(ix, 2)

    def log2_size(self, mask: int) -> int:
        """log2 of the tensor size for an index mask (uniform size-2)."""
        return popcount(mask)

    def is_hyper(self) -> bool:
        return any(
            d > 2 or (d > 1 and ix in self.open_inds)
            for ix, d in self.ind_degree.items()
        )

    # ------------------------------------------------------------------
    def neighbors(self) -> list[list[int]]:
        """Adjacency between tensors that share at least one index."""
        adj: list[list[int]] = [[] for _ in range(self.num_tensors)]
        by_ind: dict[Hashable, list[int]] = {}
        for i, t in enumerate(self.inputs):
            for ix in t:
                by_ind.setdefault(ix, []).append(i)
        pair_seen = set()
        for ix, owners in by_ind.items():
            for a, b in itertools.combinations(owners, 2):
                if (a, b) not in pair_seen:
                    pair_seen.add((a, b))
                    adj[a].append(b)
                    adj[b].append(a)
        return adj

    # ------------------------------------------------------------------
    def simplify_low_rank(self) -> tuple["TensorNetwork", list[tuple[int, int]]]:
        """Absorb rank-1/rank-2 tensors into a neighbour (Cotengra-style
        pre-processing).  Returns (new_network, merge_log) where merge_log
        records (absorbed, into) positions in the *original* numbering.

        Only the graph structure is simplified here; the executor applies
        the same merge log to concrete arrays.
        """
        inputs = [list(t) for t in self.inputs]
        alive = [True] * len(inputs)
        merge_log: list[tuple[int, int]] = []
        changed = True
        while changed:
            changed = False
            by_ind: dict[Hashable, list[int]] = {}
            for i, t in enumerate(inputs):
                if alive[i]:
                    for ix in t:
                        by_ind.setdefault(ix, []).append(i)
            for i, t in enumerate(inputs):
                if not alive[i] or len(t) > 2:
                    continue
                closed = [ix for ix in t if ix not in self.open_inds]
                if not closed:
                    continue
                partners = [j for j in by_ind.get(closed[0], []) if j != i]
                if not partners:
                    continue
                j = partners[0]
                if not alive[j]:
                    continue
                shared = set(t) & set(inputs[j])
                shared -= set(self.open_inds)
                new_t = [ix for ix in inputs[j] if ix not in shared] + [
                    ix for ix in t if ix not in shared and ix not in inputs[j]
                ]
                inputs[j] = new_t
                alive[i] = False
                merge_log.append((i, j))
                changed = True
                break
        new_inputs = [t for i, t in enumerate(inputs) if alive[i]]
        tn = TensorNetwork(new_inputs, self.open_inds, self.ind_sizes)
        return tn, merge_log


def random_regular_tn(
    num_tensors: int, degree: int, seed: int = 0
) -> TensorNetwork:
    """A random degree-regular closed tensor network (for tests/benchmarks).

    Builds a random multigraph where every vertex has ``degree`` incident
    binary indices, i.e. every tensor is a ``degree``-dimensional tensor.
    """
    import random

    rng = random.Random(seed)
    stubs = [v for v in range(num_tensors) for _ in range(degree)]
    for _ in range(100):
        rng.shuffle(stubs)
        ok = all(
            stubs[2 * i] != stubs[2 * i + 1] for i in range(len(stubs) // 2)
        )
        if ok:
            break
    tensors: list[list[str]] = [[] for _ in range(num_tensors)]
    for e in range(len(stubs) // 2):
        a, b = stubs[2 * e], stubs[2 * e + 1]
        if a == b:  # drop self loops from the final failed shuffle
            continue
        name = f"e{e}"
        tensors[a].append(name)
        tensors[b].append(name)
    return TensorNetwork([t for t in tensors if t])
