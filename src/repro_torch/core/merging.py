"""Architecture-aware path refinement: branch merging (Sec. V-B) and GEMM
orientation (Sec. V-C), priced on the card the port runs on.

A pairwise contraction is a GEMM: kept indices of the stem tensor form M,
kept indices of the branch form N, contracted indices form K.  Narrow GEMMs
(tiny N or K — ubiquitous on RQC stems, the paper observes k,n ≤ 4) fall
off the roofline on *any* wide-vector machine: the output tile is
quantized to the kernel's tile edge, and a narrow GEMM moves many bytes
per operation.

``F(M, N, K)`` below is the efficiency surface: achievable/peak FLOPs for
a GEMM, modelled as tile quantization capped by the device-memory
roofline.  The constants come from a :class:`~repro_torch.hardware.
Hardware` object (default :data:`~repro_torch.hardware.H100_SXM`).

Branch merging pre-contracts two neighbouring branches when the modelled
time (complexity / F, summed over slice multipliers, Eq. 10 generalized)
drops.  All improving merges are applied until a fixed point, as in the
paper.
"""

from __future__ import annotations

import dataclasses
import math

from ..hardware import DEFAULT_HARDWARE, Hardware
from .contraction_tree import ContractionTree
from .lifetime import detect_stem
from .tensor_network import popcount


def gemm_efficiency(
    m: float, n: float, k: float, hw: Hardware = DEFAULT_HARDWARE
) -> float:
    """F(M,N,K): fraction of peak for a (2^m × 2^k) @ (2^k × 2^n) GEMM.

    Tile-quantization × bandwidth-roofline model; arguments are log2 dims.
    """
    M, N, K = 2.0 ** m, 2.0 ** n, 2.0 ** k
    tile, peak, bw = hw.tile, hw.peak_flops, hw.mem_bw
    dtype_bytes = hw.merge_dtype_bytes

    def ceil_to(x: float, t: float) -> float:
        return max(t, math.ceil(x / t) * t)

    flops = 2.0 * M * N * K
    flops_padded = 2.0 * ceil_to(M, tile) * ceil_to(N, tile) * ceil_to(K, tile)
    t_compute = flops_padded / peak
    t_mem = dtype_bytes * (M * K + K * N + M * N) / bw
    t = max(t_compute, t_mem)
    return flops / (t * peak)


def contraction_gemm_shape(
    tree: ContractionTree, v: int
) -> tuple[int, int, int]:
    """(m, n, k) log2 GEMM dims of contraction node ``v``: M = kept of the
    bigger child, N = kept of the smaller, K = contracted."""
    l, r = tree.children[v]
    ml, mr = tree.emask[l], tree.emask[r]
    if popcount(ml) < popcount(mr):
        ml, mr = mr, ml
    open_m = tree.tn.open_mask
    shared = ml & mr & ~open_m
    k = popcount(shared)
    m = popcount(ml) - k
    n = popcount(mr) - k
    return m, n, k


def modeled_node_time(
    tree: ContractionTree, v: int, S: int, hw: Hardware = DEFAULT_HARDWARE,
    slice_fused: bool = False, slice_batched: bool = False,
) -> float:
    """Modelled wall time of node ``v``: 2^(|S| - |S∩nm|) repetitions of a
    sliced GEMM at F(M,N,K) efficiency.

    ``slice_fused`` (beyond-paper, §Perf): when a sliced index is
    *contracted* at this node (present in both children), the per-slice
    sum  C = Σ_s A_s·B_s  is algebraically one GEMM with the slice group
    concatenated along K — so the node runs at the efficiency of the
    UNSLICED K while doing identical FLOPs.  Narrow-K stems (the paper's
    Sec. V-A pathology, worse on the 128-wide MXU) get their K back.
    """
    nm = tree.node_mask(v)
    l, r = tree.children[v]
    ml, mr = tree.emask[l], tree.emask[r]
    if popcount(ml) < popcount(mr):
        ml, mr = mr, ml
    open_m = tree.tn.open_mask
    shared = ml & mr & ~open_m
    k_s = popcount(shared & ~S)
    m_s = popcount(ml & ~S) - k_s
    n_s = popcount(mr & ~S) - k_s
    fused_bits = popcount(shared & S) if slice_fused else 0
    mult = 2.0 ** (popcount(S) - popcount(S & nm))
    flops = 2.0 ** (m_s + n_s + k_s + fused_bits + 1)
    if slice_fused:
        mult /= 2.0 ** fused_bits  # the fused group runs as one GEMM
    # slice batching (beyond-paper, implemented by the executor's vmap):
    # when the absorbed operand carries no sliced index (branches "carry
    # few or zero sliced indices", Sec. III-D) every subtask shares the
    # stationary operand — the subtask group is one GEMM with the slice
    # batch concatenated along M.
    m_batch = 0.0
    if slice_batched and mult > 1 and (mr & S) == 0:
        m_batch = math.log2(mult)
    eff = gemm_efficiency(m_s + m_batch, n_s, k_s + fused_bits, hw)
    return mult * flops / (eff * hw.peak_flops)


def modeled_tree_time(
    tree: ContractionTree, S: int, hw: Hardware = DEFAULT_HARDWARE,
    slice_fused: bool = False, slice_batched: bool = False,
) -> float:
    """Σ over nodes of modeled_node_time (absolute seconds for one pass
    over all slices on one card)."""
    return sum(
        modeled_node_time(tree, v, S, hw, slice_fused, slice_batched)
        for v in tree.children
    )


@dataclasses.dataclass
class MergeResult:
    tree: ContractionTree
    merges: int
    time_before: float
    time_after: float


def merge_branches(
    tree: ContractionTree,
    S: int,
    hw: Hardware = DEFAULT_HARDWARE,
    max_passes: int = 10,
) -> MergeResult:
    """Apply all time-improving branch merges on the stem (Eq. 10
    generalized to the modelled F surface), repeating until fixed point."""
    work = tree.copy()
    t_before = modeled_tree_time(work, S, hw)
    merges = 0
    for _ in range(max_passes):
        stem = detect_stem(work)
        did = 0
        for i in range(len(stem.nodes) - 1):
            args = stem.exchange_args(i)  # same adjacency requirements
            if args is None:
                continue
            p, q, branch_q, branch_p = args
            # adjacency may be stale after an earlier merge in this sweep
            if work.parent.get(q) != p:
                continue
            if branch_q not in work.children.get(q, ()) or (
                branch_p not in work.children.get(p, ())
            ):
                continue
            before = modeled_node_time(work, p, S, hw) + modeled_node_time(
                work, q, S, hw
            )
            snapshot = work.copy()
            mid = work.merge_branches_at(p, q, branch_q, branch_p)
            after = modeled_node_time(work, p, S, hw) + modeled_node_time(
                work, mid, S, hw
            )
            if after < before:
                did += 1
            else:
                work = snapshot
        merges += did
        if did == 0:
            break
    return MergeResult(work, merges, t_before, modeled_tree_time(work, S, hw))


def orient_gemms(tree: ContractionTree) -> ContractionTree:
    """Sec. V-C analogue: order every node's children so the larger tensor
    takes the M role (stationary operand) — keeps stem GEMMs 'uphill'
    (N ≥ K) when executed end-to-end in post-order."""
    work = tree.copy()
    for v in list(work.children):
        l, r = work.children[v]
        if popcount(work.emask[l]) < popcount(work.emask[r]):
            work.children[v] = (r, l)
    return work
