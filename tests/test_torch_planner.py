"""The port's planner against the JAX reference: with the reference's
cost constants injected through a Hardware object, the same seeds give
the same trees, slicing masks, partitions, memory-plan peaks, GEMM
schedules and chain plans."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import merging as ref_merging  # noqa: E402
from repro.core.api import plan_contraction as ref_plan_contraction  # noqa: E402
from repro.core.executor import ContractionPlan as RefPlan  # noqa: E402
from repro.core.executor import simplify_network as ref_simplify  # noqa: E402
from repro.core.pathfinder import random_greedy_tree as ref_greedy  # noqa: E402
from repro.core.slicing import find_slices as ref_find_slices  # noqa: E402
from repro.lowering import memory as ref_memory  # noqa: E402
from repro.lowering import refiner as ref_refiner  # noqa: E402
from repro.lowering.partition import partition_tree as ref_partition  # noqa: E402
from repro.quantum import circuits as ref_circuits  # noqa: E402

from repro_torch.core import merging  # noqa: E402
from repro_torch.core.api import plan_contraction  # noqa: E402
from repro_torch.core.executor import ContractionPlan, simplify_network  # noqa: E402
from repro_torch.core.pathfinder import random_greedy_tree  # noqa: E402
from repro_torch.core.slicing import find_slices  # noqa: E402
from repro_torch.hardware import H100_SXM, Hardware  # noqa: E402
from repro_torch.lowering import memory, refiner  # noqa: E402
from repro_torch.lowering.gemm_form import GemmForm  # noqa: E402
from repro_torch.lowering.partition import partition_tree  # noqa: E402
from repro_torch.quantum import circuits  # noqa: E402

# the reference's own cost constants, read from the reference package
REF_HW = Hardware(
    name="reference",
    peak_flops=ref_merging.TPU_PEAK_FLOPS,
    mem_bw=ref_merging.TPU_HBM_BW,
    tile=ref_merging.TPU_MXU,
    merge_dtype_bytes=2.0,
    block_candidates=ref_refiner.BLOCK_CANDIDATES,
    tile_budget_bytes=ref_refiner.VMEM_BUDGET_BYTES,
    chain_budget_bytes=ref_refiner.CHAIN_VMEM_BUDGET_BYTES,
    non_kernel_peak_fraction=ref_refiner.NON_MXU_PEAK_FRACTION,
    einsum_flops_floor=ref_refiner.EINSUM_FLOPS_FLOOR,
    # the reference's bf16 rule: twice the matrix rate (and half the
    # operand bytes, which the refiner's cost model applies itself)
    bf16_peak_flops=2.0 * ref_merging.TPU_PEAK_FLOPS,
)
BACKEND_NAMES = {"pallas": "tiled", "pallas_fused": "fused"}


def _networks(rows, cols, cycles, seed=0, open_qubits=None):
    n = rows * cols
    bits = "0" * n
    kw = {"bitstring": bits}
    if open_qubits is not None:
        kw["open_qubits"] = open_qubits
    ref = ref_simplify(*ref_circuits.circuit_to_network(
        ref_circuits.sycamore_like(rows, cols, cycles, seed=seed), **kw))
    port = simplify_network(*circuits.circuit_to_network(
        circuits.sycamore_like(rows, cols, cycles, seed=seed), **kw))
    return ref, port


def _as_port_form(form) -> GemmForm:
    return GemmForm(**dataclasses.asdict(form))


PLAN_CASES = [
    # rows, cols, cycles, target_dim, seed, open qubits
    (3, 4, 8, 8, 0, None),
    (4, 4, 10, 10, 1, None),
    (4, 4, 10, 10, 0, (14, 15)),
    (4, 5, 12, 14, 0, None),
]


@pytest.mark.parametrize("rows,cols,cycles,target,seed,open_q", PLAN_CASES)
def test_oneshot_plan_identical(rows, cols, cycles, target, seed, open_q):
    (tn_r, _), (tn_p, _) = _networks(rows, cols, cycles, seed, open_q)
    tree_r, s_r, rep_r = ref_plan_contraction(tn_r, target, seed=seed)
    tree_p, s_p, rep_p = plan_contraction(tn_p, target, seed=seed, hw=REF_HW)
    assert tree_p.children == tree_r.children
    assert tree_p.root == tree_r.root
    assert s_p == s_r
    for f in ("width_before", "width_after", "num_sliced", "peak_bytes",
              "peak_bytes_hoisted", "buffer_slots"):
        assert getattr(rep_p, f) == getattr(rep_r, f), f
    assert rep_p.log2_sliced_cost == pytest.approx(rep_r.log2_sliced_cost)
    assert rep_p.modeled_time_s == pytest.approx(rep_r.modeled_time_s)
    if s_r:
        pr, pp = ref_partition(tree_r, s_r), partition_tree(tree_p, s_p)
        for f in ("invariant_nodes", "epilogue_nodes", "hoisted_nodes",
                  "prologue_leaves", "epilogue_leaves"):
            assert getattr(pp, f) == getattr(pr, f), f
        assert pp.hoisted_overhead() == pytest.approx(pr.hoisted_overhead())


@pytest.mark.parametrize("rows,cols,cycles,target,seed,open_q", PLAN_CASES)
def test_schedule_and_chains_identical(rows, cols, cycles, target, seed, open_q):
    """Same GemmForms, same backends (renamed), same block shapes and
    modeled times, same chain plans, same memory plan."""
    (tn_r, _), (tn_p, _) = _networks(rows, cols, cycles, seed, open_q)
    tree_r, s_r, _ = ref_plan_contraction(tn_r, target, seed=seed)
    tree_p, s_p, _ = plan_contraction(tn_p, target, seed=seed, hw=REF_HW)
    ref = RefPlan(tree_r, s_r, backend="gemm")
    port = ContractionPlan(tree_p, s_p, device="cpu", hw=REF_HW)
    assert len(port.schedule.specs) == len(ref.schedule.specs)
    for a, b in zip(ref.schedule.specs, port.schedule.specs):
        assert _as_port_form(a.form) == b.form
        assert BACKEND_NAMES.get(a.backend, a.backend) == b.backend
        assert (a.bm, a.bn, a.bk) == (b.bm, b.bn, b.bk)
        assert b.modeled_time_s == pytest.approx(a.modeled_time_s)
        assert b.transpose_bytes == a.transpose_bytes
    keep = ("segment", "positions", "nodes", "carry_side", "external_nodes",
            "out_node", "live_bytes", "slot_ids", "slot_elems")
    assert [tuple(getattr(c, k) for k in keep) for c in port.chain_plan.chains] == [
        tuple(getattr(c, k) for k in keep) for c in ref.chain_plan.chains
    ]
    mp, mr = port.memory_plan(), ref.memory_plan()
    assert (mp.peak_bytes, mp.peak_bytes_hoisted, mp.buffer_slots) == (
        mr.peak_bytes, mr.peak_bytes_hoisted, mr.buffer_slots
    )
    assert (port.prologue_idx, port.epilogue_idx) == (ref.prologue_idx, ref.epilogue_idx)


@pytest.mark.parametrize("min_dim", [2, 16, 128])
@pytest.mark.parametrize("fused", [True, False])
def test_refine_step_injected_min_kernel_dim(min_dim, fused):
    """``refine_step(min_kernel_dim=…)`` routes exactly as the reference
    does at the same threshold, over every step of a real plan."""
    (tn_r, _), (tn_p, _) = _networks(4, 4, 10, 0)
    tree_r, s_r, _ = ref_plan_contraction(tn_r, 10)
    tree_p, s_p, _ = plan_contraction(tn_p, 10, hw=REF_HW)
    sched_r = ref_refiner.refine_tree_schedule(
        tree_r, s_r, min_kernel_dim=min_dim, fused=fused)
    sched_p = refiner.refine_tree_schedule(
        tree_p, s_p, min_kernel_dim=min_dim, fused=fused, hw=REF_HW)
    assert [BACKEND_NAMES.get(s.backend, s.backend) for s in sched_r.specs] == [
        s.backend for s in sched_p.specs
    ]


@pytest.mark.parametrize("budget", [1 << 12, 1 << 16, 12 << 20])
def test_plan_chains_injected_budget(budget):
    (tn_r, _), (tn_p, _) = _networks(4, 4, 10, 1)
    tree_r, s_r, _ = ref_plan_contraction(tn_r, 10, seed=1)
    tree_p, s_p, _ = plan_contraction(tn_p, 10, seed=1, hw=REF_HW)
    cr = ref_refiner.plan_tree_chains(tree_r, s_r, vmem_budget=budget)
    cp = refiner.plan_tree_chains(tree_p, s_p, vmem_budget=budget, hw=REF_HW)
    assert [(c.positions, c.slot_ids, c.slot_elems, c.live_bytes)
            for c in cp.chains] == [
        (c.positions, c.slot_ids, c.slot_elems, c.live_bytes)
        for c in cr.chains
    ]
    assert cp.hbm_bytes_saved("epilogue") == cr.hbm_bytes_saved("epilogue")


def test_merge_surface_matches_reference():
    """With the reference's constants the merging surface is the
    reference's ``surface="tpu"`` F(M, N, K), point for point."""
    for m, n, k in [(0, 0, 0), (3, 1, 2), (10, 2, 4), (20, 7, 7), (8, 8, 8)]:
        assert merging.gemm_efficiency(m, n, k, REF_HW) == pytest.approx(
            ref_merging.gemm_efficiency(m, n, k, "tpu")
        )


def test_pinned_syc12_fixture():
    """The reference's pinned syc-12 memory-plan regression holds in the
    port (the chain part with the reference's chain budget)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "..", "experiments", "memory",
                           "pinned_syc12.json")) as f:
        pinned = json.load(f)
    circ = circuits.sycamore_like(4, 5, 12, seed=0)
    tn, _ = simplify_network(*circuits.circuit_to_network(
        circ, bitstring="0" * circ.num_qubits))
    tree = random_greedy_tree(
        tn, repeats=pinned["planner_repeats"], seed=pinned["planner_seed"]
    )
    target = max(tree.width() - 4, 8)
    assert target == pinned["target_dim"]
    S = find_slices(tree, target, method="lifetime")
    assert bin(S).count("1") == pinned["num_sliced"]
    mem = memory.plan_memory(tree, S, itemsize=pinned["itemsize"])
    assert mem.peak_bytes <= pinned["peak_bytes"]
    assert mem.peak_bytes_hoisted <= pinned["peak_bytes_hoisted"]
    cp = refiner.plan_tree_chains(tree, S, hw=REF_HW)
    assert cp.num_multi >= pinned["fused_chains"]
    assert cp.max_live_bytes() <= pinned["chain_peak_bytes"]
    assert cp.max_live_bytes() <= REF_HW.chain_budget_bytes
    assert (
        cp.hbm_bytes_saved("epilogue")
        >= pinned["chain_hbm_bytes_saved_epilogue"]
    )
    # and the same objects as the reference builds from the same seeds
    ref_tn, _ = ref_simplify(*ref_circuits.circuit_to_network(
        ref_circuits.sycamore_like(4, 5, 12, seed=0),
        bitstring="0" * circ.num_qubits))
    ref_tree = ref_greedy(ref_tn, repeats=4, seed=0)
    assert ref_tree.children == tree.children
    assert ref_find_slices(ref_tree, target, method="lifetime") == S
    ref_mem = ref_memory.plan_memory(ref_tree, S, itemsize=8)
    assert (ref_mem.peak_bytes, ref_mem.peak_bytes_hoisted) == (
        mem.peak_bytes, mem.peak_bytes_hoisted)


def test_h100_constants_are_the_data_sheet():
    """The memory rate and on-chip sizes are the data sheet's; the
    kernels' rates are the ones measured on the card (hardware.py): the
    3xTF32 and bf16 routes and the library's rate relative to them."""
    hw = H100_SXM
    assert hw.peak_flops == 78e12
    assert hw.bf16_peak_flops == 107e12 > hw.peak_flops
    assert hw.non_kernel_peak_fraction == pytest.approx(55.5 / 78)
    assert hw.mem_bw == 3.35e12
    assert hw.l2_bytes == 50 * 1024 * 1024
    assert hw.smem_per_block_bytes == 227 * 1024
    assert hw.chain_budget_bytes == hw.l2_bytes // 4
    # the 64-wide tile of the CUDA kernels is the kernels' own
    from repro_torch.kernels.contract_gemm import TILE_M, TILE_N

    assert hw.tile == TILE_M == TILE_N
    assert hw.block_candidates[0] == hw.tile


def test_h100_refiner_routes_large_steps_to_kernels():
    """On the card's own constants a 30-qubit Sycamore-like plan sends
    its large steps to the tiled and fused kernels."""
    tn, _ = simplify_network(*circuits.circuit_to_network(
        circuits.sycamore_like(5, 6, 14, seed=0), bitstring="0" * 30))
    tree, S, rep = plan_contraction(tn, 28)
    sched = refiner.refine_tree_schedule(tree, S)
    counts = sched.backend_counts()
    assert counts.get("tiled", 0) > 0 and counts.get("fused", 0) > 0
    for s in sched.specs:
        if s.backend in ("tiled", "fused"):
            assert min(s.form.M, s.form.N, s.form.K) >= H100_SXM.tile
    assert rep.width_after <= 28
    np.testing.assert_array_less(0, rep.peak_bytes)
