"""The port's anytime plan search against the JAX reference.

With the reference's cost constants injected (``REF_HW`` from
``test_torch_planner``), the same inputs give the reference's searched
tree (children and contract order), mask, objective, certified peak,
evaluation count and trace, exactly, for both objectives and any worker
count; ``modeled_plan_time`` equals the reference's to a relative 1e-9.
The searched plan's amplitude agrees with the statevector at the
reference suite's tolerance (rtol 1e-4, atol 1e-5)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.tensor_network import random_regular_tn as ref_random_tn  # noqa: E402
from repro.lowering import refiner as ref_refiner  # noqa: E402
from repro.optimize.search import per_slice_cost_vector as ref_cost_vector  # noqa: E402
from repro.optimize import plan_search as ref_plan_search  # noqa: E402
from repro.quantum import circuits as ref_circuits  # noqa: E402
from repro.quantum import statevector as ref_sv  # noqa: E402
from test_torch_planner import REF_HW, _networks  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core import ContractionPlan, simplify_network  # noqa: E402
from repro_torch.core.api import (  # noqa: E402
    plan_compiled,
    plan_contraction,
    simulate_amplitude,
)
from repro_torch.core.tensor_network import random_regular_tn  # noqa: E402
from repro_torch.engine.server import AmplitudeRequest, EngineServer  # noqa: E402
from repro_torch.lowering import refiner  # noqa: E402
from repro_torch.lowering.cache import PLAN_CACHE  # noqa: E402
from repro_torch.lowering.memory import certified_peak  # noqa: E402
from repro_torch.optimize import (  # noqa: E402
    oneshot_plan,
    per_slice_cost_vector,
    plan_search,
)
from repro_torch.quantum import circuits  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
TARGET = 8


def _tns(n=30, seed=2):
    return ref_random_tn(n, 3, seed=seed), random_regular_tn(n, 3, seed=seed)


def _trace_key(res):
    return [
        (t.evaluation, t.objective, t.log2_objective, t.num_sliced,
         t.peak_bytes, t.worker, t.move)
        for t in res.trace
    ]


def _same_result(ref, port):
    assert sorted(port.tree.children.items()) == sorted(ref.tree.children.items())
    assert port.tree.contract_order() == ref.tree.contract_order()
    assert port.smask == ref.smask
    assert port.objective == ref.objective
    assert port.peak_bytes == ref.peak_bytes
    assert port.budget_bytes == ref.budget_bytes
    assert port.feasible == ref.feasible
    assert port.evaluations == ref.evaluations
    assert port.baseline_objective == ref.baseline_objective
    assert port.width_before == ref.width_before
    assert _trace_key(port) == _trace_key(ref)


# ----------------------------------------------------------------------
# the reference's search, exactly
# ----------------------------------------------------------------------
@pytest.mark.parametrize("objective", ["flops", "modeled_time"])
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("seed", [0, 3])
def test_plan_search_equals_reference(seed, workers, objective):
    ref_tn, tn = _tns()
    ref = ref_plan_search(ref_tn, TARGET, max_evals=24, num_workers=workers,
                          seed=seed, objective=objective)
    port = plan_search(tn, TARGET, max_evals=24, num_workers=workers,
                       seed=seed, objective=objective, hw=REF_HW)
    _same_result(ref, port)
    assert port.objective_kind == objective


@pytest.mark.parametrize("workers", [1, 4])
def test_plan_search_on_circuit_equals_reference(workers):
    """A Sycamore-like network, peak-mode slicing: the path the port's
    ``optimize="anytime"`` entry points run."""
    ref_net, port_net = _networks(3, 4, 8)
    ref = ref_plan_search(ref_net[0], 6, max_evals=16, num_workers=workers,
                          seed=1)
    port = plan_search(port_net[0], 6, max_evals=16, num_workers=workers,
                       seed=1, hw=REF_HW)
    _same_result(ref, port)


def test_greedy_init_equals_reference():
    ref_tn, tn = _tns(26, 4)
    ref = ref_plan_search(ref_tn, TARGET, max_evals=12, num_workers=2,
                          seed=5, init="greedy")
    port = plan_search(tn, TARGET, max_evals=12, num_workers=2, seed=5,
                       init="greedy", hw=REF_HW)
    _same_result(ref, port)
    assert port.baseline_objective is None


@pytest.mark.parametrize("mode", ["fp32", "auto"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_modeled_plan_time_equals_reference(seed, mode):
    ref_net, port_net = _networks(4, 4, 10, seed=seed)
    ref = ref_plan_search(ref_net[0], 10, max_evals=4, num_workers=1, seed=seed)
    port = plan_search(port_net[0], 10, max_evals=4, num_workers=1, seed=seed,
                       hw=REF_HW)
    for smask in (0, port.smask):
        want = ref_refiner.modeled_plan_time(ref.tree, smask, precision=mode)
        got = refiner.modeled_plan_time(port.tree, smask, precision=mode,
                                        hw=REF_HW)
        assert got == pytest.approx(want, rel=1e-9)


def test_per_slice_cost_vector_equals_reference():
    ref_tn, tn = _tns(30, 6)
    ref = ref_plan_search(ref_tn, TARGET, max_evals=4, num_workers=1)
    port = plan_search(tn, TARGET, max_evals=4, num_workers=1, hw=REF_HW)
    np.testing.assert_array_equal(
        per_slice_cost_vector(port.tree, port.smask),
        ref_cost_vector(ref.tree, ref.smask),
    )
    np.testing.assert_array_equal(per_slice_cost_vector(port.tree, 0), [1.0])


# ----------------------------------------------------------------------
# the search's own contract (the reference's tests, on the port)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_seeded_determinism(workers):
    _, tn = _tns()
    a = plan_search(tn, TARGET, max_evals=24, num_workers=workers, seed=3)
    b = plan_search(tn, TARGET, max_evals=24, num_workers=workers, seed=3)
    assert a.smask == b.smask
    assert a.objective == b.objective
    assert a.evaluations == b.evaluations
    assert [t.objective for t in a.trace] == [t.objective for t in b.trace]
    assert sorted(a.tree.emask.items()) == sorted(b.tree.emask.items())


def test_anytime_monotone_trace():
    _, tn = _tns(34, 7)
    res = plan_search(tn, TARGET, max_evals=48, num_workers=4, seed=1)
    objs = [t.objective for t in res.trace]
    assert objs, "the search records at least its seed"
    assert objs == sorted(objs, reverse=True)
    assert len(set(objs)) == len(objs), "best-so-far must strictly improve"
    assert res.objective == objs[-1]
    longer = plan_search(tn, TARGET, max_evals=96, num_workers=4, seed=1)
    assert longer.objective <= res.objective


def test_budgets_respected():
    _, tn = _tns(28, 5)
    res = plan_search(tn, TARGET, max_evals=17, num_workers=3, seed=0)
    assert res.evaluations <= 17
    assert res.feasible
    assert res.peak_bytes <= res.budget_bytes
    assert certified_peak(res.tree, res.smask, 8) <= res.budget_bytes
    res.tree.check_valid()
    tight = plan_search(tn, TARGET, max_evals=17, num_workers=3, seed=0,
                        budget_bytes=res.budget_bytes)
    assert tight.peak_bytes <= res.budget_bytes


@pytest.mark.parametrize("seed", range(4))
def test_never_worse_than_oneshot(seed):
    _, tn = _tns(30, seed)
    res = plan_search(tn, TARGET, max_evals=32, num_workers=4, seed=seed)
    assert res.baseline_objective is not None
    assert res.objective <= res.baseline_objective * (1 + 1e-12)
    assert res.improvement >= 1.0
    assert res.summary()["improvement"] == res.improvement


def test_search_rejects_bad_arguments():
    _, tn = _tns(20, 1)
    for kw in (dict(objective="nope"), dict(init="nope"),
               dict(num_workers=0), dict(max_evals=0)):
        with pytest.raises(ValueError):
            plan_search(tn, TARGET, **kw)


def test_search_counters_and_spans():
    _, tn = _tns(26, 3)
    with obs.enabled_scope(True):
        obs.reset()
        res = plan_search(tn, TARGET, max_evals=20, num_workers=2, seed=2)
        counters = obs.telemetry_summary()["metrics"]["counters"]
        spans = obs.trace.summary()
    obs.reset()
    assert counters["search.evals"] == res.evaluations
    moves = sum(counters.get(k, 0) for k in
                ("search.accepted", "search.rejected", "search.restarts"))
    assert 0 < moves <= res.evaluations
    assert spans["search.eval"]["count"] == res.evaluations


# ----------------------------------------------------------------------
# execution: a searched plan contracts the right amplitude
# ----------------------------------------------------------------------
def _circuit_network(n=9, depth=6, seed=5, bits="011010010"):
    c = circuits.random_1d_circuit(n, depth, seed=seed)
    tn, arrays = circuits.circuit_to_network(c, bitstring=bits)
    return c, simplify_network(tn, arrays)


def test_one_evaluation_returns_the_oneshot_plan_bitwise():
    _, (tn, arrays) = _circuit_network()
    res = plan_search(tn, 6, max_evals=1, num_workers=1, seed=0,
                      slicing_mode="width")
    shot = oneshot_plan(tn, 6, seed=0, slicing_mode="width")
    assert res.smask == shot.smask
    assert sorted(res.tree.children.items()) == sorted(
        shot.tree.children.items())
    v_search = ContractionPlan(res.tree, res.smask, device="cpu").contract_all(arrays)
    v_shot = ContractionPlan(shot.tree, shot.smask, device="cpu").contract_all(arrays)
    assert torch.equal(v_search, v_shot)


@pytest.mark.parametrize("rows,cols,cycles,target,seed", [
    (3, 3, 8, 5, 4),
    (3, 4, 8, 6, 1),
])
def test_searched_amplitude_matches_statevector(rows, cols, cycles, target, seed):
    n = rows * cols
    bits = "".join(str(b) for b in np.random.default_rng(seed).integers(0, 2, n))
    circ = circuits.sycamore_like(rows, cols, cycles, seed=seed)
    res = simulate_amplitude(
        circ, bits, target_dim=target, device="cpu", use_cache=False,
        optimize="anytime", search_evals=16, search_workers=2, seed=seed,
    )
    assert res.report.num_sliced > 0
    want = complex(ref_sv.amplitude(
        ref_circuits.sycamore_like(rows, cols, cycles, seed=seed), bits))
    np.testing.assert_allclose(complex(res.value), want, rtol=RTOL, atol=ATOL)
    one = simulate_amplitude(circ, bits, target_dim=target, device="cpu",
                             use_cache=False, seed=seed)
    np.testing.assert_allclose(complex(res.value), complex(one.value),
                               rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# API and plan-cache wiring
# ----------------------------------------------------------------------
def test_plan_contraction_anytime_report():
    _, tn = _tns(24, 9)
    tree, smask, report = plan_contraction(
        tn, TARGET, optimize="anytime", search_evals=12, search_workers=2)
    assert report.optimize == "anytime"
    assert 0 < report.search_evals <= 12
    assert report.search_trace
    assert {"evaluation", "objective", "num_sliced", "peak_bytes"} <= set(
        report.search_trace[0])
    assert "opt=anytime" in report.row()
    _, _, one = plan_contraction(tn, TARGET)
    assert one.optimize == "oneshot" and one.search_evals == 0
    assert one.search_trace is None
    with pytest.raises(ValueError):
        plan_contraction(tn, TARGET, optimize="nope")


def test_plan_report_carries_the_search_budget():
    _, tn = _tns(24, 9)
    kw = dict(search_evals=12, search_workers=2)
    sr = plan_search(tn, TARGET, max_evals=12, num_workers=2)
    _, smask, rep = plan_contraction(tn, TARGET, optimize="anytime", **kw)
    assert smask == sr.smask
    assert (rep.budget_bytes, rep.feasible) == (sr.budget_bytes, sr.feasible)
    assert rep.feasible and rep.budget_bytes > 0
    tight = sr.budget_bytes // 2
    _, _, trep = plan_contraction(tn, TARGET, optimize="anytime",
                                  budget_bytes=tight, **kw)
    assert trep.budget_bytes == tight
    _, _, one = plan_contraction(tn, TARGET)
    assert (one.budget_bytes, one.feasible) == (0, True)


def test_plan_contraction_anytime_equals_reference_plan():
    from repro.core.api import plan_contraction as ref_plan_contraction

    ref_net, port_net = _networks(3, 4, 8)
    kw = dict(optimize="anytime", search_evals=10, search_workers=2, seed=2)
    r_tree, r_smask, r_rep = ref_plan_contraction(ref_net[0], 6, **kw)
    p_tree, p_smask, p_rep = plan_contraction(port_net[0], 6, hw=REF_HW, **kw)
    assert p_smask == r_smask
    assert sorted(p_tree.children.items()) == sorted(r_tree.children.items())
    assert p_rep.search_evals == r_rep.search_evals
    assert [{k: v for k, v in t.items() if k != "wall_s"}
            for t in p_rep.search_trace] == [
        {k: v for k, v in t.items() if k != "wall_s"}
        for t in r_rep.search_trace]
    assert p_rep.peak_bytes == r_rep.peak_bytes


def test_plan_cache_key_takes_search_params_only_under_anytime():
    _, (tn, _) = _circuit_network()
    PLAN_CACHE.clear()
    try:
        base = dict(device="cpu", repeats=2)
        plan_a, _ = plan_compiled(tn, 6, **base)
        plan_b, rep_b = plan_compiled(tn, 6, search_evals=7, search_workers=1,
                                      **base)
        assert rep_b.cache_hit and plan_b is plan_a  # ignored knobs
        any_a, rep_a = plan_compiled(tn, 6, optimize="anytime", search_evals=6,
                                     search_workers=2, **base)
        assert not rep_a.cache_hit and any_a is not plan_a
        assert rep_a.optimize == "anytime"
        any_b, rep_b = plan_compiled(tn, 6, optimize="anytime", search_evals=6,
                                     search_workers=2, **base)
        assert rep_b.cache_hit and any_b is any_a
        any_c, rep_c = plan_compiled(tn, 6, optimize="anytime", search_evals=5,
                                     search_workers=2, **base)
        assert not rep_c.cache_hit and any_c is not any_a
        any_d, rep_d = plan_compiled(tn, 6, optimize="anytime", search_evals=6,
                                     search_workers=1, **base)
        assert not rep_d.cache_hit
    finally:
        PLAN_CACHE.clear()


def test_server_family_key_separates_planner_modes():
    srv = EngineServer(device="cpu")
    c = circuits.random_1d_circuit(6, 4, seed=1)
    one = AmplitudeRequest(c, "0" * 6, 4)
    anytime = AmplitudeRequest(c, "1" * 6, 4, {"optimize": "anytime"})
    anytime2 = AmplitudeRequest(c, "0" * 6, 4, {"optimize": "anytime"})
    assert srv._family_key(one) != srv._family_key(anytime)
    assert srv._family_key(anytime) == srv._family_key(anytime2)


def test_objective_modeled_time_is_finite():
    _, tn = _tns(26, 11)
    res = plan_search(tn, TARGET, max_evals=6, num_workers=2, seed=0,
                      objective="modeled_time")
    assert res.objective > 0.0 and math.isfinite(res.objective)
    assert res.objective_kind == "modeled_time"
