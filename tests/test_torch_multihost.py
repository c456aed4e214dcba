"""Multi-host slice parallelism in the port against the JAX reference: the
LPT + work-stealing scheduler (assignments, steal sequences and the
virtual-time simulation equal the reference's on the same costs), the
elastic claim store, ``contract_multihost`` at world size 1, emulated
hosts through the claim store (a host failure, then an epoch resume),
and a real 2-process ``torch.distributed`` run on ``gloo``.

Values against the reference: rtol 1e-4, atol 1e-5; against the port's
own ``run_all``: rtol 1e-5 (another order of the same fp32 sums)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ContractionPlan as RefPlan  # noqa: E402
from repro.core import simplify_network as ref_simplify  # noqa: E402
from repro.core.pathfinder import random_greedy_tree as ref_greedy  # noqa: E402
from repro.core.slicing import find_slices as ref_find_slices  # noqa: E402
from repro.distributed import contract_multihost as ref_multihost  # noqa: E402
from repro.distributed import scheduler as ref_sched  # noqa: E402
from repro.quantum import circuits as ref_circuits  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core import ContractionPlan, simplify_network  # noqa: E402
from repro_torch.core.api import plan_compiled  # noqa: E402
from repro_torch.core.distributed import SliceRangeCheckpoint  # noqa: E402
from repro_torch.core.pathfinder import random_greedy_tree  # noqa: E402
from repro_torch.core.slicing import find_slices  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    ClaimStore,
    FileTransport,
    LocalArbiter,
    NullTransport,
    SliceRange,
    SliceScheduler,
    contract_multihost,
    imbalance,
    lpt_assignment,
    make_ranges,
    simulate,
    uniform_assignment,
    world,
)
from repro_torch.distributed.multihost import _resolve_transport  # noqa: E402
from repro_torch.optimize import per_slice_cost_vector  # noqa: E402
from repro_torch.quantum import circuits  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
SELF_RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ragged_costs(n, heavy_every=8, heavy=7.0):
    """Synthetic ragged per-slice costs: a heavy head region (the shape
    that breaks a contiguous uniform split worst)."""
    c = np.ones(n)
    c[: n // heavy_every] = heavy
    return c


def _missing(n, chunk):
    return SliceRangeCheckpoint(n, set(), 0.0).missing(chunk)


def _keys(queues):
    return [[(r.start, r.end, r.cost, r.home) for r in q] for q in queues]


# ----------------------------------------------------------------------
# the scheduler: the reference's, identically
# ----------------------------------------------------------------------
@pytest.mark.parametrize("hosts", [1, 2, 3, 4, 7])
def test_assignments_equal_reference(hosts):
    costs = _ragged_costs(64)
    for chunk in (1, 4, 5):
        miss = _missing(64, chunk)
        ranges = make_ranges(miss, costs)
        assert ranges == ref_sched.make_ranges(miss, costs)
        lpt = lpt_assignment(ranges, hosts)
        assert _keys(lpt) == _keys(ref_sched.lpt_assignment(ranges, hosts))
        uni = uniform_assignment(ranges, hosts)
        assert _keys(uni) == _keys(ref_sched.uniform_assignment(ranges, hosts))
        assert imbalance(lpt) == ref_sched.imbalance(
            ref_sched.lpt_assignment(ranges, hosts))


@pytest.mark.parametrize("hosts", [2, 3, 4])
@pytest.mark.parametrize("policy", ["lpt", "uniform"])
def test_simulation_equals_reference(hosts, policy):
    costs = _ragged_costs(64)
    speed = [1.0] + [0.5] * (hosts - 1)

    def scale(s, e):
        return float(e - s) * (1.5 if s % 3 == 0 else 1.0)

    port = simulate(SliceScheduler(_missing(64, 4), hosts, costs,
                                   policy=policy), speed, cost_scale=scale)
    ref = ref_sched.simulate(ref_sched.SliceScheduler(
        _missing(64, 4), hosts, costs, policy=policy), speed, cost_scale=scale)
    assert port.steal_order == ref.steal_order
    assert port.executed == ref.executed
    assert port.makespan == ref.makespan
    assert port.host_busy == ref.host_busy
    assert port.steal_count == ref.steal_count


def test_next_range_steal_sequence_equals_reference():
    """Hosts asking in a fixed interleaving (host 0 twice as often) pop
    and steal the same ranges in the same order as the reference."""
    costs = _ragged_costs(48)
    port = SliceScheduler(_missing(48, 3), 3, costs)
    ref = ref_sched.SliceScheduler(_missing(48, 3), 3, costs)
    parb, rarb = LocalArbiter(), ref_sched.LocalArbiter()
    seq_p, seq_r = [], []
    for i in range(40):
        h = (0, 0, 1, 0, 0, 2)[i % 6]
        a, b = port.next_range(h, parb), ref.next_range(h, rarb)
        seq_p.append(None if a is None else (h, a.start, a.end, a.home))
        seq_r.append(None if b is None else (h, b.start, b.end, b.home))
    assert seq_p == seq_r
    assert port.steal_order == ref.steal_order
    assert port.summary() == ref.summary()


def test_lpt_beats_uniform_imbalance():
    ranges = make_ranges(_missing(96, 4), _ragged_costs(96))
    for hosts in (2, 4, 6):
        lpt = imbalance(lpt_assignment(ranges, hosts))
        assert lpt <= imbalance(uniform_assignment(ranges, hosts)) + 1e-12
        assert lpt < 1.2
    assert imbalance(uniform_assignment(ranges, 4)) > 1.5


def test_stealing_rebalances_a_slow_host():
    costs = np.ones(64)
    res = simulate(SliceScheduler(_missing(64, 2), 2, costs),
                   host_speed=[1.0, 0.25])
    assert res.steal_count > 0
    static = SliceScheduler(_missing(64, 2), 2, costs, policy="uniform")
    arb, clock = LocalArbiter(), [0.0, 0.0]
    for h in (0, 1):
        while (rng := static.next_range(h, arb, steal=False)) is not None:
            clock[h] += rng.cost / (1.0 if h == 0 else 0.25)
    assert res.makespan < max(clock)


def test_all_work_executed_exactly_once():
    sched = SliceScheduler(_missing(50, 3), 3, _ragged_costs(50))
    res = simulate(sched, host_speed=[1.0, 0.6, 0.3])
    assert sorted(r for host in res.executed for r in host) == _missing(50, 3)


# ----------------------------------------------------------------------
# the elastic claim store
# ----------------------------------------------------------------------
def test_claims_are_exclusive_across_stores(tmp_path):
    root = str(tmp_path)
    s0, s1 = ClaimStore(root, 16, host=0), ClaimStore(root, 16, host=1)
    r = SliceRange(0, 4, 4.0, 0)
    assert s0.try_claim(r, 0)
    assert not s1.try_claim(r, 1)  # O_EXCL: exactly one winner
    assert s1.try_claim(SliceRange(4, 8, 4.0, 1), 1)


def test_claim_store_host_defaults_to_rank(tmp_path):
    assert world() == (0, 1)
    assert ClaimStore(str(tmp_path), 8).host == 0


def test_merge_unions_hosts(tmp_path):
    root = str(tmp_path)
    s0, s1 = ClaimStore(root, 16, host=0), ClaimStore(root, 16, host=1)
    s0.complete(SliceRange(0, 4, 4.0, 0), np.complex64(1 + 1j))
    # a delta may be a tensor: it comes to the host on completion
    s1.complete(SliceRange(4, 8, 4.0, 1), torch.tensor(2 - 1j))
    m = ClaimStore(root, 16, host=2).merged()
    assert m._intervals() == [(0, 8)]
    assert m.partial == np.complex64(3 + 0j)
    assert m.missing(8) == [(8, 16)]


def test_stale_claim_reclaim_is_epoch_gated(tmp_path):
    root = str(tmp_path)
    dead = ClaimStore(root, 16, host=1, epoch=0)
    assert dead.try_claim(SliceRange(0, 4, 4.0, 1), 1)
    dead.complete(SliceRange(0, 4, 4.0, 1), np.complex64(1j))
    assert dead.try_claim(SliceRange(4, 8, 4.0, 1), 1)
    peer = ClaimStore(root, 16, host=0, epoch=0)
    assert peer.reclaim_stale() == 0  # the owner may just be slow
    assert not peer.try_claim(SliceRange(4, 8, 4.0, 0), 0)
    resumed = ClaimStore(root, 16, host=0, epoch=1)
    assert resumed.reclaim_stale() == 1
    assert resumed.try_claim(SliceRange(4, 8, 4.0, 0), 0)
    assert not resumed.try_claim(SliceRange(0, 4, 4.0, 0), 0)


# ----------------------------------------------------------------------
# the runner
# ----------------------------------------------------------------------
def _plans():
    """A 64-slice plan (9 qubits, depth 8) in both packages."""
    bits = "011010010"
    rc = ref_circuits.random_1d_circuit(9, 8, seed=7)
    rtn, rarrays = ref_simplify(*ref_circuits.circuit_to_network(rc, bitstring=bits))
    rtree = ref_greedy(rtn, repeats=4)
    rS = ref_find_slices(rtree, rtree.width() - 2, method="lifetime")
    c = circuits.random_1d_circuit(9, 8, seed=7)
    tn, arrays = simplify_network(*circuits.circuit_to_network(c, bitstring=bits))
    tree = random_greedy_tree(tn, repeats=4)
    S = find_slices(tree, tree.width() - 2, method="lifetime")
    assert S == rS
    return ContractionPlan(tree, S, device="cpu"), arrays, RefPlan(rtree, rS), rarrays


@pytest.mark.parametrize("slice_batch", [1, 4])
def test_world1_equals_run_all_and_reference(slice_batch):
    plan, arrays, rplan, rarrays = _plans()
    run_all = plan.contract_all(arrays).numpy()
    res = contract_multihost(plan, arrays, slice_batch=slice_batch)
    np.testing.assert_allclose(res.value, run_all, rtol=SELF_RTOL)
    assert res.complete and res.steal_count == 0
    assert res.executed_slices == 1 << plan.num_sliced
    ref = ref_multihost(rplan, rarrays, slice_batch=slice_batch)
    np.testing.assert_allclose(res.value, np.asarray(ref.value),
                               rtol=RTOL, atol=ATOL)
    assert res.executed_ranges == ref.executed_ranges
    assert res.schedule_imbalance == ref.schedule_imbalance


def test_executed_vs_padded_accounting():
    plan, arrays, _, _ = _plans()
    n, sb = 1 << plan.num_sliced, 3
    assert n % sb != 0
    with obs.enabled_scope(True):
        obs.reset()
        res = contract_multihost(plan, arrays, slice_batch=sb)
        counters = obs.telemetry_summary()["metrics"]["counters"]
    obs.reset()
    assert res.executed_slices == n
    assert res.padded_slices == len(res.executed_ranges) * sb - n
    assert counters["exec.slices_executed"] == n
    assert counters["exec.padded_slices"] == res.padded_slices


def test_emulated_two_hosts_file_transport(tmp_path):
    plan, arrays, rplan, rarrays = _plans()
    run_all = plan.contract_all(arrays).numpy()
    dense = np.asarray(RefPlan(rplan.tree, 0).contract_all(rarrays))
    kw = dict(slice_batch=4, costs=per_slice_cost_vector(plan.tree, plan.smask),
              transport="file", checkpoint_dir=str(tmp_path / "run"),
              world_size=2)
    r0 = contract_multihost(plan, arrays, rank=0, **kw)
    assert r0.steal_count > 0 and r0.complete  # host 0 stole host 1's queue
    np.testing.assert_allclose(r0.value, run_all, rtol=SELF_RTOL)
    np.testing.assert_allclose(r0.value, dense, rtol=RTOL, atol=ATOL)
    r1 = contract_multihost(plan, arrays, rank=1, **kw)
    assert r1.executed_slices == 0  # everything already claimed
    np.testing.assert_allclose(r1.value, run_all, rtol=SELF_RTOL)


def test_host_failure_and_epoch_resume(tmp_path):
    plan, arrays, _, _ = _plans()
    n = 1 << plan.num_sliced
    run_all = plan.contract_all(arrays).numpy()
    kw = dict(slice_batch=4, transport="file",
              checkpoint_dir=str(tmp_path / "run"), world_size=2)
    with pytest.raises(RuntimeError, match="simulated host 1"):
        contract_multihost(plan, arrays, rank=1, fail_after=2, **kw)
    r0 = contract_multihost(plan, arrays, rank=0, **kw)
    assert not r0.complete and r0.state.missing(1)
    missing = sum(e - s for s, e in r0.state.missing(1))
    assert missing == 4  # the claim the dead host held
    r2 = contract_multihost(plan, arrays, rank=0, slice_batch=4,
                            transport="file", checkpoint_dir=kw["checkpoint_dir"],
                            world_size=1, epoch=1)
    assert r2.complete and r2.executed_slices == missing
    assert r2.state.done_ids() == set(range(n))
    ids = [i for r in (r0, r2) for s, e in r.executed_ranges for i in range(s, e)]
    assert len(ids) + 2 * 4 == n  # host 1 completed 2 ranges of 4 first
    np.testing.assert_allclose(r2.value, run_all, rtol=SELF_RTOL)


def test_world1_checkpoint_resume_with_null_transport(tmp_path):
    """The smoke's path: one process, a checkpoint directory, a failure
    after two ranges, then an epoch-1 resume that folds the stored
    partial back in."""
    plan, arrays, _, _ = _plans()
    run_all = plan.contract_all(arrays).numpy()
    root = str(tmp_path / "run")
    with pytest.raises(RuntimeError):
        contract_multihost(plan, arrays, slice_batch=4, checkpoint_dir=root,
                           fail_after=2)
    res = contract_multihost(plan, arrays, slice_batch=4, checkpoint_dir=root,
                             epoch=1)
    assert res.complete
    assert res.executed_slices == (1 << plan.num_sliced) - 8
    np.testing.assert_allclose(res.value, run_all, rtol=SELF_RTOL)


def test_report_fields_populated():
    c = circuits.random_1d_circuit(9, 8, seed=7)
    tn, arrays = simplify_network(*circuits.circuit_to_network(c, bitstring="0" * 9))
    plan, report = plan_compiled(tn, 5, device="cpu", use_cache=False)
    assert plan.num_sliced and report.schedule_imbalance == 0.0
    res = contract_multihost(plan, arrays, slice_batch=2, report=report)
    assert report.schedule_imbalance == res.schedule_imbalance > 0
    assert report.steal_count == res.steal_count
    assert report.overlap_fraction == res.overlap_fraction
    assert "sched[" in report.row()


def test_transport_resolution(tmp_path):
    assert isinstance(_resolve_transport("auto", 1, None, 3, 2), NullTransport)
    assert _resolve_transport("null", 1, None, 3, 2).rounds == 3
    store = ClaimStore(str(tmp_path), 4, host=0)
    assert isinstance(_resolve_transport("file", 2, store, 3, 2), FileTransport)
    with pytest.raises(ValueError):
        _resolve_transport("file", 2, None, 3, 2)
    with pytest.raises(ValueError):
        _resolve_transport("nope", 1, None, 3, 2)


# ----------------------------------------------------------------------
# two processes on gloo
# ----------------------------------------------------------------------
WORKER = r"""
import json, sys
import numpy as np
pid, port = int(sys.argv[1]), sys.argv[2]
from repro_torch.distributed import CollectiveTransport, contract_multihost, init_multi_host
rank, size = init_multi_host(f"localhost:{port}", 2, pid, backend="gloo")
assert (rank, size) == (pid, 2), (rank, size)
from repro_torch.quantum import circuits
from repro_torch.core import ContractionPlan, simplify_network
from repro_torch.core.pathfinder import random_greedy_tree
from repro_torch.core.slicing import find_slices
c = circuits.random_1d_circuit(9, 8, seed=7)
tn, arrays = simplify_network(*circuits.circuit_to_network(c, bitstring="011010010"))
tree = random_greedy_tree(tn, repeats=4)
plan = ContractionPlan(tree, find_slices(tree, tree.width() - 2, method="lifetime"),
                       device="cpu")
single = plan.contract_all(arrays).numpy()
res = contract_multihost(plan, arrays, slice_batch=2, reduce_rounds=3,
                         reduce_chunks=2)
assert np.allclose(res.value, single, rtol=1e-5, atol=0), (res.value, single)
print("COVER" + json.dumps({"rank": rank, "n_slices": res.n_slices,
                            "ranges": res.executed_ranges,
                            "value": [float(np.real(res.value)), float(np.imag(res.value))],
                            "overlap": res.overlap_fraction}))
import torch.distributed as dist
dist.destroy_process_group()
print(f"rank={rank} MH_OK")
"""


def test_two_process_collective_equals_single():
    """2 plain subprocesses, ``torch.distributed`` on ``gloo``: the
    all-reduced amplitude equals the single-process value on both ranks,
    and the ranks' slice ids are a disjoint cover."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0 and "MH_OK" in out, out + "\n" + err[-3000:]
    recs = {}
    for _, out, _ in outs:
        line = next(l for l in out.splitlines() if l.startswith("COVER"))
        rec = json.loads(line[len("COVER"):])
        recs[rec["rank"]] = rec
    ids = [{i for s, e in recs[r]["ranges"] for i in range(s, e)} for r in (0, 1)]
    assert ids[0] and ids[1] and ids[0].isdisjoint(ids[1])
    assert ids[0] | ids[1] == set(range(recs[0]["n_slices"]))
    assert recs[0]["value"] == recs[1]["value"]  # one reduction, both ranks
    assert all(0.0 <= recs[r]["overlap"] <= 1.0 for r in (0, 1))
