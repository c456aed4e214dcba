"""The port's slice-level fault tolerance and device-sharded execution
against the JAX reference: ``SliceRangeCheckpoint`` bookkeeping,
``contract_resumable`` (a simulated failure, then a resume at another
chunk), ``contract_sharded`` over a list of devices, the sharded
``sample_bitstrings``, the atomic slice checkpoints and the
``CheckpointManager``.

Tolerances: values against the reference's rtol 1e-4, atol 1e-5 (the
reference suite's for amplitudes); against the port's own ``run_all``
rtol 1e-5 (another order of the same fp32 sums), bitwise where the
order is the same."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ContractionPlan as RefPlan  # noqa: E402
from repro.core import sample_bitstrings as ref_sample  # noqa: E402
from repro.core import simplify_network as ref_simplify  # noqa: E402
from repro.core.distributed import SliceRangeCheckpoint as RefCheckpoint  # noqa: E402
from repro.core.distributed import contract_resumable as ref_resumable  # noqa: E402
from repro.core.pathfinder import random_greedy_tree as ref_greedy  # noqa: E402
from repro.core.slicing import find_slices as ref_find_slices  # noqa: E402
from repro.quantum import circuits as ref_circuits  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    load_slice_checkpoint,
    save_slice_checkpoint,
)
from repro_torch.core import ContractionPlan, simplify_network  # noqa: E402
from repro_torch.core.api import sample_bitstrings  # noqa: E402
from repro_torch.core.contraction_tree import ContractionTree  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    SliceRangeCheckpoint,
    contract_resumable,
    contract_sharded,
)
from repro_torch.core.pathfinder import greedy_ssa_path, random_greedy_tree  # noqa: E402
from repro_torch.core.slicing import find_slices  # noqa: E402
from repro_torch.core.tensor_network import random_regular_tn  # noqa: E402
from repro_torch.distributed import contract_multihost  # noqa: E402
from repro_torch.engine.session import ContractionSession, check_devices  # noqa: E402
from repro_torch.quantum import circuits  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
SELF_RTOL = 1e-5
CPU2 = ["cpu", "cpu"]


def _plans(backend: str = "gemm"):
    """One sliced test plan (9 qubits, depth 8, 64 slices) in both
    packages: the planner is verbatim, so both trees and masks are the
    same."""
    bits = "011010010"
    rc = ref_circuits.random_1d_circuit(9, 8, seed=7)
    rtn, rarrays = ref_simplify(*ref_circuits.circuit_to_network(rc, bitstring=bits))
    rtree = ref_greedy(rtn, repeats=4)
    rS = ref_find_slices(rtree, rtree.width() - 2, method="lifetime")
    c = circuits.random_1d_circuit(9, 8, seed=7)
    tn, arrays = simplify_network(*circuits.circuit_to_network(c, bitstring=bits))
    tree = random_greedy_tree(tn, repeats=4)
    S = find_slices(tree, tree.width() - 2, method="lifetime")
    assert S == rS and sorted(tree.children.items()) == sorted(rtree.children.items())
    plan = ContractionPlan(tree, S, backend=backend, device="cpu")
    assert plan.num_sliced >= 5 and plan.can_hoist
    return plan, arrays, RefPlan(rtree, rS), rarrays


# ----------------------------------------------------------------------
# SliceRangeCheckpoint: the reference's bookkeeping, identically
# ----------------------------------------------------------------------
CHECKPOINT_CASES = [
    # n_slices, done (ids, intervals, legacy mixes), added ranges
    (10, set(), [(0, 4)]),
    (10, set(), [(0, 4), (6, 8)]),
    (8, {(0, 3), 5}, [(3, 5)]),
    (16, {1, 2, 3, (7, 9), (8, 12)}, [(12, 13), (0, 1)]),
    (12, {(4, 2), (0, 0)}, [(11, 12)]),
    (32, set(), [(5, 9), (9, 20), (0, 5), (20, 32)]),
]


@pytest.mark.parametrize("n,done,adds", CHECKPOINT_CASES)
def test_checkpoint_bookkeeping_equals_reference(n, done, adds):
    ref = RefCheckpoint(n, set(done), 0.0)
    port = SliceRangeCheckpoint(n, set(done), 0.0)
    for step in [None, *adds]:
        if step is not None:
            ref.add_range(*step)
            port.add_range(*step)
        assert port._intervals() == ref._intervals()
        assert port.done_ids() == ref.done_ids()
        for chunk in (1, 3, 4, 7, 100):
            assert port.missing(chunk) == ref.missing(chunk)


def test_missing_is_chunk_agnostic():
    ck = SliceRangeCheckpoint(10, set(), 0.0)
    ck.add_range(0, 4)
    assert ck.missing(4) == [(4, 8), (8, 10)]
    assert ck.missing(3) == [(4, 7), (7, 10)]
    assert ck.missing(100) == [(4, 10)]
    ck.add_range(6, 8)
    assert ck.missing(4) == [(4, 6), (8, 10)]
    assert ck.done_ids() == {0, 1, 2, 3, 6, 7}


# ----------------------------------------------------------------------
# contract_resumable: fail, resume at another chunk
# ----------------------------------------------------------------------
@pytest.mark.parametrize("first,second,fail_at", [(3, 5, 6), (4, 2, 8)])
def test_resumable_failure_then_resume_equals_reference(first, second, fail_at):
    plan, arrays, rplan, rarrays = _plans()
    n = 1 << plan.num_sliced
    want_ref, _ = ref_resumable(rplan, rarrays, chunk=8)
    run_all = plan.contract_all(arrays).numpy()
    with pytest.raises(RuntimeError, match="simulated failure"):
        contract_resumable(plan, arrays, chunk=first, fail_on={fail_at})
    # the state a failure leaves: every range before the failing one
    state = SliceRangeCheckpoint(n, set(), np.zeros((), np.complex64))
    with pytest.raises(RuntimeError):
        contract_resumable(plan, arrays, chunk=first, state=state,
                           fail_on={fail_at})
    assert state.done_ids() == set(range(fail_at))
    val, state = contract_resumable(plan, arrays, chunk=second, state=state)
    assert state.done_ids() == set(range(n))
    np.testing.assert_allclose(val, np.asarray(want_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(val, run_all, rtol=SELF_RTOL)
    # a third chunk size is a no-op
    val2, _ = contract_resumable(plan, arrays, chunk=7, state=state)
    assert np.array_equal(val2, val)


def test_resumable_counts_each_slice_once():
    plan, arrays, _, _ = _plans()
    n = 1 << plan.num_sliced
    with obs.enabled_scope(True):
        obs.reset()
        state = SliceRangeCheckpoint(n, set(), np.zeros((), np.complex64))
        with pytest.raises(RuntimeError):
            contract_resumable(plan, arrays, chunk=4, state=state,
                               fail_on={12})
        contract_resumable(plan, arrays, chunk=8, state=state)
        counters = obs.telemetry_summary()["metrics"]["counters"]
        spans = obs.trace.summary()
    obs.reset()
    assert counters["exec.slices_executed"] == n
    assert spans["exec.resumable"]["count"] == 2
    assert spans["exec.slice_range"]["count"] == 3 + len(
        SliceRangeCheckpoint(n, {(0, 12)}, 0).missing(8))


def test_resumable_without_hoist_matches():
    plan, arrays, _, _ = _plans()
    hoisted, _ = contract_resumable(plan, arrays, chunk=5)
    naive, _ = contract_resumable(plan, arrays, chunk=5, hoist=False)
    np.testing.assert_allclose(naive, hoisted, rtol=SELF_RTOL)


# ----------------------------------------------------------------------
# contract_sharded over a list of devices
# ----------------------------------------------------------------------
@pytest.mark.parametrize("slice_batch", [1, 3, 7])
@pytest.mark.parametrize("devices", [["cpu"], CPU2, ["cpu"] * 3])
def test_contract_sharded_equals_run_all(devices, slice_batch):
    plan, arrays, rplan, rarrays = _plans()
    run_all = plan.contract_all(arrays)
    got = contract_sharded(plan, arrays, devices, slice_batch=slice_batch)
    np.testing.assert_allclose(got.numpy(), run_all.numpy(), rtol=SELF_RTOL)
    dense = np.asarray(RefPlan(rplan.tree, 0).contract_all(rarrays))
    np.testing.assert_allclose(got.numpy(), dense, rtol=RTOL, atol=ATOL)


def test_contract_sharded_one_device_sums_in_run_all_order():
    plan, arrays, _, _ = _plans()
    assert torch.equal(contract_sharded(plan, arrays, ["cpu"]),
                       plan.contract_all(arrays))


def test_contract_sharded_accounting():
    plan, arrays, _, _ = _plans()
    n = 1 << plan.num_sliced
    with obs.enabled_scope(True):
        obs.reset()
        contract_sharded(plan, arrays, CPU2, slice_batch=3)
        counters = obs.telemetry_summary()["metrics"]["counters"]
        spans = obs.trace.summary()
    obs.reset()
    total = -(-n // 6) * 6
    assert counters["exec.slices_executed"] == n
    assert counters["exec.padded_slices"] == total - n
    assert spans["exec.sharded"]["count"] == 1


def _overflow_plan(seed: int = 0):
    """A closed network whose every slice contribution overflows float32
    to +inf (all-positive entries): the ragged sum is +inf, while a
    ``0 * inf`` weight-multiply mask would make it NaN."""
    tn = random_regular_tn(10, 3, seed=seed)
    rng = np.random.default_rng(seed)
    arrays = [
        (rng.uniform(0.5, 1.0, size=(2,) * len(t)) * 1e25).astype(np.float32)
        for t in tn.inputs
    ]
    tree = ContractionTree.from_ssa_path(tn, greedy_ssa_path(tn, seed=1))
    S = find_slices(tree, max(tree.width() - 2, 2), method="lifetime")
    assert S
    return ContractionPlan(tree, S, backend="einsum", device="cpu"), arrays


@pytest.mark.parametrize("devices", [["cpu"], CPU2])
@pytest.mark.parametrize("hoist", [False, True])
def test_ragged_padding_does_not_leak_nan(devices, hoist):
    plan, arrays = _overflow_plan()
    n = 1 << plan.num_sliced
    assert n % (3 * len(devices)) != 0  # a ragged final batch
    val = contract_sharded(plan, arrays, devices, slice_batch=3,
                           hoist=hoist).numpy()
    assert np.all(np.isinf(val)) and not np.any(np.isnan(val))


# ----------------------------------------------------------------------
# one card per process: device lists the launchers cannot serve
# ----------------------------------------------------------------------
TWO_CARDS = ["cuda:0", "cuda:1"]


def _refusers(plan, arrays, devices):
    """Every entry point that takes a device list, bound to ``devices``."""
    circ = circuits.sycamore_like(3, 3, 8, seed=2)
    return {
        "contract_sharded": lambda: contract_sharded(plan, arrays, devices),
        "run_sharded": lambda: ContractionSession(plan, arrays).run_sharded(devices),
        "contract_multihost": lambda: contract_multihost(plan, arrays,
                                                         devices=devices),
        "sample_bitstrings": lambda: sample_bitstrings(
            circ, num_samples=8, open_qubits=(7, 8), target_dim=4,
            device="cpu", use_cache=False, devices=devices),
    }


@pytest.mark.parametrize("entry", ["contract_sharded", "run_sharded",
                                   "contract_multihost", "sample_bitstrings"])
def test_two_cards_in_one_process_are_refused(entry):
    plan, arrays, _, _ = _plans()
    with pytest.raises(ValueError, match="2 CUDA devices"):
        _refusers(plan, arrays, TWO_CARDS)[entry]()


@pytest.mark.parametrize("entry", ["contract_sharded", "run_sharded",
                                   "contract_multihost", "sample_bitstrings"])
def test_a_card_other_than_the_current_one_is_refused(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    plan, arrays, _, _ = _plans()
    with pytest.raises(ValueError, match="not the current CUDA device"):
        _refusers(plan, arrays, ["cpu", "cuda:1"])[entry]()


def test_check_devices_accepts_cpus_and_the_current_card(monkeypatch):
    check_devices(["cpu", "cpu", "cpu"])
    check_devices(["cuda:0", "cpu", "cuda"])  # no card here: not compared
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    check_devices(["cuda:1", "cuda:1", "cpu"])
    with pytest.raises(ValueError, match="not the current CUDA device"):
        check_devices(["cuda"])  # "cuda" is cuda:0


def test_sessions_on_other_devices_keep_their_own_prologue():
    plan, arrays, _, _ = _plans()
    assert plan.can_hoist
    sess = ContractionSession(plan, arrays)
    assert sess.on("cpu") is sess
    a = plan.contract_prologue(arrays)
    b = plan.contract_prologue(arrays, device="cpu")
    assert all(x is y for x, y in zip(a, b))  # the plan's device: one entry


def test_sharded_sampling_equals_unsharded():
    circ = circuits.sycamore_like(3, 3, 8, seed=2)
    kw = dict(num_samples=200, open_qubits=(6, 7, 8), target_dim=4,
              device="cpu", seed=1, use_cache=False)
    one = sample_bitstrings(circ, **kw)
    assert one.report.num_sliced > 0
    same = sample_bitstrings(circ, devices=["cpu"], **kw)
    assert np.array_equal(same.batch.flat(), one.batch.flat())
    two = sample_bitstrings(circ, devices=CPU2, **kw)
    np.testing.assert_allclose(two.batch.flat(), one.batch.flat(),
                               rtol=SELF_RTOL, atol=1e-7)
    assert two.bitstrings == one.bitstrings
    ref = ref_sample(ref_circuits.sycamore_like(3, 3, 8, seed=2),
                     num_samples=200, open_qubits=(6, 7, 8), target_dim=4,
                     seed=1, use_cache=False)
    np.testing.assert_allclose(two.batch.flat(), np.asarray(ref.batch.flat()),
                               rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# atomic slice checkpoints and the CheckpointManager
# ----------------------------------------------------------------------
def test_slice_checkpoint_round_trip(tmp_path):
    st = SliceRangeCheckpoint(32, {(0, 4), (10, 12)}, 0.0)
    st.partial = st.partial + np.full((2,), 1 + 2j, np.complex64)
    p = str(tmp_path / "host_0.npz")
    save_slice_checkpoint(p, st)
    back = load_slice_checkpoint(p)
    assert back.n_slices == 32
    assert back._intervals() == st._intervals()
    np.testing.assert_array_equal(back.partial, st.partial)
    # a tensor partial goes to the host on save
    st.partial = torch.tensor([3 + 1j, 0j], dtype=torch.complex64)
    save_slice_checkpoint(p, st)
    np.testing.assert_array_equal(load_slice_checkpoint(p).partial,
                                  st.partial.numpy())


def test_slice_checkpoint_scalar_partial(tmp_path):
    p = str(tmp_path / "s.npz")
    save_slice_checkpoint(p, SliceRangeCheckpoint(8, set(), 0.0))
    assert load_slice_checkpoint(p).partial == 0.0


def test_slice_checkpoint_replace_is_atomic(tmp_path):
    p = str(tmp_path / "host_0.npz")
    good = SliceRangeCheckpoint(16, {(0, 8)}, 0.0)
    save_slice_checkpoint(p, good)
    with open(p + ".tmp.999", "wb") as f:
        f.write(b"truncated garbage")
    assert load_slice_checkpoint(p)._intervals() == [(0, 8)]
    good.add_range(8, 16)
    save_slice_checkpoint(p, good)
    assert load_slice_checkpoint(p)._intervals() == [(0, 16)]
    assert os.path.exists(p + ".tmp.999")  # a foreign temp stays untouched


def _tree(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn(3, 4, generator=g),
            "b": torch.randn(4, generator=g, dtype=torch.float64),
            "h": torch.randn(2, 3, generator=g).to(torch.bfloat16),
        },
        "layers": [torch.randn(2, 2, generator=g, dtype=torch.complex64),
                   (torch.arange(5), torch.tensor(seed))],
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("blocking", [True, False])
def test_checkpoint_manager_round_trip(tmp_path, blocking):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    tree = _tree(0)
    mgr.save(7, tree, blocking=blocking)
    mgr.wait()
    back = mgr.restore(_tree(1), device="cpu")
    _assert_tree_equal(back, tree)
    assert mgr.latest_step() == 7


def test_checkpoint_manager_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in range(5):
        mgr.save(step, _tree(step))
    mgr.wait()
    assert mgr.steps() == [3, 4]
    _assert_tree_equal(mgr.restore(_tree(0), step=3), _tree(3))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_tree(0))


def test_checkpoint_manager_surfaces_async_errors(tmp_path, monkeypatch):
    from repro_torch.checkpoint import manager

    mgr = CheckpointManager(str(tmp_path / "ck"))

    class Boom:
        def __array__(self, *a, **k):
            raise RuntimeError("no host copy")

    with pytest.raises(RuntimeError):  # the host copy is synchronous
        mgr.save(0, {"x": Boom()})

    def failing_savez(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(manager.np, "savez", failing_savez)
    mgr.save(1, _tree(0))  # the write fails on the background thread
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    monkeypatch.undo()
    assert mgr.steps() == []
    mgr.save(2, _tree(0))
    mgr.wait()
    assert mgr.steps() == [2]
