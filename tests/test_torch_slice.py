"""The port's main path on the CPU — amplitudes and samples — against the
JAX reference (``backend="gemm"``) and the statevector oracle.

Tolerance: rtol 1e-4, atol 1e-5, the reference suite's for amplitudes
against the statevector.  A small Hardware object (4-wide tile) sends
steps of these small circuits to the tiled and fused kernels' plain
versions, as the card's constants do at full size.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan_contraction as ref_plan_contraction  # noqa: E402
from repro.core import sample_bitstrings as ref_sample  # noqa: E402
from repro.core import simulate_amplitude as ref_simulate  # noqa: E402
from repro.core.executor import simplify_network as ref_simplify  # noqa: E402
from repro.quantum import circuits as ref_circuits  # noqa: E402
from repro.quantum import statevector as ref_sv  # noqa: E402
from repro.quantum import xeb as ref_xeb  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import (  # noqa: E402
    open_session,
    sample_bitstrings,
    simulate_amplitude,
)
from repro_torch.core.executor import simplify_network  # noqa: E402
from repro_torch.engine.session import mask_invalid, padded_ids  # noqa: E402
from repro_torch.hardware import H100_SXM  # noqa: E402
from repro_torch.kernels import contract_gemm as cg  # noqa: E402
from repro_torch.quantum import circuits, statevector  # noqa: E402
from repro_torch.quantum import xeb  # noqa: E402
from repro_torch.sampling import AmplitudeBatch, samplers  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
SMALL_HW = dataclasses.replace(
    H100_SXM, name="small", tile=4, block_candidates=(4, 8),
    einsum_flops_floor=64.0, chain_budget_bytes=1 << 16,
)
CPU = dict(device="cpu")

AMP_CASES = [
    # rows, cols, cycles, target_dim, bitstring seed
    (3, 3, 6, 6, 0),
    (3, 4, 8, 8, 1),
    (2, 3, 8, 4, 2),
]


def _bits(n, seed):
    return "".join(str(b) for b in np.random.default_rng(seed).integers(0, 2, n))


@functools.lru_cache(maxsize=None)
def _reference(rows, cols, cycles, target, bseed):
    """The reference's gemm-backend amplitude and its statevector's."""
    circ = ref_circuits.sycamore_like(rows, cols, cycles)
    bits = _bits(rows * cols, bseed)
    res = ref_simulate(circ, bits, target_dim=target, backend="gemm",
                       use_cache=False)
    return res, ref_sv.amplitude(circ, bits)


@pytest.mark.parametrize("rows,cols,cycles,target,bseed", AMP_CASES)
@pytest.mark.parametrize("backend,hw", [
    ("gemm", SMALL_HW), ("gemm", H100_SXM), ("einsum", H100_SXM),
])
def test_amplitude_matches_reference_and_statevector(
    rows, cols, cycles, target, bseed, backend, hw
):
    n = rows * cols
    bits = _bits(n, bseed)
    got = simulate_amplitude(
        circuits.sycamore_like(rows, cols, cycles), bits, target_dim=target,
        backend=backend, hw=hw, **CPU,
    )
    want, sv = _reference(rows, cols, cycles, target, bseed)
    np.testing.assert_allclose(got.value, want.value, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.value, sv, rtol=RTOL, atol=ATOL)
    port_sv = statevector.amplitude(
        circuits.sycamore_like(rows, cols, cycles), bits, **CPU)
    np.testing.assert_allclose(got.value, port_sv, rtol=RTOL, atol=ATOL)


def test_small_hw_reaches_every_kernel_path():
    """The small-hardware plan used above really routes steps to the
    tiled and fused kernels and plans chains (their plain versions run
    here)."""
    res = simulate_amplitude(
        circuits.sycamore_like(4, 4, 8), "0" * 16, target_dim=10,
        hw=SMALL_HW, **CPU,
    )
    counts = res.report.lowered_backends
    assert counts.get("fused", 0) > 0 and res.report.fused_chains > 0
    res_nf = simulate_amplitude(
        circuits.sycamore_like(4, 4, 8), "0" * 16, target_dim=10,
        hw=SMALL_HW, fused=False, **CPU,
    )
    assert res_nf.report.lowered_backends.get("tiled", 0) > 0
    assert "fused" not in res_nf.report.lowered_backends
    np.testing.assert_allclose(res.value, res_nf.value, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["gemm", "einsum"])
def test_reference_plan_executes_in_port(backend):
    """The reference's exact (tree, S), carried over as plain values,
    executes in the port to the reference's amplitude."""
    rows, cols, cycles, target, bseed = AMP_CASES[-1]
    circ_r = ref_circuits.sycamore_like(rows, cols, cycles)
    bits = _bits(rows * cols, bseed)
    tn_r, arr_r = ref_simplify(*ref_circuits.circuit_to_network(circ_r, bitstring=bits))
    tree_r, s_r, _ = ref_plan_contraction(tn_r, target)
    assert s_r, "want a sliced plan"
    tn = interop.network_from_reference(tn_r.inputs, tn_r.open_inds, tn_r.ind_sizes)
    tree = interop.tree_from_reference(tn, tree_r.children, tree_r.root)
    plan = interop.plan_from_reference(tree, s_r, backend=backend, hw=SMALL_HW, **CPU)
    got = plan.contract_all([np.asarray(a) for a in arr_r]).numpy()
    want, _ = _reference(*AMP_CASES[-1])
    assert want.smask == s_r and want.tree.children == tree_r.children
    np.testing.assert_allclose(got, want.value, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", [SMALL_HW, H100_SXM])
def test_hoist_on_off_agree(hw):
    bits = _bits(12, 4)
    c = circuits.sycamore_like(3, 4, 8, seed=1)
    on = simulate_amplitude(c, bits, target_dim=7, hoist=True, hw=hw, **CPU)
    off = simulate_amplitude(c, bits, target_dim=7, hoist=False, hw=hw, **CPU)
    assert on.report.num_sliced > 0 and on.plan.can_hoist
    assert on.report.hoist and not off.report.hoist
    np.testing.assert_allclose(on.value, off.value, rtol=RTOL, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _reference_samples(**kw):
    return ref_sample(ref_circuits.sycamore_like(3, 4, 6, seed=2),
                      backend="gemm", use_cache=False, **kw)


@pytest.mark.parametrize("backend", ["gemm", "einsum"])
def test_sampling_matches_reference(backend):
    """Same open-qubit batch as the reference's gemm backend, the same
    drawn bitstrings for the same seed, the same XEB."""
    c = circuits.sycamore_like(3, 4, 6, seed=2)
    kw = dict(num_samples=200, open_qubits=(9, 10, 11), target_dim=7, seed=5)
    got = sample_bitstrings(c, backend=backend, hw=SMALL_HW, **kw, **CPU)
    want = _reference_samples(**kw)
    np.testing.assert_allclose(
        got.batch.amplitudes, want.batch.amplitudes, rtol=RTOL, atol=ATOL)
    # the batch against the statevector's entries
    psi = statevector.simulate(c, **CPU).numpy()
    flat = [psi[int(got.batch.bitstring_for(i), 2)] for i in range(8)]
    np.testing.assert_allclose(got.batch.flat(), flat, rtol=RTOL, atol=ATOL)
    assert got.bitstrings == want.bitstrings
    assert got.xeb == pytest.approx(want.xeb, rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("sampler", ["frequency", "rejection", "topk"])
def test_samplers_on_reference_probabilities(sampler):
    """The port's samplers, fed the reference's amplitude batch, draw the
    reference's bitstrings for the same seed."""
    from repro.sampling import AmplitudeBatch as RefBatch
    from repro.sampling import samplers as ref_samplers

    rng = np.random.default_rng(3)
    amps = (rng.standard_normal((2, 2, 2, 2)) + 1j * rng.standard_normal((2, 2, 2, 2))).astype(np.complex64)
    base = "0101010101"
    ref_b = RefBatch(amps, (2, 5, 7, 9), base, 10)
    b = AmplitudeBatch(amps, (2, 5, 7, 9), base, 10)
    n = 12 if sampler == "topk" else 300
    idx_r = ref_samplers.draw(ref_b, n, sampler=sampler, seed=11)
    idx_p = samplers.draw(b, n, sampler=sampler, seed=11)
    np.testing.assert_array_equal(idx_p, idx_r)
    assert b.bitstrings_for(idx_p) == ref_b.bitstrings_for(idx_r)
    probs = ref_sv.probabilities(ref_circuits.sycamore_like(2, 2, 4))
    np.testing.assert_array_equal(
        xeb.sample_bitstrings(probs, 50, seed=2),
        ref_xeb.sample_bitstrings(probs, 50, seed=2),
    )


def test_ragged_run_slices_ignores_nan_in_masked_lane(monkeypatch):
    """A NaN planted in the contribution of a padded (masked) lane does
    not reach the batch's sum."""
    sess, _ = open_session(
        circuits.sycamore_like(3, 4, 8, seed=1), _bits(12, 4), target_dim=7,
        hw=SMALL_HW, **CPU,
    )
    ids, valid, total = padded_ids(sess.n_slices, 3)
    chunk, ok = ids[total - 3:], valid[total - 3:]
    assert ok.any() and not ok.all()
    want = sum(sess.run_slice(int(i)) for i in chunk[ok])
    poisoned = {int(i) for i in chunk[~ok]}
    real = sess.plan.contract_slice

    def contract(arrays, sid, hoisted=None):
        out = real(arrays, sid, hoisted)
        return out * float("nan") if sid in poisoned else out

    monkeypatch.setattr(sess.plan, "contract_slice", contract)
    got = sess.run_slices(chunk, ok)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_mask_invalid_is_a_select():
    contrib = torch.tensor([[1.0, 2.0], [float("nan"), float("inf")], [3.0, 4.0]])
    out = mask_invalid(contrib, torch.tensor([True, False, True]))
    assert torch.equal(out, torch.tensor([[1.0, 2.0], [0.0, 0.0], [3.0, 4.0]]))


def test_run_slices_partial_sums_add_up():
    sess, _ = open_session(
        circuits.sycamore_like(3, 4, 8, seed=1), _bits(12, 4), target_dim=7,
        hw=SMALL_HW, **CPU,
    )
    ids = np.arange(sess.n_slices)
    parts = sess.run_slices(ids[::2]) + sess.run_slices(ids[1::2])
    torch.testing.assert_close(parts, sess.run_all(), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        sess.run_slices(ids, np.zeros(len(ids), bool)), torch.zeros_like(parts))


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = circuits.sycamore_like(2, 2, 2)
    for call in (
        lambda: simulate_amplitude(c, "0000", target_dim=4),
        lambda: sample_bitstrings(c, num_samples=4, target_dim=4),
        lambda: open_session(c, "0000", target_dim=4),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cpu_path_launches_no_kernel():
    cg.reset_launches()
    simulate_amplitude(circuits.sycamore_like(3, 3, 6), "0" * 9, target_dim=6,
                       hw=SMALL_HW, **CPU)
    assert set(cg.LAUNCHES.values()) == {0}


def test_network_interop_roundtrip():
    tn_r, _ = ref_simplify(*ref_circuits.circuit_to_network(
        ref_circuits.sycamore_like(3, 3, 5), bitstring="0" * 9))
    tn_p, _ = simplify_network(*circuits.circuit_to_network(
        circuits.sycamore_like(3, 3, 5), bitstring="0" * 9))
    tn = interop.network_from_reference(tn_r.inputs, tn_r.open_inds, tn_r.ind_sizes)
    assert tn.masks == tn_p.masks and tn.inputs == tn_p.inputs
