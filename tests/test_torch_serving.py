"""The port's contraction server on the CPU: twins of
``tests/test_serving.py`` (with ``device="cpu"``), a mixed burst held
against the JAX package's ``simulate_amplitude``, and the execution gate
that keeps one contraction on a device at a time.

Every ``result()`` and every join carries a timeout, so a deadlock fails
a test instead of hanging the suite.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulate_amplitude as ref_simulate  # noqa: E402
from repro.quantum import circuits as ref_circuits  # noqa: E402

from repro_torch.core import plan_compiled  # noqa: E402
from repro_torch.core.executor import running, simplify_network  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    AmplitudeRequest,
    EngineServer,
    SampleRequest,
    ServerOverloaded,
    Ticket,
    circuit_fingerprint,
    execution_gate,
)
from repro_torch.hardware import H100_SXM  # noqa: E402
from repro_torch.quantum import circuits, statevector  # noqa: E402
from repro_torch.quantum.circuits import random_1d_circuit  # noqa: E402

CIRC = random_1d_circuit(8, 6, seed=1)
N = CIRC.num_qubits
TD = 10
T = 300  # seconds any ticket or join may take
CPU = dict(device="cpu")
RTOL, ATOL = 1e-4, 1e-5  # amplitudes against the reference
SMALL_HW = dataclasses.replace(
    H100_SXM, name="small", tile=4, block_candidates=(4, 8),
    einsum_flops_floor=64.0, chain_budget_bytes=1 << 16,
)


def _oracle(bits: str) -> complex:
    return complex(statevector.amplitude(CIRC, bits, device="cpu"))


def _bits(i: int) -> str:
    return format(i, f"0{N}b")


def _tickets(srv: EngineServer, reqs) -> list[Ticket]:
    """Normalized tickets handed to ``_run_group`` without the queue."""
    out = []
    for i, r in enumerate(reqs):
        srv._normalize(r)
        out.append(Ticket(id=i, request=r, t_submit=time.monotonic()))
    return out


def _join(threads):
    for t in threads:
        t.join(timeout=T)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


# ----------------------------------------------------------------------
# end-to-end: mixed burst through submit/dispatch
# ----------------------------------------------------------------------
def test_mixed_burst_oracle_exact():
    bitstrings = [_bits(i) for i in (0, 1, 2, 3, 130)]
    with EngineServer(max_batch=8, max_open=4, **CPU) as srv:
        amp_tix = [srv.submit(AmplitudeRequest(CIRC, bs, target_dim=TD))
                   for bs in bitstrings]
        smp_tix = srv.submit(SampleRequest(CIRC, num_samples=256, target_dim=TD, seed=3))
        for t in amp_tix:
            t.result(timeout=T)
        res = smp_tix.result(timeout=T)
    for bs, t in zip(bitstrings, amp_tix):
        assert t.status == "done" and t.done()
        np.testing.assert_allclose(t.value, _oracle(bs), atol=1e-6)
        assert t.t_done >= t.t_start >= t.t_submit > 0
        assert t.total_s >= t.compute_s >= 0.0
        assert t.queue_s >= 0.0
        assert t.report is not None
    assert res.num_samples == 256
    assert np.isfinite(res.xeb)
    st = srv.stats()
    assert st["completed"] == len(amp_tix) + 1
    assert st["failed"] == 0 and st["rejected"] == 0
    assert st["queue_depth"] == 0
    assert st["warm_families"] >= 1


def test_mixed_burst_matches_reference():
    """A burst on a 3x3 Sycamore-like circuit (the small Hardware sends
    its steps to the kernels' plain versions), against the JAX package's
    ``simulate_amplitude`` on the same circuit and bitstrings."""
    c = circuits.sycamore_like(3, 3, 8, seed=2)
    ref_c = ref_circuits.sycamore_like(3, 3, 8, seed=2)
    rng = np.random.default_rng(7)
    bitstrings = ["00000" + "".join(map(str, rng.integers(0, 2, 4))) for _ in range(6)]
    bitstrings += ["110100101"]
    pk = {"hw": SMALL_HW}
    with EngineServer(max_batch=8, max_open=4, **CPU) as srv:
        tix = [srv.submit(AmplitudeRequest(c, bs, target_dim=6, plan_kwargs=pk))
               for bs in bitstrings]
        smp = srv.submit(SampleRequest(c, num_samples=64, open_qubits=(6, 7, 8),
                                       target_dim=6, plan_kwargs=pk))
        got = [t.result(timeout=T) for t in tix]
        batch = smp.result(timeout=T).batch
    for bs, g in zip(bitstrings, got):
        want = complex(np.asarray(ref_simulate(ref_c, bs, target_dim=6, backend="gemm").value))
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL)
    for i, amp in enumerate(batch.flat()):
        want = complex(np.asarray(ref_simulate(
            ref_c, batch.bitstring_for(i), target_dim=6, backend="gemm").value))
        np.testing.assert_allclose(amp, want, rtol=RTOL, atol=ATOL)


def test_warm_family_reuses_plan():
    with EngineServer(max_batch=4, **CPU) as srv:
        srv.submit(AmplitudeRequest(CIRC, _bits(0), target_dim=TD)).result(timeout=T)
        assert srv.stats()["warm_families"] == 1
        t = srv.submit(AmplitudeRequest(CIRC, _bits(5), target_dim=TD))
        np.testing.assert_allclose(t.result(timeout=T), _oracle(_bits(5)), atol=1e-6)
        assert t.report.cache_hit
    st = srv.stats()
    assert st["warm_groups"] >= 1 and st["cold_groups"] >= 1


# ----------------------------------------------------------------------
# group-level behaviour (deterministic: one group handed to _run_group)
# ----------------------------------------------------------------------
def test_amplitude_group_coalesces_to_one_batch():
    srv = EngineServer(max_open=3, **CPU)
    bitstrings = [_bits(0), _bits(1), _bits(4), _bits(5), _bits(5)]
    reqs = [AmplitudeRequest(CIRC, bs, target_dim=TD) for bs in bitstrings]
    ts = _tickets(srv, reqs)
    srv._run_group(srv._family_key(reqs[0]), ts, warm=False)
    for bs, t in zip(bitstrings, ts):
        assert t.status == "done"
        assert t.batched
        np.testing.assert_allclose(t.value, _oracle(bs), atol=1e-6)
    st = srv.stats()
    assert st["coalesced"] == len(ts)
    assert st["groups"] == 1 and st["completed"] == len(ts)


def test_amplitude_group_too_spread_falls_back_to_scalar():
    srv = EngineServer(max_open=2, **CPU)
    bitstrings = [_bits(0), _bits(0b10101010)]
    reqs = [AmplitudeRequest(CIRC, bs, target_dim=TD) for bs in bitstrings]
    ts = _tickets(srv, reqs)
    srv._run_group(srv._family_key(reqs[0]), ts, warm=False)
    for bs, t in zip(bitstrings, ts):
        assert t.status == "done" and not t.batched
        np.testing.assert_allclose(t.value, _oracle(bs), atol=1e-6)
    assert srv.stats()["coalesced"] == 0


def test_duplicate_bitstrings_share_one_contraction():
    srv = EngineServer(**CPU)
    reqs = [AmplitudeRequest(CIRC, _bits(7), target_dim=TD) for _ in range(3)]
    ts = _tickets(srv, reqs)
    srv._run_group(srv._family_key(reqs[0]), ts, warm=False)
    assert len({t.value for t in ts}) == 1
    assert all(t.batched for t in ts)
    np.testing.assert_allclose(ts[0].value, _oracle(_bits(7)), atol=1e-6)


def test_sample_group_shares_one_contraction():
    srv = EngineServer(**CPU)
    reqs = [SampleRequest(CIRC, num_samples=128, open_qubits=(5, 6, 7),
                          target_dim=TD, seed=s) for s in (0, 1)]
    ts = _tickets(srv, reqs)
    key = srv._family_key(reqs[0])
    assert key == srv._family_key(reqs[1])
    srv._run_group(key, ts, warm=False)
    for t in ts:
        assert t.status == "done" and t.batched
        assert t.value.num_samples == 128
    assert ts[0].value.batch is ts[1].value.batch  # one contraction
    assert srv.stats()["coalesced"] == 2
    for t in ts:
        for s in t.value.bitstrings[:8]:
            assert s[: N - 3] == "0" * (N - 3)


def test_family_key_separates_plans_and_structures():
    srv = EngineServer(**CPU)
    a = AmplitudeRequest(CIRC, _bits(0), target_dim=TD)
    b = AmplitudeRequest(CIRC, _bits(1), target_dim=TD)
    c = AmplitudeRequest(CIRC, _bits(0), target_dim=TD + 2)
    d = AmplitudeRequest(CIRC, _bits(0), target_dim=TD,
                         plan_kwargs={"precision": "bf16"})
    other = random_1d_circuit(8, 6, seed=9)
    e = AmplitudeRequest(other, _bits(0), target_dim=TD)
    assert srv._family_key(a) == srv._family_key(b)
    assert srv._family_key(a) != srv._family_key(c)
    assert srv._family_key(a) != srv._family_key(d)
    assert srv._family_key(a) != srv._family_key(e)
    assert circuit_fingerprint(CIRC) != circuit_fingerprint(other)


# ----------------------------------------------------------------------
# backpressure + failure + validation
# ----------------------------------------------------------------------
def test_backpressure_rejects_with_retry_hint(monkeypatch):
    with EngineServer(max_queue=2, max_batch=1, **CPU) as srv:
        srv.submit(AmplitudeRequest(CIRC, _bits(0), target_dim=TD)).result(timeout=T)
        gate, started = threading.Event(), threading.Event()
        orig = srv._run_group

        def blocked(key, tickets, warm):
            started.set()
            gate.wait(timeout=T)
            orig(key, tickets, warm)

        monkeypatch.setattr(srv, "_run_group", blocked)
        held = srv.submit(AmplitudeRequest(CIRC, _bits(1), target_dim=TD))
        assert started.wait(timeout=T)
        queued = [srv.submit(AmplitudeRequest(CIRC, _bits(i), target_dim=TD))
                  for i in (2, 3)]
        with pytest.raises(ServerOverloaded) as exc:
            srv.submit(AmplitudeRequest(CIRC, _bits(4), target_dim=TD))
        assert exc.value.retry_after_s > 0
        assert exc.value.depth == 2
        gate.set()
        for t in [held, *queued]:
            t.result(timeout=T)
    assert srv.stats()["rejected"] == 1


def test_group_failure_propagates_to_every_ticket():
    srv = EngineServer(**CPU)
    reqs = [AmplitudeRequest(CIRC, _bits(i), target_dim=TD,
                             plan_kwargs={"backend": "no-such-backend"})
            for i in (0, 1)]
    ts = _tickets(srv, reqs)
    srv._run_group(srv._family_key(reqs[0]), ts, warm=False)
    for t in ts:
        assert t.status == "failed" and t.done()
        with pytest.raises(ValueError):
            t.result(timeout=1)
    assert srv.stats()["failed"] == 2


def test_stop_drains_accepted_tickets():
    srv = EngineServer(max_batch=4, **CPU)
    srv.start()
    ts = [srv.submit(AmplitudeRequest(CIRC, _bits(i), target_dim=TD)) for i in (0, 1, 2)]
    srv.stop()
    for t in ts:
        assert t.done()
        t.result(timeout=1)
    with pytest.raises(RuntimeError):
        srv.submit(AmplitudeRequest(CIRC, _bits(0), target_dim=TD))


def test_submit_validates_before_enqueue():
    with EngineServer(**CPU) as srv:
        with pytest.raises(ValueError):
            srv.submit(AmplitudeRequest(CIRC, "01"))
        with pytest.raises(ValueError):
            srv.submit(AmplitudeRequest(CIRC, "2" * N))
        with pytest.raises(ValueError):
            srv.submit(SampleRequest(CIRC, num_samples=0))
        with pytest.raises(ValueError):
            srv.submit(SampleRequest(CIRC, sampler="bogus"))
        with pytest.raises(ValueError):
            srv.submit(SampleRequest(CIRC, base_bitstring="1"))
        with pytest.raises(ValueError):  # the device is the server's
            srv.submit(AmplitudeRequest(CIRC, _bits(0), plan_kwargs={"device": "cpu"}))
        with pytest.raises(TypeError):
            srv.submit("not a request")
        assert srv.stats()["submitted"] == 0


def test_server_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineServer()


# ----------------------------------------------------------------------
# the execution gate: one contraction on a device at a time
# ----------------------------------------------------------------------
def _chained_plan():
    c = circuits.sycamore_like(3, 4, 8, seed=1)
    tn, arrays = simplify_network(*circuits.circuit_to_network(c, bitstring="0" * 12))
    plan, _ = plan_compiled(tn, 8, device="cpu", hw=SMALL_HW)
    assert plan.chain_plan is not None and plan.chain_plan.num_multi > 0
    return plan, arrays


def test_threads_on_one_plan_agree_bitwise_one_at_a_time():
    """Eight threads (more than the cores, where there are fewer) running
    one cached plan (with fused chains), with a shortened switch interval,
    read bitwise the single-threaded amplitude, and the step programs
    never ran two at once on the device."""
    plan, arrays = _chained_plan()
    want = plan.contract_all(arrays)
    counter = running("cpu")
    counter.reset()
    n = max(8, min(32, (os.cpu_count() or 1) + 1))
    barrier = threading.Barrier(n, timeout=T)
    results: list = [None] * n

    def work(i):
        barrier.wait()
        results[i] = plan.contract_all(arrays, hoist=bool(i % 2))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(interval)
    hoisted = [r for i, r in enumerate(results) if i % 2]
    naive = [r for i, r in enumerate(results) if not i % 2]
    assert all(torch.equal(r, want) for r in hoisted)
    want_naive = plan.contract_all(arrays, hoist=False)
    assert all(torch.equal(r, want_naive) for r in naive)
    assert counter.peak == 1


def test_gate_holds_back_a_second_contraction():
    """While one thread holds the device's gate, another thread's
    contraction does not start its steps; it starts once the gate is
    released."""
    plan, arrays = _chained_plan()
    gate = execution_gate("cpu")
    held, release, entered = threading.Event(), threading.Event(), threading.Event()
    orig = plan._run_steps_on

    def watched(*a, **k):
        entered.set()
        return orig(*a, **k)

    plan._run_steps_on = watched
    out = []

    def holder():
        with gate.hold():
            held.set()
            release.wait(timeout=T)

    try:
        threads = [threading.Thread(target=holder),
                   threading.Thread(target=lambda: out.append(plan.contract_all(arrays)))]
        threads[0].start()
        assert held.wait(timeout=T)
        threads[1].start()
        assert not entered.wait(timeout=0.5)
        release.set()
        assert entered.wait(timeout=T)
        _join(threads)
    finally:
        release.set()
        del plan._run_steps_on
    assert len(out) == 1


def test_server_burst_executes_one_contraction_at_a_time():
    """Two dispatchers and a planner pool under a burst of two families:
    every amplitude is exact and the device ran one step program at a
    time."""
    other = random_1d_circuit(8, 5, seed=3)
    counter = running("cpu")
    counter.reset()
    with EngineServer(max_batch=3, max_open=3, dispatchers=2, planner_threads=3,
                      **CPU) as srv:
        tix = [(circ, bs, srv.submit(AmplitudeRequest(circ, bs, target_dim=TD)))
               for i in range(6) for circ, bs in ((CIRC, _bits(i)), (other, _bits(4 * i)))]
        for circ, bs, t in tix:
            want = complex(statevector.amplitude(circ, bs, device="cpu"))
            np.testing.assert_allclose(t.result(timeout=T), want, atol=1e-6)
    assert counter.peak == 1
    assert srv.stats()["completed"] == len(tix)


def test_serve_cli_bursts(capsys):
    """``python -m repro_torch.launch.serve`` on the CPU: a cold and a
    warm burst, every request served; without ``--device cpu`` and no
    GPU it raises."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--rows", "2", "--cols", "3", "--cycles", "6",
                "--target-dim", "4", "--amps", "6", "--samples", "1", "--vary", "3"])
    out = capsys.readouterr().out
    assert "burst 0 (cold)" in out and "burst 1 (warm)" in out
    assert "served 14 ok / 0 failed / 0 rejected" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main([])
