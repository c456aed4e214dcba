"""Quickstart: simulate a random quantum circuit amplitude with the
lifetime-based contraction engine, check it against the statevector
oracle, then draw correlated bitstring samples from one batched
contraction (the paper's sampling workload).

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--backend {einsum,gemm}] [--device {cuda,cpu}]

``--backend gemm`` (the default) executes the lowered kernel schedule
(every tree node normalized to GEMM form and refined onto the hand-written
kernels, ``torch.matmul`` or ``torch.einsum`` — see
``src/repro_torch/lowering/``); ``einsum`` is the oracle path.  Runs on
``--device`` (default ``cuda``; with no GPU it fails unless ``--device
cpu`` is given).  The port's twin of ``examples/quickstart.py``.
"""

from __future__ import annotations

import argparse
import time

from ..core import default_backend, sample_bitstrings, simulate_amplitude
from ..core.executor import simplify_network
from ..quantum import statevector
from ..quantum.circuits import circuit_to_network, random_1d_circuit


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn().cpu()  # wait for the device result
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("einsum", "gemm"), default=None,
                    help="execution backend (default: gemm)")
    ap.add_argument("--device", default="cuda",
                    help="where contractions run (cuda or cpu)")
    args = ap.parse_args(argv)
    backend = args.backend if args.backend is not None else default_backend()
    dev = dict(backend=backend, device=args.device)

    circuit = random_1d_circuit(n=10, cycles=8, seed=42)
    bitstring = "0110100101"

    result = simulate_amplitude(
        circuit,
        bitstring,
        target_dim=5,          # memory bound: no tensor above 2^5 entries
        method="lifetime",     # the paper's Algorithm 1 (+ tuning/merging)
        **dev,
    )
    ref = statevector.amplitude(circuit, bitstring, device=args.device)

    print("planner report :", result.report.row())
    if result.plan.schedule is not None:
        print("lowered sched  :", result.plan.schedule.summary_row())
    print("two-phase      :", result.plan.hoist_summary())
    print("amplitude      :", complex(result.value))
    print("statevector ref:", ref)
    print("|error|        :", abs(complex(result.value) - ref))
    assert abs(complex(result.value) - ref) < 1e-4
    print("OK")

    # a second request for the same circuit family hits the plan cache
    result2 = simulate_amplitude(circuit, "1001011010", target_dim=5, **dev)
    print("repeat request :", result2.report.row(),
          f"(plan {result2.report.plan_wall_s*1e3:.2f}ms)")

    # hoisting summary: invariant fraction, slices, measured speedup of
    # two-phase execution over the naive full-tree-per-slice path, timed
    # directly on the compiled plan (planning/conversion out of the loop)
    rep = result2.report
    tn, arrays = simplify_network(
        *circuit_to_network(circuit, bitstring="1001011010")
    )
    plan = result2.plan
    times = {}
    for hoist in (False, True):
        plan.contract_all(arrays, hoist=hoist)  # warm
        times[hoist] = min(
            _timed(lambda: plan.contract_all(arrays, hoist=hoist))
            for _ in range(5)
        )
    print(
        f"hoisting       : inv_frac={rep.invariant_fraction:.2f} "
        f"slices={1 << rep.num_sliced} "
        f"overhead {rep.slicing_overhead:.3f}->{rep.measured_overhead:.3f} "
        f"measured speedup={times[False] / times[True]:.2f}x "
        f"(hoist=False disables)"
    )

    # lifetime-based memory plan: exact live-set peaks + buffer slots,
    # and the peak-aware slicer (slicing_mode="peak") which stops slicing
    # once the planned peak — not the width proxy — fits the budget
    mem = plan.memory_plan()
    res_peak = simulate_amplitude(
        circuit, "1001011010", target_dim=5, slicing_mode="peak",
        use_cache=False, **dev,
    )
    assert abs(complex(res_peak.value) - complex(result2.value)) < 1e-5
    print(
        f"memory plan    : peak={mem.peak_bytes}B "
        f"hoisted={mem.peak_bytes_hoisted}B slots={mem.buffer_slots} "
        f"peak-aware |S| {rep.num_sliced}->{res_peak.report.num_sliced}"
    )

    # mixed precision under an XEB budget: precision="auto" lets the
    # planner demote kernel-sized GEMM steps to bf16-input/fp32-accumulate
    # as long as the forward error model stays inside fidelity_tol.
    # This 1-D circuit is too small to carry kernel steps, so every step
    # stays fp32 — the certified budget is reported either way.
    res_mp = simulate_amplitude(
        circuit, "1001011010", target_dim=5, precision="auto",
        fidelity_tol=0.05, use_cache=False, **dev,
    )
    counts = res_mp.report.precision_counts or {}
    print(
        f"precision      : mode={res_mp.report.precision} "
        f"tol={res_mp.report.fidelity_tol:g} "
        f"steps={counts or '{}'} "
        f"pred_amp_err={res_mp.report.predicted_amp_error:.2e}"
    )
    assert abs(complex(res_mp.value) - complex(result2.value)) < 1e-4

    # batch sampling: hold 3 output qubits open → one contraction yields
    # all 8 correlated amplitudes; draw bitstrings by frequency sampling
    samples = sample_bitstrings(
        circuit, num_samples=100, open_qubits=(7, 8, 9), target_dim=5, **dev,
    )
    print("sampled        :", samples.bitstrings[:5], "...")
    print("sampled XEB    :", f"{samples.xeb:+.4f}")
    return dict(
        amplitude=complex(result.value), statevector=ref,
        repeat_amplitude=complex(result2.value),
        repeat_cache_hit=result2.report.cache_hit,
        batch=samples.batch.flat(), xeb=samples.xeb,
    )


if __name__ == "__main__":
    main()
