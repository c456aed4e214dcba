#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the contraction kernels from ``src/repro_torch/kernels/csrc`` and
drives the simulator's main path through its public entry points at the
full width of the circuits it supports:

  1. build     — nvcc for sm_90a; build seconds and the card's name and
                 power limit;
  2. kernels   — each kernel (tiled_gemm, fused_gemm, chain_gemm) at the
                 shapes of the 30-qubit plan (its largest tiled step,
                 largest fused step, longest chain), held against its
                 plain PyTorch version on the card (max error relative to
                 max|plain| <= 1e-4: another summation order than the
                 library's), timed with CUDA events beside its bound;
  3. amplitude — simulate_amplitude on sycamore_like(5, 6, 14), 30 qubits,
                 every slice, held against the port's statevector on the
                 card (relative error <= 1e-3: fp32 sums over ~150 steps
                 and 2^|S| slices against ~600 fp32 gate applications);
     trace     — a profiler trace of one slice of that plan: device busy
                 share and the kernels that take the time;
  4. sampling  — sample_bitstrings with the last 4 qubits open, 1000
                 samples; the batch against the einsum oracle backend and
                 the statevector;
  5. share     — open_session on sycamore_like(6, 6, 14), 36 qubits (more
                 than any statevector on one card holds), run_slices on 2
                 slice ids against the einsum oracle on the same ids;
  6. kernels   — one JSON line listing every kernel with its launches on
                 phases 3-5 (each must be > 0).

Each phase prints one JSON line; any failed check raises, so the exit code
is non-zero.  The last line is the device summary.  With no CUDA device,
or without the repository around it, the script fails before printing any
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

FP32_PEAK = 67e12  # H100 SXM data sheet, FP32 on the CUDA cores
HBM_BW = 3.35e12  # H100 SXM data sheet, HBM3
KERNEL_TOL = 1e-4
AMP_TOL = 1e-3
TPU_KERNELS = {
    "tiled_gemm": "src/repro/kernels/contract_gemm.py:45",
    "fused_gemm": "src/repro/kernels/contract_gemm.py:164",
    "chain_gemm": "src/repro/kernels/contract_gemm.py:421",
}
SOURCE = "src/repro_torch/kernels/csrc/gemm.cu"


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def emit(**kw) -> None:
    print(json.dumps(kw, default=float), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    n = int(max(3, min(50, 200.0 / once)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_mem = flops / FP32_PEAK, nbytes / HBM_BW
    return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return diff, diff / max(scale, 1e-30)


def network(circuits, simplify_network, circ, bits, open_qubits=None):
    kw = {"bitstring": bits}
    if open_qubits is not None:
        kw["open_qubits"] = open_qubits
    return simplify_network(*circuits.circuit_to_network(circ, **kw))


def phase_kernels(torch, plan, cg) -> dict:
    """Each kernel at the main path's own shapes against its plain
    version; returns per-kernel timing records."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    dev = torch.device("cuda")

    def rnd(shape, scale=1.0):
        return (scale * torch.randn(tuple(shape), generator=gen)).to(dev)

    specs = plan.schedule.specs
    out = {}

    # K1: the largest tiled step, one real GEMM of its Karatsuba
    tiled = [s for s in specs if s.backend == "tiled"]
    check(bool(tiled), "the plan has no tiled step")
    f = max(tiled, key=lambda s: s.form.flops).form
    a, b = rnd((f.B, f.M, f.K)), rnd((f.B, f.K, f.N))
    got = cg.tiled_gemm(a, b)
    want = cg.tiled_gemm_plain(a, b)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got], [want])
    check(rel <= KERNEL_TOL, f"tiled_gemm disagrees: {rel}")
    flops = 2.0 * f.B * f.M * f.N * f.K
    nbytes = 4.0 * f.B * (f.M * f.K + f.K * f.N + f.M * f.N)
    b_ms, b_by = bound(flops, nbytes)
    out["tiled_gemm"] = dict(
        shape=[f.B, f.M, f.N, f.K], max_abs_err=err, rel_err=rel,
        ms=cuda_ms(torch, lambda: cg.tiled_gemm(a, b)),
        plain_ms=cuda_ms(torch, lambda: cg.tiled_gemm_plain(a, b)),
        library_ms=cuda_ms(torch, lambda: torch.matmul(a, b)),
        bound_ms=b_ms, bound_by=b_by,
    )
    del a, b, got, want

    # K2: the largest fused step, complex (Karatsuba in the kernel)
    fused = [s for s in specs if s.backend == "fused"]
    check(bool(fused), "the plan has no fused step")
    f = max(fused, key=lambda s: s.form.flops).form
    pa = (rnd(f.a_shape), rnd(f.a_shape))
    pb = (rnd(f.b_shape), rnd(f.b_shape))
    got = cg.fused_gemm(pa, pb, f)
    want = cg.fused_gemm_plain(pa, pb, f)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, got, want)
    check(rel <= KERNEL_TOL, f"fused_gemm disagrees: {rel}")
    ac, bc = torch.complex(*pa), torch.complex(*pb)
    B, M, N, K = f.B, f.M, f.N, f.K
    flops = 6.0 * B * M * N * K + 2.0 * B * (M * K + K * N) + 3.0 * B * M * N
    nbytes = 8.0 * B * (M * K + K * N + M * N)
    b_ms, b_by = bound(flops, nbytes)
    out["fused_gemm"] = dict(
        shape=[B, M, N, K], max_abs_err=err, rel_err=rel,
        ms=cuda_ms(torch, lambda: cg.fused_gemm(pa, pb, f)),
        plain_ms=cuda_ms(torch, lambda: cg.fused_gemm_plain(pa, pb, f)),
        library_ms=cuda_ms(torch, lambda: torch.einsum(f.expr, ac, bc)),
        bound_ms=b_ms, bound_by=b_by,
    )
    del pa, pb, ac, bc, got, want

    # K3: the longest chain of the epilogue (the per-slice segment)
    chains = plan.chain_plan.segment_chains("epilogue") or list(
        plan.chain_plan.chains
    )
    ch = max(chains, key=lambda c: (c.n_steps, sum(
        specs[p].form.flops for p in c.positions)))
    forms = tuple(specs[p].form for p in ch.positions)
    shapes = [forms[0].a_shape, forms[0].b_shape] + [
        forms[t].b_shape if ch.carry_side[t] == "l" else forms[t].a_shape
        for t in range(1, len(forms))
    ]
    scales = [forms[0].K ** -0.25] * 2 + [fm.K ** -0.5 for fm in forms[1:]]
    comps = [rnd(s, sc) for s, sc in zip(shapes, scales) for _ in range(2)]
    args = (comps, forms, ch.carry_side, ch.slot_ids, ch.slot_elems)
    got = cg.chain_gemm(*args, complex_mode=True)
    want = cg.chain_gemm_plain(comps, forms, ch.carry_side, True)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, got, want)
    check(rel <= KERNEL_TOL, f"chain_gemm disagrees: {rel}")
    flops = sum(
        6.0 * fm.B * fm.M * fm.N * fm.K + 2.0 * fm.B * (fm.M * fm.K + fm.K * fm.N)
        + 3.0 * fm.B * fm.M * fm.N for fm in forms
    )
    nbytes = 4.0 * (
        sum(c.numel() for c in comps) + sum(g.numel() for g in got)
    )
    b_ms, b_by = bound(flops, nbytes)
    out["chain_gemm"] = dict(
        steps=ch.n_steps, shapes=[[fm.B, fm.M, fm.N, fm.K] for fm in forms],
        max_abs_err=err, rel_err=rel,
        ms=cuda_ms(torch, lambda: cg.chain_gemm(*args, complex_mode=True)),
        plain_ms=cuda_ms(
            torch, lambda: cg.chain_gemm_plain(comps, forms, ch.carry_side, True)
        ),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )
    return out


def trace_slice(torch, open_session, circ, n: int, target: int) -> dict:
    """Profile one epilogue slice: wall time, summed device time, and the
    kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sess, _ = open_session(circ, "0" * n, target_dim=target, backend="gemm")
    sess.run_slice(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run_slice(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    return dict(
        wall_ms=1e3 * wall, device_ms=device_ms,
        device_busy_share=device_ms / (1e3 * wall),
        top=[dict(name=k[:80], ms=us / 1e3, calls=c) for us, k, c in rows[:8]],
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.core import (
        open_amplitude_batch,
        open_session,
        plan_compiled,
        plan_contraction,
        sample_bitstrings,
        simulate_amplitude,
    )
    from repro_torch.core.executor import simplify_network
    from repro_torch.kernels import build, contract_gemm as cg
    from repro_torch.quantum import circuits, statevector
    from repro_torch.sampling.batch import open_batch_network

    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    emit(phase="build", seconds=time.perf_counter() - t0, card=smi,
         torch=torch.__version__, cuda=torch.version.cuda, library=build.BUILD_INFO["path"])
    print(smi, flush=True)

    # 2. kernels against their plain versions at the main path's shapes
    rows, cols, cycles, target = 5, 6, 14, 28
    n = rows * cols
    circ = circuits.sycamore_like(rows, cols, cycles, seed=0)
    tn, _ = network(circuits, simplify_network, circ, "0" * n)
    t0 = time.perf_counter()
    plan, report = plan_compiled(tn, target)
    plan_s = time.perf_counter() - t0
    kern = phase_kernels(torch, plan, cg)
    for name, rec in kern.items():
        emit(phase="kernel", name=name, **rec)
    del plan
    torch.cuda.empty_cache()

    # 3. amplitude, every slice, against the statevector --------------
    cg.reset_launches()
    launches = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate_amplitude(circ, "0" * n, target_dim=target, backend="gemm")
    torch.cuda.synchronize()
    exec_s = time.perf_counter() - t0 - res.report.plan_wall_s
    launches["amplitude"] = dict(cg.LAUNCHES)
    if not launches["amplitude"]["tiled_gemm"]:
        # the card's refiner sent every large step to the fused kernel:
        # run once more with the fused backend off, the reference's own
        # switch, so the tiled kernel carries those steps
        res_nf = simulate_amplitude(
            circ, "0" * n, target_dim=target, backend="gemm", fused=False)
        check(abs(res_nf.value - res.value) <= AMP_TOL * abs(res.value),
              "fused=False amplitude disagrees")
    t0 = time.perf_counter()
    psi = statevector.simulate(circ)
    torch.cuda.synchronize()
    sv_s = time.perf_counter() - t0
    sv_amp = complex(psi[0].item())
    open_q = tuple(range(n - 4, n))
    sv_batch = psi[:16].cpu().numpy()  # last 4 qubits vary, base all-zero
    del psi
    torch.cuda.empty_cache()
    amp = complex(res.value)
    amp_err = abs(amp - sv_amp) / abs(sv_amp)
    check(amp_err <= AMP_TOL, f"amplitude vs statevector: {amp_err}")
    emit(phase="amplitude", qubits=n, cycles=cycles, target_dim=target,
         num_sliced=res.report.num_sliced, slices=1 << res.report.num_sliced,
         plan_s=res.report.plan_wall_s, exec_s=exec_s, statevector_s=sv_s,
         amplitude=[amp.real, amp.imag], statevector=[sv_amp.real, sv_amp.imag],
         rel_err=amp_err, backends=res.report.lowered_backends,
         chains=res.report.fused_chains, max_chain_len=res.report.max_chain_len,
         peak_bytes_planned=res.report.peak_bytes_hoisted,
         launches=launches["amplitude"], first_plan_s=plan_s)

    # 3b. where one slice's time goes: a profiler trace of one slice of
    # the same plan (device busy share, time by kernel)
    emit(phase="trace", **trace_slice(torch, open_session, circ, n, target))

    # 4. sampling with 4 open qubits, against einsum and the statevector.
    # The one-shot planner's multi-restart greedy is seed-sensitive on the
    # open-batch network (seed 0 plans 2^51 operations, 2^7 times the
    # closed amplitude's): plan a few seeds on the host, sample with the
    # cheapest plan.
    tn4, _ = open_batch_network(circ, "0" * n, open_q)
    costs = {
        s: plan_contraction(tn4, target, seed=s, repeats=32)[2].log2_sliced_cost
        for s in range(4)
    }
    seed4 = min(costs, key=costs.get)
    cg.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samp = sample_bitstrings(circ, num_samples=1000, open_qubits=open_q,
                             target_dim=target, backend="gemm", seed=seed4,
                             repeats=32)
    torch.cuda.synchronize()
    samp_s = time.perf_counter() - t0
    launches["sampling"] = dict(cg.LAUNCHES)
    oracle, _ = open_amplitude_batch(circ, open_qubits=open_q,
                                     target_dim=target, backend="einsum",
                                     seed=seed4, repeats=32)
    got_b, ein_b = samp.batch.flat(), oracle.flat()
    ein_err = float(abs(got_b - ein_b).max() / abs(ein_b).max())
    sv_err = float(abs(got_b - sv_batch).max() / abs(sv_batch).max())
    check(ein_err <= AMP_TOL, f"batch vs einsum: {ein_err}")
    check(sv_err <= AMP_TOL, f"batch vs statevector: {sv_err}")
    check(samp.num_samples == 1000, "wrong sample count")
    emit(phase="sampling", open_qubits=list(open_q), samples=samp.num_samples,
         planner_seed=seed4, log2_sliced_cost_by_seed=costs,
         num_sliced=samp.report.num_sliced,
         seconds=samp_s, rel_err_vs_einsum=ein_err,
         rel_err_vs_statevector=sv_err, xeb=samp.xeb,
         launches=launches["sampling"])
    del samp, oracle
    torch.cuda.empty_cache()

    # 5. 36 qubits, two slices of the full width --------------------
    rows5, cols5, target5 = 6, 6, 30
    n5 = rows5 * cols5
    circ5 = circuits.sycamore_like(rows5, cols5, cycles, seed=0)
    ids = [0, 1]
    cg.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess, rep5 = open_session(circ5, "0" * n5, target_dim=target5,
                              backend="gemm")
    plan5_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.hoisted()
    torch.cuda.synchronize()
    prologue_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    val = sess.run_slices(ids)
    torch.cuda.synchronize()
    slice_s = (time.perf_counter() - t0) / len(ids)
    peak = torch.cuda.max_memory_allocated()
    launches["share"] = dict(cg.LAUNCHES)
    del sess
    torch.cuda.empty_cache()
    ein_sess, _ = open_session(circ5, "0" * n5, target_dim=target5,
                               backend="einsum")
    t0 = time.perf_counter()
    ein_val = ein_sess.run_slices(ids)
    torch.cuda.synchronize()
    ein_slice_s = (time.perf_counter() - t0) / len(ids)
    del ein_sess
    share_err = float(abs(val - ein_val).max() / ein_val.abs().max())
    check(share_err <= AMP_TOL, f"36-qubit slices vs einsum: {share_err}")
    emit(phase="share", qubits=n5, target_dim=target5,
         num_sliced=rep5.num_sliced, slice_ids=ids, plan_s=plan5_s,
         prologue_s=prologue_s, seconds_per_slice=slice_s,
         einsum_seconds_per_slice=ein_slice_s, rel_err_vs_einsum=share_err,
         peak_bytes=peak, peak_bytes_planned=rep5.peak_bytes_hoisted,
         backends=rep5.lowered_backends, launches=launches["share"])

    # 6. every kernel went through the main path -------------------
    total = {k: sum(ph[k] for ph in launches.values()) for k in cg.LAUNCHES}
    for name, count in total.items():
        check(count > 0, f"{name} was not launched on the main path")
    records = []
    for name in ("tiled_gemm", "fused_gemm", "chain_gemm"):
        rec = kern[name]
        records.append(dict(
            name=name, route="cuda", source=SOURCE,
            replaces=TPU_KERNELS[name], launches=total[name],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
        ))
    emit(phase="done", seconds=time.perf_counter() - t_start,
         launches_by_phase=launches)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
