#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the kernels from ``src/repro_torch/kernels/csrc`` and drives the
simulator's main path and the LM serving path through their public entry
points at full width:

  1. build     — one nvcc per source for sm_90a, all started together;
                 build seconds and the card's name and power limit;
     sass      — the wgmma kernels (tiled_gemm's TMA and in-place
                 kernels, fused_gemm, flash_attention's bf16 kernel,
                 ssd_chunk's wgmma kernel) must hold HGMMA in their SASS
                 (cuobjdump), the four bf16 instantiations of tiled_gemm's
                 in-place kernel and of fused_gemm among them;
  2. kernels   — each contraction kernel (tiled_gemm, fused_gemm,
                 chain_gemm) at the shapes of the 30-qubit plan (its
                 largest tiled step, largest fused step, longest chain),
                 held against its plain PyTorch version on the card (max
                 error relative to max|plain| <= 1e-4: another summation
                 order than the library's), timed with CUDA events beside
                 its bound (tiled_gemm and fused_gemm, 3xTF32, against
                 the TF32 rate / 3; tiled_gemm on complex64 in place in
                 GEMM order and through ops.tiled_step, the path's call
                 on the step's native layouts, beside its real TMA route
                 and that route's plane split;
                 fused_gemm on complex64 in place and through
                 ops.fused_matmul, the path's call; chain_gemm as the
                 kernel alone on the profiler's device clock, with its
                 launch state built once, at each cluster size, for one
                 step of the chain, beside an empty cluster launch, and
                 through ops.fused_chain, the path's call); the bf16
                 routes of the three (bf16 inputs, fp32 accumulation; the
                 chain with every step bf16) at the same shapes, each
                 within 1e-5 of max|plain| of its plain twin (round to
                 bf16, then the fp32 product: only the order of the sum
                 differs; the chain step by step on its own carries, and
                 whole within 2^-8, a carry's bf16 rounding apart),
                 bounded at the bf16 rate; then
                 flash_attention at qwen3-4b's prefill shapes (bf16,
                 <= 1e-2: the output's bf16 rounding alone is 2^-8) and
                 ssd_chunk at mamba2-130m's (fp32, <= 1e-4; its wgmma
                 route, the kernel alone on the profiler's device clock,
                 beside its simt route at the same shape, and an
                 overflowing decay through the wgmma route);
  3. amplitude — simulate_amplitude on sycamore_like(5, 6, 14), 30 qubits,
                 every slice, held against the port's statevector on the
                 card (relative error <= 1e-3: fp32 sums over ~150 steps
                 and 2^|S| slices against ~600 fp32 gate applications);
                 its measured peak device memory against the planner's
                 certified peak (<= planned x 1.10 + 256 MiB: allocator
                 rounding, the kernels' launch tables and the dot
                 backend's blocks of at most 64 MiB);
     precision — the same circuit in peak-mode slicing at precision="fp32"
                 and at precision="auto", fidelity_tol=0.05: the auto plan
                 must demote steps to bf16, keep |S| <= the fp32 plan's,
                 stay within 0.05 of the statevector and within its
                 certified peak (as above), and launch every bf16 step
                 through a bf16 route (the counted bf16 launches equal
                 those its schedule asks for);
     trace     — a profiler trace of one slice of that plan: device busy
                 share and the kernels that take the time;
  4. sampling  — sample_bitstrings with the last 4 qubits open, 1000
                 samples; the batch against the einsum oracle backend and
                 the statevector;
     engine    — the contraction server (EngineServer, max_batch=32) on
                 samp30 with the sampling phase's planner seed and
                 restarts: first obs.calibrate_plan on one slice of the
                 amp30 plan (measured/modeled per backend class), then,
                 with the plan cache emptied, two bursts of the same
                 family, cold then warm: 16 amplitudes (0…0 outside
                 qubits 26-29, each of their 16 patterns) and 2 sampling
                 tenants (qubits 26-29 open, 1000 samples, sampler seeds
                 0 and 1).  Every amplitude within 1e-3 of the
                 statevector; the tenants' batches and every amplitude
                 answered from a batch over qubits 26-29 bitwise the
                 sampling phase's batch (same network, same plan, one
                 fixed summation order); a coalesced group in each burst;
                 in the warm burst every batch contraction a plan-cache
                 hit planned in < 1% of the cold plan's time, and
                 hoist-cache hits; each contraction's own peak (over the
                 bytes resident when it starts, measured by the execution
                 gate) within its certified peak (as above); never two
                 executions at once.  Prints each burst's wall, server
                 counters, and queue and compute latency (p50, max);
     search    — amp30 planned by the anytime plan search
                 (optimize="anytime", 64 evaluations, 4 workers, seed 0)
                 and executed through simulate_amplitude: evaluations,
                 search wall, trace points, improvement, log2 objective of
                 the one-shot seed and of the searched plan, |S|, certified
                 peak against the search's budget, exec_s beside the
                 amplitude phase's one-shot exec_s.  Checks: feasible,
                 improvement >= 1, the search.evals counter equals the
                 evaluations, the amplitude within 1e-3 of the
                 statevector, the measured peak within the certified peak
                 (as above).  Also samp30 searched at planner seed 0 on
                 the host, beside the one-shot plans of seeds 0 and 2;
     resume    — amp30's one-shot plan through contract_resumable(chunk=16)
                 with a simulated failure at range 32 (raised on purpose:
                 catching it is the point), then a resume at chunk=8 from
                 the state it left: within 1e-6 of |amp| of the amplitude
                 phase's value, each of the 128 ids summed exactly once,
                 the peak within the certified peak;
     multihost — the same plan through contract_multihost at world size 1
                 with a claim store in a temporary directory and a
                 simulated host failure after 2 ranges, then an epoch-1
                 resume (merged value within 1e-6 of |amp|, ids covered
                 exactly once, schedule_imbalance / steal_count /
                 overlap_fraction printed); then samp30 through
                 contract_sharded([cuda:0]) and sample_bitstrings(devices=
                 [cuda:0]), bitwise the sampling phase's batch (the same
                 summation order), and contract_sharded([cuda:0, cuda:0],
                 slice_batch=4) within 1e-6 (another order); a list
                 naming cuda:1 is refused.  One process
                 drives the card: two processes would break the
                 per-process execution gate and the one-contraction
                 certified peak;
  5. share     — open_session on sycamore_like(6, 6, 14), 36 qubits (more
                 than any statevector on one card holds), run_slices on 2
                 slice ids against the einsum oracle on the same ids; its
                 measured peak against the certified peak (as above);
  6. serve     — for qwen3-4b and mamba2-130m: the full config (36 and
                 24 layers) through repro_torch.launch.decode_demo.serve,
                 batch 4, prompt 512, 32 tokens, finite logits; the
                 card's prefill logits against the port's own CPU run on
                 the same weights and tokens, at full width: in bf16 at 2
                 layers <= 3e-2 of max|logit| (the bf16 attention
                 tolerance of the JAX suite), in fp32 (qwen3-4b at 2
                 layers, mamba2-130m whole) <= 1e-3; profiler traces of
                 one prefill and one decode step at the serve shapes,
                 with each kernel's share of the device time; the
                 phase's flash_attention and ssd_chunk launches must be
                 > 0, and every ssd_chunk launch must take its wgmma
                 route;
  7. kernels   — one JSON line listing every kernel with its launches on
                 its path (phases 3-5, engine, search, resume and
                 multihost for the contraction kernels, the
                 serve phase for the LM kernels; each must be > 0) and
                 its design (wgmma-bf16, 3xtf32-wgmma, cluster-simt-fp32),
                 and the bf16 routes of tiled_gemm and fused_gemm
                 with their launches in the precision phase;
                 every fused_gemm launch of those phases must
                 have taken the wgmma kernel with the coalesced (uniform)
                 gather.

Each phase prints one JSON line; any failed check raises, so the exit code
is non-zero.  The last line is the device summary.  With no CUDA device,
or without the repository around it, the script fails before printing any
result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

FP32_PEAK = 67e12  # H100 SXM data sheet, FP32 on the CUDA cores
BF16_PEAK = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
TF32_PEAK = 495e12  # H100 SXM data sheet, dense TF32 tensor cores
HBM_BW = 3.35e12  # H100 SXM data sheet, HBM3
KERNEL_TOL = 1e-4
BF16_ROUTE_TOL = 1e-5  # bf16 products are exact in fp32: sum order only
# a chain of bf16 steps against the plain chain: a carry rounded to bf16
# from two fp32 sums of another order may land one bf16 ulp apart, which
# read 5.04e-5 on the H100.  The same chain with its carries left
# unrounded (bf16 externals, fp32 steps) must read above this limit: the
# smoke checks that too (readings in PERF.md §6).
BF16_CHAIN_TOL = 5e-4
PRECISION_TOL = 0.05  # the auto plan's XEB budget, against the statevector
# measured peak device memory <= planned x PEAK_MARGIN + PEAK_SLACK: the
# slack covers the allocator's rounding, the kernels' launch tables and
# the dot backend's blocks (lowering/gemm_form._dot, 64 MiB each)
PEAK_MARGIN = 1.10
PEAK_SLACK = 256 << 20
FLASH_TOL = 1e-2  # bf16 output: its rounding alone is 2^-8 = 3.9e-3
AMP_TOL = 1e-3
# card against CPU prefill logits, relative to max|logit|.  bf16: the JAX
# suite's bf16 attention tolerance.  Random weights amplify bf16 rounding
# with depth (bf16 against fp32 logits differ 0.5% at 2 layers of
# qwen3-4b, 14% at 24 of mamba2-130m, on the H100), so the bf16 check
# runs 2 layers.  fp32: other summation orders only; the readings were
# 1.9e-6 (qwen3-4b, 2 layers) and 3.1e-5 (mamba2-130m, 24 layers).
SERVE_TOL = 3e-2
SERVE_TOL_FP32 = 1e-3
BF16_LAYERS = 2
TPU_KERNELS = {
    "tiled_gemm": "src/repro/kernels/contract_gemm.py:45",
    "fused_gemm": "src/repro/kernels/contract_gemm.py:164",
    "chain_gemm": "src/repro/kernels/contract_gemm.py:421",
    "flash_attention": "src/repro/kernels/flash_attention.py:71",
    "ssd_chunk": "src/repro/kernels/mamba2_ssd.py:57",
}
# how each kernel computes (the route of every kernel is CUDA C++)
DESIGNS = {
    "tiled_gemm": "3xtf32-wgmma",
    "fused_gemm": "3xtf32-wgmma",
    "chain_gemm": "cluster-simt-fp32",
    "flash_attention": "wgmma-bf16",  # its fp32 inputs take simt-fp32
    "ssd_chunk": "3xtf32-wgmma",  # shapes outside its rule take simt-fp32
}
# how each bf16 route computes
BF16_DESIGNS = {"tiled_gemm": "bf16-wgmma", "fused_gemm": "bf16-wgmma"}
# the kernels that must run on the tensor cores: (library, CUDA kernel)
WGMMA_KERNELS = {
    "tiled_gemm": ("gemm", "tiled_gemm_kernel"),
    "fused_gemm": ("gemm", "fused_gemm_kernel"),
    "flash_attention": ("flash_attention", "flash_attention_wgmma_kernel"),
    "ssd_chunk": ("mamba2_ssd", "ssd_chunk_wgmma_kernel"),
}
# the kernels whose bf16 instantiations (the third template argument
# true) must hold HGMMA: 4 each (complex or real, 64- or 128-wide tile)
BF16_INSTANCES = ("tiled_gemm", "fused_gemm")
# kernels whose share of a trace's device time the traces report
TRACED_KERNELS = ("tiled_gemm", "fused_gemm", "chain_gemm",
                  "flash_attention", "ssd_chunk")
# the bf16 routes the precision phase launches: their records in the
# kernels line.  chain_gemm's bf16 route (per-step precisions) is held
# against its plain twin in the kernels phase, but no plan of this
# script's circuits puts a bf16 step in a chain: the steps demoted to
# bf16 run on tiled_gemm and fused_gemm, whose operands exceed a chain's
# workspace budget.
BF16_ROUTES = ("tiled_gemm", "fused_gemm")
SOURCES = {
    "tiled_gemm": "src/repro_torch/kernels/csrc/gemm.cu",
    "fused_gemm": "src/repro_torch/kernels/csrc/gemm.cu",
    "chain_gemm": "src/repro_torch/kernels/csrc/gemm.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "ssd_chunk": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
}
CHAIN_CLUSTERS = (1, 2, 4, 8, 16)  # K3's cluster sizes timed
SERVE = dict(batch=4, prompt_len=512, gen_tokens=32, seed=0)
AGREE = dict(batch=1, prompt_len=256)  # the CPU half of the agreement


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


def device_ms(torch, fn, name: str, n: int = 20) -> float:
    """Mean milliseconds on the card's own clock of the kernels whose name
    holds ``name``, over ``n`` calls of ``fn`` under the profiler (a
    launch shorter than the host's issue time is not measured by events
    around back-to-back calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    fn()
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name in e.key)
    check(us > 0, f"no device time for {name}")
    return us / 1e3 / n


def bound(flops: float, nbytes: float, peak: float = FP32_PEAK):
    """(least ms for the work, what bounds it) on the data-sheet peaks."""
    t_ops, t_mem = flops / peak, nbytes / HBM_BW
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


def phase_kernels(torch, plan, cg, ops, hw) -> dict:
    """Each kernel at the main path's own shapes against its plain
    version; returns per-kernel timing records."""
    from repro_torch.kernels.ref import round16

    gen = torch.Generator(device="cpu").manual_seed(0)
    dev = torch.device("cuda")

    def rnd(shape, scale=1.0):
        return (scale * torch.randn(tuple(shape), generator=gen)).to(dev)

    specs = plan.schedule.specs
    out = {}

    # K1: the largest tiled step, complex64 read in place, in GEMM order
    # and (the path's call) in the step's native layouts
    tiled = [s for s in specs if s.backend == "tiled"]
    check(bool(tiled), "the plan has no tiled step")
    f = max(tiled, key=lambda s: s.form.flops).form
    B, M, N, K = f.B, f.M, f.N, f.K
    a, b = rnd((B, M, K)), rnd((B, K, N))
    ac = torch.complex(a, rnd((B, M, K)))
    bc = torch.complex(b, rnd((B, K, N)))
    before = cg.LAUNCHES["tiled_gemm"]
    got = cg.tiled_gemm(ac, bc)
    check(cg.LAUNCHES["tiled_gemm"] == before + 1, "tiled_gemm: not one launch")
    want = cg.tiled_gemm_plain(ac, bc)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got], [want])
    check(rel <= KERNEL_TOL, f"tiled_gemm disagrees: {rel}")
    nbytes = 8.0 * B * (M * K + K * N + M * N)
    # 3xTF32 on Karatsuba's three real products (3 x 6MNK) at the TF32
    # rate; the kernel's direct form issues 4/3 of that
    b_ms, b_by = bound(3.0 * 6.0 * B * M * N * K, nbytes, TF32_PEAK)
    # the path's call: the step's operands in their native layouts
    an = torch.complex(rnd(f.a_shape), rnd(f.a_shape))
    bn = torch.complex(rnd(f.b_shape), rnd(f.b_shape))
    out["tiled_gemm"] = dict(
        shape=[B, M, N, K], dtype="complex64", max_abs_err=err, rel_err=rel,
        ms=cuda_ms(torch, lambda: cg.tiled_gemm(ac, bc)),
        path_ms=cuda_ms(torch, lambda: ops.tiled_step(an, bn, f)),
        plain_ms=cuda_ms(torch, lambda: cg.tiled_gemm_plain(ac, bc)),
        library_ms=cuda_ms(torch, lambda: torch.matmul(ac, bc)),
        bound_ms=b_ms, bound_by=b_by,
    )
    # its bf16 route: Karatsuba's three real products (6MNK), as the fp32
    # bound counts them, at the bf16 rate
    got = cg.tiled_gemm(ac, bc, precision="bf16")
    want = cg.tiled_gemm_plain(ac, bc, "bf16")
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got], [want])
    check(rel <= BF16_ROUTE_TOL, f"tiled_gemm bf16 route disagrees: {rel}")
    flops16 = 6.0 * B * M * N * K
    b_ms, b_by = bound(flops16, nbytes, BF16_PEAK)
    out["tiled_gemm:bf16"] = dict(
        shape=[B, M, N, K], dtype="complex64", max_abs_err=err, rel_err=rel,
        ms=cuda_ms(torch, lambda: cg.tiled_gemm(ac, bc, precision="bf16")),
        plain_ms=cuda_ms(torch, lambda: cg.tiled_gemm_plain(ac, bc, "bf16")),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        path_ms=cuda_ms(torch, lambda: ops.tiled_step(an, bn, f, precision="bf16")),
        # hw.bf16_peak_flops was measured counting four real products
        measured_rate_bound_ms=bound(
            8.0 * B * M * N * K, nbytes, hw.bf16_peak_flops)[0],
    )
    del a, b, ac, bc, an, bn, got, want

    # K2: the largest fused step, complex64 read and written in place
    fused = [s for s in specs if s.backend == "fused"]
    check(bool(fused), "the plan has no fused step")
    f = max(fused, key=lambda s: s.form.flops).form
    pa = (rnd(f.a_shape), rnd(f.a_shape))
    pb = (rnd(f.b_shape), rnd(f.b_shape))
    ac, bc = torch.complex(*pa), torch.complex(*pb)
    before = cg.LAUNCHES["fused_gemm"]
    got = cg.fused_gemm_c64(ac, bc, f)
    check(cg.LAUNCHES["fused_gemm"] == before + 1, "fused_gemm: not one launch")
    want = cg.fused_gemm_plain(pa, pb, f)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got.real, got.imag], want)
    check(rel <= KERNEL_TOL, f"fused_gemm disagrees: {rel}")
    B, M, N, K = f.B, f.M, f.N, f.K
    nbytes = 8.0 * B * (M * K + K * N + M * N)
    # 3xTF32 on Karatsuba's three real products (3 x 6MNK) at the TF32
    # rate; the kernel's direct form issues 4/3 of that
    b_ms, b_by = bound(3.0 * 6.0 * B * M * N * K, nbytes, TF32_PEAK)
    ffma = 6.0 * B * M * N * K + 2.0 * B * (M * K + K * N) + 3.0 * B * M * N
    ffma_ms, _ = bound(ffma, nbytes)  # the FFMA kernel's bound (PR 11-13)
    out["fused_gemm"] = dict(
        shape=[B, M, N, K], max_abs_err=err, rel_err=rel,
        uniform=cg.fused_plan(f).uniform,
        ms=cuda_ms(torch, lambda: cg.fused_gemm_c64(ac, bc, f)),
        path_ms=cuda_ms(torch, lambda: ops.fused_matmul(ac, bc, f)),
        plain_ms=cuda_ms(torch, lambda: cg.fused_gemm_plain(pa, pb, f)),
        library_ms=cuda_ms(torch, lambda: torch.einsum(f.expr, ac, bc)),
        bound_ms=b_ms, bound_by=b_by, ffma_bound_ms=ffma_ms,
    )
    # its bf16 route on the same operands
    got = cg.fused_gemm_c64(ac, bc, f, precision="bf16")
    want = cg.fused_gemm_plain(pa, pb, f, "bf16")
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got.real, got.imag], want)
    check(rel <= BF16_ROUTE_TOL, f"fused_gemm bf16 route disagrees: {rel}")
    flops16 = 6.0 * B * M * N * K
    b_ms, b_by = bound(flops16, nbytes, BF16_PEAK)
    out["fused_gemm:bf16"] = dict(
        shape=[B, M, N, K], dtype="complex64", max_abs_err=err, rel_err=rel,
        ms=cuda_ms(torch, lambda: cg.fused_gemm_c64(ac, bc, f, precision="bf16")),
        plain_ms=cuda_ms(torch, lambda: cg.fused_gemm_plain(pa, pb, f, "bf16")),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        # hw.bf16_peak_flops was measured counting four real products
        measured_rate_bound_ms=bound(
            8.0 * B * M * N * K, nbytes, hw.bf16_peak_flops)[0],
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
    ext = [torch.complex(comps[2 * i], comps[2 * i + 1]) for i in range(len(shapes))]
    chain = dict(forms=forms, carry_side=ch.carry_side, slot_ids=ch.slot_ids,
                 slot_elems=ch.slot_elems)
    before = cg.LAUNCHES["chain_gemm"]
    got = ops.fused_chain(ext, **chain)
    check(cg.LAUNCHES["chain_gemm"] == before + 1, "fused_chain: not one launch")
    want = cg.chain_gemm_plain(comps, forms, ch.carry_side, True)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got.real, got.imag], want)
    check(rel <= KERNEL_TOL, f"chain_gemm disagrees: {rel}")
    flops = sum(
        6.0 * fm.B * fm.M * fm.N * fm.K + 2.0 * fm.B * (fm.M * fm.K + fm.K * fm.N)
        + 3.0 * fm.B * fm.M * fm.N for fm in forms
    )
    nbytes = 8.0 * (sum(e.numel() for e in ext) + got.numel())
    b_ms, b_by = bound(flops, nbytes)
    args = (comps, forms, ch.carry_side, ch.slot_ids, ch.slot_elems)
    # the kernel alone, on the card's clock: relaunches of the cached
    # launch state, at each cluster size; the default size's outputs are
    # then the wrapper's result
    by_cluster, rel_relaunch = {}, 0.0
    for size in CHAIN_CLUSTERS:
        launch, outs = cg.chain_gemm_launcher(*args, complex_mode=True,
                                              cluster=size)
        by_cluster[size] = device_ms(torch, launch, "chain_gemm")
        torch.cuda.synchronize()
        _, r = rel_err(torch, outs, want)
        rel_relaunch = max(rel_relaunch, r)
    check(rel_relaunch <= KERNEL_TOL,
          f"chain_gemm relaunches disagree: {rel_relaunch}")
    one, _ = cg.chain_gemm_launcher(comps[:4], forms[:1], ch.carry_side[:1],
                                    (), (), complex_mode=True)
    default = cg.chain_state(forms, ch.carry_side, ch.slot_ids, ch.slot_elems,
                             True, ext[0].device).segments[0][3]
    out["chain_gemm"] = dict(
        steps=ch.n_steps, shapes=[[fm.B, fm.M, fm.N, fm.K] for fm in forms],
        max_abs_err=err, rel_err=rel, relaunch_rel_err=rel_relaunch,
        cluster=default, ms=by_cluster[default],
        ms_by_cluster=by_cluster,
        one_step_ms=device_ms(torch, one, "chain_gemm"),
        empty_launch_ms=device_ms(
            torch, lambda: cg.empty_cluster_launch(default, dev), "empty_cluster"),
        empty_launch_wall_ms=cuda_ms(
            torch, lambda: cg.empty_cluster_launch(default, dev)),
        # an empty launch that meets at the chain's barriers between steps
        barriers_launch_ms=device_ms(
            torch, lambda: cg.empty_cluster_launch(default, dev, ch.n_steps - 1),
            "empty_cluster"),
        path_ms=cuda_ms(torch, lambda: ops.fused_chain(ext, **chain)),
        plain_ms=cuda_ms(
            torch, lambda: cg.chain_gemm_plain(comps, forms, ch.carry_side, True)
        ),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )
    # its bf16 route: every step bf16, every slot held as bf16.  Step by
    # step against the plain step on the kernel's own carry (the chain's
    # first t steps, one launch): bf16 products are exact, so only the
    # order of the sum differs.  The whole chain against the plain chain
    # differs by more: a carry rounded to bf16 from two fp32 sums of
    # another order can land one bf16 ulp apart, so that is held at
    # BF16_CHAIN_TOL, which the same chain with unrounded carries must
    # exceed.
    prec = ("bf16",) * len(forms)
    sp = ("bf16",) * len(ch.slot_elems)
    err = rel = 0.0
    carry = None
    for t, fm in enumerate(forms):
        got = cg.chain_gemm_c64(ext[:t + 2], forms[:t + 1], ch.carry_side[:t + 1],
                                ch.slot_ids[:t], ch.slot_elems,
                                precisions=prec[:t + 1], slot_prec=sp)
        if t == 0:
            a_, b_ = ext[0], ext[1]
        else:
            a_, b_ = ((carry, ext[t + 1]) if ch.carry_side[t] == "l"
                      else (ext[t + 1], carry))
        want = cg.fused_gemm_plain((a_.real, a_.imag), (b_.real, b_.imag), fm, "bf16")
        torch.cuda.synchronize()
        e, r = rel_err(torch, [got.real, got.imag], want)
        err, rel, carry = max(err, e), max(rel, r), got
    check(rel <= BF16_ROUTE_TOL, f"chain_gemm bf16 route disagrees: {rel}")
    got = ops.fused_chain(ext, **chain, precisions=prec, slot_prec=sp)
    want = cg.chain_gemm_plain(comps, forms, ch.carry_side, True, prec)
    torch.cuda.synchronize()
    _, chain_rel = rel_err(torch, [got.real, got.imag], want)
    check(chain_rel <= BF16_CHAIN_TOL, f"chain_gemm bf16 chain disagrees: {chain_rel}")
    # the control: bf16 externals through the fp32 route (a product of
    # bf16 values is exact in fp32), so only the carries go unrounded
    ext16 = [round16(e) for e in ext]
    ctrl = ops.fused_chain(ext16, **chain)
    torch.cuda.synchronize()
    _, unrounded_rel = rel_err(torch, [ctrl.real, ctrl.imag], want)
    check(unrounded_rel > BF16_CHAIN_TOL,
          f"chain_gemm: unrounded carries pass the bf16 chain limit: {unrounded_rel}")
    del ext16, ctrl
    launch, outs = cg.chain_gemm_launcher(*args, complex_mode=True,
                                          precisions=prec, slot_prec=sp)
    ms16 = device_ms(torch, launch, "chain_gemm")
    torch.cuda.synchronize()
    _, r = rel_err(torch, outs, [got.real, got.imag])
    check(r == 0.0, f"chain_gemm bf16 relaunch disagrees: {r}")
    out["chain_gemm:bf16"] = dict(
        steps=ch.n_steps, max_abs_err=err, rel_err=rel, chain_rel_err=chain_rel,
        unrounded_chain_rel_err=unrounded_rel,
        ms=ms16,
        path_ms=cuda_ms(torch, lambda: ops.fused_chain(
            ext, **chain, precisions=prec, slot_prec=sp)),
        plain_ms=cuda_ms(torch, lambda: cg.chain_gemm_plain(
            comps, forms, ch.carry_side, True, prec)),
        # FFMA on bf16-rounded values: the fp32 rate, as the fp32 route
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )
    return out


def phase_lm_kernels(torch, fa, ssd) -> dict:
    """flash_attention and ssd_chunk at the serve path's own shapes
    (batch 4, prompt 512) against their plain versions."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    out = {}

    # K4: qwen3-4b prefill, 32 query heads on 8 kv heads of 128, causal
    B, H, KV, S, d = 4, 32, 8, 512, 128
    q = torch.randn(B * H, S, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(B * KV, S, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(B * KV, S, d, generator=gen, device=dev).bfloat16()
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got.float()], [want.float()])
    check(bool(torch.isfinite(got).all()), "flash_attention: non-finite")
    check(rel <= FLASH_TOL, f"flash_attention disagrees: {rel}")
    pairs = S * (S + 1) // 2  # causal (q, k) pairs this input needs
    flops = 4.0 * B * H * pairs * d  # q.k and p.v
    nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + got.numel())
    b_ms, b_by = bound(flops, nbytes, BF16_PEAK)
    q4, k4, v4 = (t.view(B, -1, S, d) for t in (q, k, v))
    out["flash_attention"] = dict(
        shape=dict(bh=B * H, bh_kv=B * KV, sq=S, sk=S, d=d, dtype="bf16",
                   causal=True),
        max_abs_err=err, rel_err=rel,
        ms=cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True)),
        plain_ms=cuda_ms(
            torch, lambda: fa.flash_attention_plain(q, k, v, causal=True)),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
    )
    del q, k, v, got, want, q4, k4, v4

    # K5: mamba2-130m prefill, 24 heads of 64, state 128, chunks of 64,
    # head-free B/C (one group per batch row)
    B, H, C, L, D, N = 4, 24, 8, 64, 64, 128
    x = torch.randn(B * H, C, L, D, generator=gen, device=dev)
    dt = 0.1 + 0.9 * torch.rand(B * H, C, L, generator=gen, device=dev)
    a = -(0.01 + 0.49 * torch.rand(B * H, C, L, generator=gen, device=dev))
    b = torch.randn(B, C, L, N, generator=gen, device=dev)
    c = torch.randn(B, C, L, N, generator=gen, device=dev)
    check(ssd.ssd_route(L, D, N) == "wgmma", "ssd_chunk: serve shape not wgmma")
    before = dict(ssd.SSD_ROUTES)
    got = ssd.ssd_intra_chunk(x, dt, a, b, c)
    check(ssd.SSD_ROUTES["wgmma"] == before["wgmma"] + 1,
          "ssd_chunk: the serve shape did not take the wgmma route")
    want = ssd.ssd_intra_chunk_plain(x, dt, a, b, c)
    simt = ssd.ssd_intra_chunk(x, dt, a, b, c, route="simt")
    torch.cuda.synchronize()
    err, rel = rel_err(torch, got, want)
    simt_err, simt_rel = rel_err(torch, simt, want)
    check(all(bool(torch.isfinite(g).all()) for g in got), "ssd_chunk: non-finite")
    check(rel <= KERNEL_TOL, f"ssd_chunk disagrees: {rel}")
    check(simt_rel <= KERNEL_TOL, f"ssd_chunk (simt) disagrees: {simt_rel}")
    # decays of -5..-10 a step: exp(cum_i - cum_j) overflows above the
    # diagonal, where the kernel must select 0 before the TF32 split
    a_big = -(5.0 + 5.0 * torch.rand(B * H, C, L, generator=gen, device=dev))
    big = ssd.ssd_intra_chunk(x, dt, a_big, b, c)
    big_want = ssd.ssd_intra_chunk_plain(x, dt, a_big, b, c)
    torch.cuda.synchronize()
    _, big_rel = rel_err(torch, big, big_want)
    check(all(bool(torch.isfinite(g).all()) for g in big),
          "ssd_chunk: non-finite with overflowing decays")
    check(big_rel <= KERNEL_TOL, f"ssd_chunk disagrees on overflow: {big_rel}")
    cells = B * H * C
    tri = L * (L + 1) // 2  # the lower triangle the decay mask keeps
    nbytes = 4.0 * (x.numel() + dt.numel() + a.numel() + b.numel() + c.numel()
                    + got[0].numel() + got[1].numel())
    # the least arithmetic: C B^T once per (group, chunk), the masked y
    # product and the state product per cell, each as three TF32 products
    # (3xTF32) at the TF32 rate, against the bytes
    flops = B * C * 2.0 * tri * N + cells * (2.0 * tri * D + 2.0 * N * D * L)
    b_ms, b_by = bound(3.0 * flops, nbytes, TF32_PEAK)
    # the simt kernel's bound: C B^T for every cell, fp32 on the CUDA cores
    ffma = cells * (2.0 * tri * (N + D) + 2.0 * N * D * L + N * L + L * D)
    ffma_ms, _ = bound(ffma, nbytes)
    out["ssd_chunk"] = dict(
        shape=dict(BH=B * H, C=C, L=L, D=D, S=N, groups=B,
                   heads_per_block=ssd.heads_per_block(
                       H, B * C, torch.cuda.get_device_properties(
                           dev).multi_processor_count)),
        max_abs_err=err, rel_err=rel, simt_rel_err=simt_rel,
        overflow_rel_err=big_rel,
        # the kernels alone on the device clock; wrapper_ms: the call
        ms=device_ms(torch, lambda: ssd.ssd_intra_chunk(x, dt, a, b, c),
                     "ssd_chunk_wgmma"),
        simt_ms=device_ms(
            torch, lambda: ssd.ssd_intra_chunk(x, dt, a, b, c, route="simt"),
            "ssd_chunk_kernel"),
        wrapper_ms=cuda_ms(torch, lambda: ssd.ssd_intra_chunk(x, dt, a, b, c)),
        plain_ms=cuda_ms(torch, lambda: ssd.ssd_intra_chunk_plain(x, dt, a, b, c)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, ffma_bound_ms=ffma_ms,
    )
    return out


def _cpu_params(model) -> dict:
    params = {k: t.detach().cpu() for k, t in model.top.tensors().items()}
    params["layers"] = [
        {k: t.detach().cpu() for k, t in lp.tensors().items()}
        for lp in model.layers
    ]
    return params


def _cast(params: dict, dtype, layers: int) -> dict:
    """The first ``layers`` layers of ``params``, in ``dtype``."""
    out = {k: v.to(dtype) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: v.to(dtype) for k, v in lp.items()}
                     for lp in params["layers"][:layers]]
    return out


def phase_serve(torch, arch, serve, build_model, get_config, counts, reset):
    """One served model: the full config through ``serve``, then the
    card's prefill against the port's CPU run on the same weights."""
    import dataclasses

    reset()
    torch.cuda.reset_peak_memory_stats()
    r = serve(arch, smoke=False, device="cuda", **SERVE)
    torch.cuda.synchronize()
    launched = counts()
    logits = r["prefill_logits"]
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    check(tuple(r["generated"].shape) == (SERVE["batch"], SERVE["gen_tokens"]),
          f"{arch}: generated {r['generated'].shape}")
    peak = torch.cuda.max_memory_allocated()
    del r["prefill_logits"]
    torch.cuda.empty_cache()

    full = get_config(arch)
    # the fp32 agreement and the traces: qwen3-4b at full width and 2
    # layers (the CPU half holds its weights in fp32), mamba2-130m whole
    deep = dataclasses.replace(full, num_layers=2) if full.family == "dense" else full
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, full.vocab_size,
                           (AGREE["batch"], AGREE["prompt_len"]), generator=gen)
    big = torch.randint(0, full.vocab_size, (SERVE["batch"], SERVE["prompt_len"]),
                        generator=gen).cuda()
    params = _cpu_params(build_model(deep, seed=1, device="cuda"))
    runs = {}
    for name, dtype, layers in (("bf16", torch.bfloat16, BF16_LAYERS),
                                ("fp32", torch.float32, deep.num_layers)):
        cfg = dataclasses.replace(full, num_layers=layers)
        cast = _cast(params, dtype, layers)
        model = build_model(cfg, cast, device="cuda")
        _, card = model.prefill(tokens.cuda())
        del model
        torch.cuda.empty_cache()
        cpu_model = build_model(cfg, cast, device="cpu")
        t0 = time.perf_counter()
        _, host = cpu_model.prefill(tokens)
        runs[name] = dict(card=card.cpu(), host=host, layers=layers,
                          cpu_s=time.perf_counter() - t0)
        del cpu_model, cast

    # where the time goes at the serve shapes (per layer the same as at
    # full depth): one prefill, then one decode step, in bf16
    model = build_model(deep, _cast(params, torch.bfloat16, deep.num_layers),
                        device="cuda")
    del params
    model.prefill(big)
    prefill_trace = profile(torch, lambda: model.prefill(big))
    cache, logits = model.prefill(big, max_len=SERVE["prompt_len"] + 2)
    nxt = logits.argmax(-1)[:, None]
    model.decode_step(cache, nxt, SERVE["prompt_len"])
    decode_trace = profile(
        torch, lambda: model.decode_step(cache, nxt, SERVE["prompt_len"] + 1))
    del cache, model, big
    torch.cuda.empty_cache()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for name, run in runs.items():
        check(bool(torch.isfinite(run["card"]).all()),
              f"{arch}: non-finite {name} card logits")
    err32 = rel(runs["fp32"]["card"], runs["fp32"]["host"])
    err16 = rel(runs["bf16"]["card"], runs["bf16"]["host"])
    check(err32 <= SERVE_TOL_FP32, f"{arch}: fp32 card vs CPU prefill {err32}")
    check(err16 <= SERVE_TOL, f"{arch}: bf16 card vs CPU prefill {err16}")
    return dict(
        arch=arch, layers=full.num_layers, **SERVE,
        prefill_s=r["prefill_s"], decode_s=r["decode_s"],
        decode_tok_per_s=r["decode_tok_per_s"],
        first_tokens=r["generated"][0][:8].tolist(), peak_bytes=peak,
        agreement=dict(**AGREE, layers_bf16=runs["bf16"]["layers"],
                       layers_fp32=runs["fp32"]["layers"], rel_err_bf16=err16,
                       rel_err_fp32=err32,
                       cpu_prefill_s={k: v["cpu_s"] for k, v in runs.items()}),
        prefill_trace=dict(layers=deep.num_layers, batch=SERVE["batch"],
                           prompt_len=SERVE["prompt_len"], **prefill_trace),
        decode_trace=dict(layers=deep.num_layers, batch=SERVE["batch"],
                          **decode_trace),
        launches=launched,
    )


def profile(torch, fn) -> dict:
    """One warm call of ``fn`` under the profiler: wall time, summed
    device time, busy share and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    kernels = {}
    for name in TRACED_KERNELS:
        ms = sum(us for us, k, _ in rows if name in k) / 1e3
        if ms > 0:
            kernels[name] = dict(ms=ms, share=ms / max(device_ms, 1e-9))
    return dict(
        wall_ms=1e3 * wall, device_ms=device_ms,
        device_busy_share=device_ms / (1e3 * wall),
        top=[dict(name=k[:80], ms=us / 1e3, calls=c) for us, k, c in rows[:8]],
        kernels=kernels,
    )


def check_peak(phase: str, measured: int, planned: int) -> None:
    """The certified peak holds on the card: the bytes allocated over
    the phase at most ``planned * PEAK_MARGIN + PEAK_SLACK``."""
    limit = planned * PEAK_MARGIN + PEAK_SLACK
    check(measured <= limit,
          f"{phase}: peak {measured} B over the certified {planned} B "
          f"(limit {limit:.0f} B)")


def expected_bf16_launches(plan, cg) -> dict:
    """The bf16-route launches one hoisted run of ``plan`` asks for: its
    bf16 tiled and fused steps outside chains, and its chain launches
    that hold a bf16 step, the prologue's once and the epilogue's once
    per slice."""
    specs = plan.schedule.specs
    want = {"tiled_gemm": 0, "fused_gemm": 0, "chain_gemm": 0}
    segments = (("prologue", plan.prologue_idx, 1),
                ("epilogue", plan.epilogue_idx, 1 << plan.num_sliced))
    for seg, ids, times in segments:
        chains = plan.chain_plan.by_segment(seg)
        i, ids = 0, list(ids)
        while i < len(ids):
            ch = chains.get(ids[i])
            if ch is not None:
                forms = [specs[p].form for p in ch.positions]
                for launch in cg.chain_segments(forms):
                    if any(specs[ch.positions[t]].precision == "bf16"
                           for t in launch):
                        want["chain_gemm"] += times
                i += ch.n_steps
                continue
            spec = specs[ids[i]]
            if spec.precision == "bf16":
                want[{"tiled": "tiled_gemm", "fused": "fused_gemm"}[spec.backend]] += times
            i += 1
    return want


def phase_precision(torch, simulate_amplitude, cg, circ, n, target, sv_amp) -> dict:
    """The amplitude at precision="fp32" and at "auto" (tol 0.05), both in
    peak-mode slicing: bf16 steps, |S|, error against the statevector,
    measured against certified peak, and the bf16-route launches."""
    runs = {}
    for mode, tol in (("fp32", None), ("auto", PRECISION_TOL)):
        cg.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = simulate_amplitude(circ, "0" * n, target_dim=target,
                                 slicing_mode="peak", precision=mode,
                                 fidelity_tol=tol)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0 - res.report.plan_wall_s
        peak = torch.cuda.max_memory_allocated() - base
        amp = complex(res.value)
        rep = res.report
        runs[mode] = dict(
            precision_counts=rep.precision_counts, num_sliced=rep.num_sliced,
            predicted_amp_error=rep.predicted_amp_error, exec_s=exec_s,
            rel_err=abs(amp - sv_amp) / abs(sv_amp), peak_bytes=peak,
            peak_bytes_planned=rep.peak_bytes_hoisted,
            stored_bf16_nodes=len(res.plan.store16),
            backends=rep.lowered_backends, launches=dict(cg.LAUNCHES),
            bf16_launches=dict(cg.BF16_LAUNCHES),
            bf16_launches_planned=expected_bf16_launches(res.plan, cg),
        )
        check_peak(f"precision {mode}", peak, rep.peak_bytes_hoisted)
        del res
        torch.cuda.empty_cache()
    fp32, auto = runs["fp32"], runs["auto"]
    check(fp32["rel_err"] <= AMP_TOL, f"fp32 peak-mode amplitude: {fp32['rel_err']}")
    check(not fp32["precision_counts"].get("bf16"), "the fp32 plan has bf16 steps")
    check(auto["precision_counts"].get("bf16", 0) > 0, "the auto plan demoted nothing")
    check(auto["num_sliced"] <= fp32["num_sliced"],
          f"|S| grew under auto: {auto['num_sliced']} > {fp32['num_sliced']}")
    check(auto["rel_err"] <= PRECISION_TOL, f"auto amplitude: {auto['rel_err']}")
    check(auto["bf16_launches"] == auto["bf16_launches_planned"],
          f"bf16 steps vs bf16-route launches: {auto['bf16_launches']} vs "
          f"{auto['bf16_launches_planned']}")
    return dict(qubits=n, target_dim=target, slicing_mode="peak",
                fidelity_tol=PRECISION_TOL, fp32=fp32, auto=auto,
                bf16_launches=auto["bf16_launches"])


def trace_slice(torch, open_session, circ, n: int, target: int) -> dict:
    """Profile one epilogue slice."""
    sess, _ = open_session(circ, "0" * n, target_dim=target, backend="gemm")
    sess.run_slice(0)
    return profile(torch, lambda: sess.run_slice(1))


def percentiles(xs) -> dict:
    xs = sorted(xs)
    return dict(p50=xs[len(xs) // 2], max=xs[-1])


def phase_engine(torch, cg, circ, n: int, target: int, planner_seed: int,
                 samp_flat, sv_batch, amp_plan, amp_arrays) -> dict:
    """The contraction server on samp30: calibrate_plan on one slice of
    the amp30 plan, then two bursts of one family (16 amplitudes over the
    last 4 qubits, 2 sampling tenants), cold then warm, through
    EngineServer(max_batch=32) on the card.  Checks: amplitudes against
    the statevector; batch-served values bitwise the sampling phase's; a
    coalesced group per burst; warm batch contractions all plan-cache
    hits at < 1% of the cold plan's time, with hoist-cache hits; each
    contraction within its certified peak; one execution at a time."""
    from repro_torch import obs
    from repro_torch.core.executor import running
    from repro_torch.engine import (AmplitudeRequest, EngineServer,
                                    SampleRequest, execution_gate)
    from repro_torch.lowering.cache import PLAN_CACHE

    cal = obs.calibrate_plan(amp_plan, amp_arrays, slice_id=0, repeat=3)
    calibration = dict(device=cal.device, hardware=cal.hardware,
                       by_class=cal.ratio_by_class())
    del amp_plan, amp_arrays, cal
    PLAN_CACHE.clear()  # the first burst plans cold
    torch.cuda.empty_cache()

    open_q = tuple(range(n - 4, n))
    pk = dict(seed=planner_seed, repeats=32)  # the sampling phase's planner

    def requests():
        reqs = []
        for p in range(16):
            bits = ["0"] * n
            for j, q in enumerate(open_q):
                bits[q] = str((p >> (len(open_q) - 1 - j)) & 1)
            reqs.append(AmplitudeRequest(circ, "".join(bits), target_dim=target,
                                         plan_kwargs=pk))
        for seed in (0, 1):
            reqs.append(SampleRequest(circ, num_samples=1000, open_qubits=open_q,
                                      seed=seed, target_dim=target, plan_kwargs=pk))
        return reqs

    def resident() -> int:
        return sum(e.plan._hoist_cache.total_bytes for e in PLAN_CACHE.values())

    gate, counter = execution_gate("cuda"), running("cuda")
    counter.reset()
    gate.probe = []
    cg.reset_launches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    bursts = []
    try:
        with EngineServer(max_batch=32) as srv:
            for b in range(2):
                before = srv.stats()
                t0 = time.perf_counter()
                tickets = [srv.submit(r) for r in requests()]
                for t in tickets:
                    t.result(timeout=900)
                wall = time.perf_counter() - t0
                after = srv.stats()
                bursts.append(dict(
                    tickets=tickets, wall_s=wall, resident_bytes=resident(),
                    stats={k: after[k] - before[k] for k in (
                        "groups", "coalesced", "cold_groups", "warm_groups",
                        "rejected", "completed", "failed")},
                ))
        probe = gate.probe
    finally:
        gate.probe = None
    launches = dict(cg.LAUNCHES)
    routes = dict(cg.FUSED_ROUTES)
    hoist = [e.plan._hoist_cache.stats() for e in PLAN_CACHE.values()]

    scale = float(abs(sv_batch).max())
    records = []
    cold_plan_s = None
    for b, burst in enumerate(bursts):
        amps, batch_reports = [], []
        for t in burst["tickets"]:
            r = t.request
            if isinstance(r, AmplitudeRequest):
                idx = int("".join(r.bitstring[q] for q in open_q), 2)
                err = abs(t.value - complex(sv_batch[idx])) / scale
                check(err <= AMP_TOL, f"engine burst {b}: amplitude {idx} off "
                      f"the statevector by {err}")
                amps.append(err)
                if t.open_qubits == open_q:
                    check(t.value == complex(samp_flat[idx]),
                          f"engine burst {b}: amplitude {idx} from the batch is not "
                          f"bitwise the sampling phase's")
            else:
                got = t.value.batch.flat()
                check(got.tobytes() == samp_flat.tobytes(),
                      f"engine burst {b}: tenant {r.seed}'s batch is not bitwise "
                      f"the sampling phase's")
                check(t.value.num_samples == 1000, "wrong sample count")
            if t.open_qubits:
                batch_reports.append(t.report)
        check(burst["stats"]["coalesced"] > 0, f"engine burst {b}: nothing coalesced")
        check(burst["stats"]["failed"] == 0, f"engine burst {b}: failed tickets")
        reports = {id(rep): rep for rep in batch_reports}.values()
        if b == 0:
            cold = [rep.plan_wall_s for rep in reports if not rep.cache_hit]
            check(bool(cold), "engine burst 0: no batch contraction planned cold")
            cold_plan_s = cold[0]
        else:
            check(all(rep.cache_hit for rep in reports),
                  "engine burst 1: a batch contraction missed the plan cache")
            check(all(rep.plan_wall_s < 0.01 * cold_plan_s for rep in reports),
                  f"engine burst 1: warm plan_wall_s "
                  f"{[rep.plan_wall_s for rep in reports]} vs cold {cold_plan_s}")
        tix = burst["tickets"]
        records.append(dict(
            wall_s=burst["wall_s"], stats=burst["stats"],
            batch_contractions=len(reports),
            batch_served=sum(1 for t in tix if t.open_qubits == open_q),
            plan_wall_s=[rep.plan_wall_s for rep in reports],
            cache_hit=[rep.cache_hit for rep in reports],
            queue_s=percentiles([t.queue_s for t in tix]),
            compute_s=percentiles([t.compute_s for t in tix]),
            max_amp_err=max(amps), hoist_resident_bytes=burst["resident_bytes"],
        ))
    check(sum(h["hits"] for h in hoist) > 0, f"no hoist-cache hit: {hoist}")
    contractions = [r for r in probe if r["planned_bytes"] is not None]
    check(bool(contractions), "the gate measured no contraction")
    for r in contractions:
        check_peak(f"engine contraction {r['label']}", r["peak_bytes"],
                   r["planned_bytes"])
    check(counter.peak == 1, f"{counter.peak} executions ran at once")
    phase_peak = max(r["resident_bytes"] + r["peak_bytes"] for r in probe) - base
    return dict(
        qubits=n, target_dim=target, open_qubits=list(open_q), plan_kwargs=pk,
        calibration=calibration, bursts=records, cold_plan_s=cold_plan_s,
        contractions=[{k: r[k] for k in ("label", "peak_bytes", "planned_bytes",
                                         "resident_bytes")} for r in contractions],
        max_concurrent_executions=counter.peak, phase_peak_bytes=phase_peak,
        hoist_cache=hoist, launches=launches, fused_routes=routes,
    )


SEARCH = dict(optimize="anytime", search_evals=64, search_workers=4, seed=0)
RESUME_TOL = 1e-6  # resumed / merged sums against run_all, of max|amp|


def phase_search(torch, obs, cg, circ, tn, tn4, target: int, sv_amp: complex,
                 amp_plan, amp_exec_s: float, samp_costs: dict) -> dict:
    """amp30 planned by the anytime search (64 evaluations, 4 workers,
    seed 0) through plan_compiled with telemetry on, then executed through
    simulate_amplitude (a plan-cache hit).  Checks: the searched plan is
    feasible (certified peak within the search's budget, which the
    one-shot seed fixes), improvement >= 1, the search.evals counter
    equals the report's evaluations, the amplitude within 1e-3 of the
    statevector, the measured peak within the certified peak.  Then samp30
    at planner seed 0 searched on the host with the same budget, beside
    the one-shot plans of seeds 0 and 2."""
    from repro_torch.core import plan_compiled, plan_contraction, simulate_amplitude
    from repro_torch.lowering.memory import certified_peak

    n = circ.num_qubits
    obs.reset()
    t0 = time.perf_counter()
    plan, rep = plan_compiled(tn, target, telemetry=True, **SEARCH)
    search_wall = time.perf_counter() - t0
    counters = rep.telemetry["metrics"]["counters"]
    spans = rep.telemetry["spans"]
    obs.reset()
    # the budget the search itself derived (the one-shot seed's certified
    # envelope) and its own verdict, held against a recount of the peak
    budget = rep.budget_bytes
    peak = certified_peak(plan.tree, plan.smask, 8)
    trace = rep.search_trace
    objective = (plan.partition.hoisted_cost() if plan.smask
                 else plan.tree.total_cost())
    improvement = trace[0]["objective"] / objective
    check(rep.feasible and 0 < peak <= budget,
          f"search: certified peak {peak} over budget {budget} "
          f"(feasible={rep.feasible})")
    check(improvement >= 1.0, f"search: improvement {improvement} < 1")
    check(counters.get("search.evals") == rep.search_evals,
          f"search: counter {counters.get('search.evals')} vs "
          f"{rep.search_evals} evaluations")
    check(trace[0]["move"] == "init" and trace[0]["worker"] == 0,
          "search: the trace does not start at the one-shot seed")

    cg.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = simulate_amplitude(circ, "0" * n, target_dim=target, **SEARCH)
    torch.cuda.synchronize()
    exec_s = time.perf_counter() - t0 - res.report.plan_wall_s
    mem_peak = torch.cuda.max_memory_allocated() - base
    check(res.report.cache_hit and res.plan is plan,
          "search: simulate_amplitude did not reuse the searched plan")
    check_peak("search", mem_peak, res.report.peak_bytes_hoisted)
    amp = complex(res.value)
    amp_err = abs(amp - sv_amp) / abs(sv_amp)
    check(amp_err <= AMP_TOL, f"search: amplitude vs statevector {amp_err}")
    launches, routes = dict(cg.LAUNCHES), dict(cg.FUSED_ROUTES)

    # samp30 (planner seed 0, the sampling phase's restarts), host only
    t0 = time.perf_counter()
    _, _, srep = plan_contraction(tn4, target, repeats=32, **SEARCH)
    samp_wall = time.perf_counter() - t0
    return dict(
        qubits=n, target_dim=target, **SEARCH,
        evaluations=rep.search_evals, search_wall_s=search_wall,
        plan_build_s=spans["plan.build"]["total_s"],
        eval_spans=spans["search.eval"]["count"],
        accepted=counters.get("search.accepted", 0),
        rejected=counters.get("search.rejected", 0),
        restarts=counters.get("search.restarts", 0),
        trace_points=len(trace), improvement=improvement,
        log2_objective_oneshot=math.log2(trace[0]["objective"]),
        log2_objective_searched=math.log2(objective),
        log2_sliced_cost_oneshot=math.log2(
            amp_plan.tree.sliced_cost(amp_plan.smask)),
        log2_sliced_cost_searched=rep.log2_sliced_cost,
        num_sliced_oneshot=amp_plan.num_sliced, num_sliced=plan.num_sliced,
        certified_peak_bytes=peak, budget_bytes=budget, feasible=rep.feasible,
        exec_s=exec_s, exec_s_oneshot=amp_exec_s, rel_err=amp_err,
        amplitude=[amp.real, amp.imag], peak_bytes=mem_peak,
        peak_bytes_planned=res.report.peak_bytes_hoisted,
        backends=res.report.lowered_backends, launches=launches,
        fused_routes=routes,
        samp30=dict(planner_seed=0, repeats=32, wall_s=samp_wall,
                    evaluations=srep.search_evals,
                    log2_sliced_cost_searched=srep.log2_sliced_cost,
                    log2_sliced_cost_oneshot_seed0=samp_costs[0],
                    log2_sliced_cost_oneshot_seed2=samp_costs[2],
                    num_sliced=srep.num_sliced),
    )


def phase_resume(torch, obs, cg, amp_plan, amp_arrays, amp: complex) -> dict:
    """amp30's one-shot plan through contract_resumable(chunk=16) with a
    simulated failure at range 32 (expected: raising it is the point),
    then the resume from the state it left, at chunk=8.  Checks: the
    failure was raised after exactly ids 0-31; the value within 1e-6 of
    |amp| of the amplitude phase's run_all value; each of the 128 ids
    summed exactly once (state and exec.slices_executed); the measured
    peak within the certified peak."""
    import numpy as np

    from repro_torch.core.distributed import SliceRangeCheckpoint, contract_resumable

    n_slices = 1 << amp_plan.num_sliced
    state = SliceRangeCheckpoint(n_slices, set(), np.zeros((), np.complex64))
    cg.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    raised = None
    with obs.enabled_scope(True):
        obs.reset()
        t0 = time.perf_counter()
        try:
            contract_resumable(amp_plan, amp_arrays, chunk=16, state=state,
                               fail_on={32})
        except RuntimeError as e:  # the simulated node failure
            raised = str(e)
        fail_s = time.perf_counter() - t0
        done_at_failure = sorted(state.done_ids())
        t0 = time.perf_counter()
        value, state = contract_resumable(amp_plan, amp_arrays, chunk=8,
                                          state=state)
        resume_s = time.perf_counter() - t0
        counters = obs.telemetry_summary()["metrics"]["counters"]
        spans = obs.trace.summary()
    obs.reset()
    torch.cuda.synchronize()
    mem_peak = torch.cuda.max_memory_allocated() - base
    check(raised is not None and "simulated failure" in raised,
          f"resume: the simulated failure was not raised ({raised})")
    check(done_at_failure == list(range(32)),
          f"resume: {len(done_at_failure)} ids done at the failure, not 0-31")
    check(state.done_ids() == set(range(n_slices)),
          "resume: the resumed state does not cover every id")
    check(counters.get("exec.slices_executed") == n_slices,
          f"resume: {counters.get('exec.slices_executed')} slices summed, "
          f"not {n_slices}")
    val = complex(value)
    err = abs(val - amp) / abs(amp)
    check(err <= RESUME_TOL, f"resume: value off run_all by {err} of |amp|")
    check_peak("resume", mem_peak, amp_plan.memory_plan().peak_bytes_hoisted)
    return dict(
        slices=n_slices, chunk_first=16, fail_on=32, chunk_resume=8,
        raised=raised, done_at_failure=len(done_at_failure),
        slices_executed=counters.get("exec.slices_executed"),
        ranges=spans["exec.slice_range"]["count"],
        fail_s=fail_s, resume_s=resume_s, value=[val.real, val.imag],
        rel_err_vs_run_all=err, peak_bytes=mem_peak,
        peak_bytes_planned=amp_plan.memory_plan().peak_bytes_hoisted,
        launches=dict(cg.LAUNCHES), fused_routes=dict(cg.FUSED_ROUTES),
    )


def phase_multihost(torch, cg, amp_plan, amp_arrays, amp_report, amp: complex,
                    samp_plan, samp_arrays, samp_flat, circ, open_q,
                    target: int, planner_seed: int, dev) -> dict:
    """amp30's one-shot plan through contract_multihost at world size 1
    with a claim store (a temporary directory) and a simulated host
    failure after 2 ranges, then an epoch-1 resume; then samp30 through
    contract_sharded and sample_bitstrings with an explicit device list.
    Checks: the failure was raised; the merged value within 1e-6 of |amp|
    of run_all; every id covered exactly once; the sharded batches bitwise
    the sampling phase's where they sum in its order (one device,
    slice_batch 1: ids in order, one running sum) and within 1e-6 of
    max|batch| where they do not (the card listed twice, slice_batch 4:
    batch partials, then the two devices' partials in device order); a
    list naming a second card, or a card other than the current one, is
    refused before any launch (one process per card)."""
    import shutil
    import tempfile

    from repro_torch.core import sample_bitstrings
    from repro_torch.core.distributed import contract_sharded
    from repro_torch.distributed import ClaimStore, contract_multihost

    n_slices = 1 << amp_plan.num_sliced
    root = tempfile.mkdtemp(prefix="repro_multihost_")
    report = dataclasses.replace(amp_report)
    cg.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        raised = None
        t0 = time.perf_counter()
        try:
            contract_multihost(amp_plan, amp_arrays, world_size=1,
                               checkpoint_dir=root, fail_after=2)
        except RuntimeError as e:  # the simulated host failure
            raised = str(e)
        fail_s = time.perf_counter() - t0
        before = ClaimStore(root, n_slices, host=0).merged()
        done_before = before.done_ids()
        t0 = time.perf_counter()
        res = contract_multihost(amp_plan, amp_arrays, world_size=1,
                                 checkpoint_dir=root, epoch=1, report=report)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mem_peak = torch.cuda.max_memory_allocated() - base
    check(raised is not None and "simulated host 0" in raised,
          f"multihost: the simulated host failure was not raised ({raised})")
    resumed = [i for s, e in res.executed_ranges for i in range(s, e)]
    check(len(resumed) == len(set(resumed)) and done_before.isdisjoint(resumed)
          and done_before | set(resumed) == set(range(n_slices)),
          "multihost: slice ids not covered exactly once")
    check(res.complete and res.state.done_ids() == set(range(n_slices)),
          "multihost: the merged state is incomplete")
    val = complex(res.value)
    err = abs(val - amp) / abs(amp)
    check(err <= RESUME_TOL, f"multihost: merged value off run_all by {err}")
    check_peak("multihost", mem_peak, amp_plan.memory_plan().peak_bytes_hoisted)
    check(report.schedule_imbalance == res.schedule_imbalance,
          "multihost: the report's schedule fields were not filled")

    # samp30 through the explicit-device paths
    scale = float(abs(samp_flat).max())
    t0 = time.perf_counter()
    one = contract_sharded(samp_plan, samp_arrays, [dev]).cpu().numpy().ravel()
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    check(one.tobytes() == samp_flat.tobytes(),
          "multihost: contract_sharded([cuda:0]) is not bitwise the "
          "sampling phase's batch")
    twice = contract_sharded(samp_plan, samp_arrays, [dev, dev],
                             slice_batch=4).cpu().numpy().ravel()
    twice_err = float(abs(twice - samp_flat).max()) / scale
    check(twice_err <= RESUME_TOL,
          f"multihost: contract_sharded([cuda:0, cuda:0]) off by {twice_err}")
    t0 = time.perf_counter()
    samp = sample_bitstrings(circ, num_samples=1000, open_qubits=open_q,
                             target_dim=target, seed=planner_seed, repeats=32,
                             devices=[dev])
    torch.cuda.synchronize()
    samp_s = time.perf_counter() - t0
    check(samp.batch.flat().tobytes() == samp_flat.tobytes(),
          "multihost: sample_bitstrings(devices=[cuda:0]) is not bitwise the "
          "sampling phase's batch")
    launches = dict(cg.LAUNCHES)  # amp30's two runs and samp30's three
    refused = {}
    for devs in (["cuda:0", "cuda:1"], ["cuda:1"]):
        try:
            contract_sharded(samp_plan, samp_arrays, devs)
        except ValueError as e:  # one card per process: refused up front
            refused[",".join(devs)] = str(e)
    check(len(refused) == 2 and cg.LAUNCHES == launches,
          f"multihost: a device list beyond the current card was not "
          f"refused before any launch ({refused})")
    return dict(
        slices=n_slices, fail_after=2, raised=raised,
        done_before_resume=len(done_before),
        executed_on_resume=res.executed_slices, complete=res.complete,
        value=[val.real, val.imag], rel_err_vs_run_all=err,
        schedule_imbalance=res.schedule_imbalance,
        initial_imbalance=res.initial_imbalance, steal_count=res.steal_count,
        overlap_fraction=res.overlap_fraction, fail_s=fail_s, resume_s=resume_s,
        peak_bytes=mem_peak,
        peak_bytes_planned=amp_plan.memory_plan().peak_bytes_hoisted,
        sharded_one_device_s=sharded_s, sharded_bitwise=True,
        sharded_twice_rel_err=twice_err, sampling_devices_s=samp_s,
        sampling_bitwise=True, refused=refused,
        orders={"contract_sharded([cuda:0])": "ids in order, one running sum "
                "(the sampling phase's order): bitwise",
                "sample_bitstrings(devices=[cuda:0])": "the same: bitwise",
                "contract_sharded([cuda:0, cuda:0], slice_batch=4)":
                "4-id batch partials, then the two chunks' partials in device "
                "order: within 1e-6",
                "contract_multihost": "per-range partials, rounds of pushes, "
                "claim-store partials on the host: within 1e-6"},
        launches=launches, fused_routes=dict(cg.FUSED_ROUTES),
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
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.executor import simplify_network
    from repro_torch.kernels import build, contract_gemm as cg
    from repro_torch.kernels import flash_attention as fa, mamba2_ssd as ssd
    from repro_torch.kernels import ops
    from repro_torch.launch.decode_demo import serve
    from repro_torch.models import build_model
    from repro_torch.core.executor import exact_fp32_matmul
    from repro_torch.hardware import H100_SXM
    from repro_torch.lowering.cache import PLAN_CACHE
    from repro_torch.quantum import circuits, statevector
    from repro_torch.sampling.batch import open_batch_network

    def lm_counts() -> dict:
        return {**fa.LAUNCHES, **ssd.LAUNCHES,
                "ssd_routes": dict(ssd.SSD_ROUTES)}

    def lm_reset() -> None:
        fa.reset_launches()
        ssd.reset_launches()

    t_start = time.perf_counter()
    exact_fp32_matmul()  # the plain versions' and the library's fp32 products
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    info = build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0, card=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         libraries={k: v["path"] for k, v in info.items()})
    print(smi, flush=True)
    hgmma = {name: build.kernels_with(lib, kernel, "HGMMA")
             for name, (lib, kernel) in WGMMA_KERNELS.items()}
    emit(phase="sass", hgmma=hgmma)
    for name, found in hgmma.items():
        check(bool(found) and all(found.values()),
              f"{name}: no HGMMA in the SASS of {WGMMA_KERNELS[name][1]}")
    for name in BF16_INSTANCES:
        bf16 = [k for k in hgmma[name] if k.endswith("Lb1EEv9FusedArgs")]
        check(len(bf16) == 4, f"{name}: bf16 instantiations {bf16}")

    # 2. kernels against their plain versions at the main path's shapes
    rows, cols, cycles, target = 5, 6, 14, 28
    n = rows * cols
    circ = circuits.sycamore_like(rows, cols, cycles, seed=0)
    tn, amp_arrays = network(circuits, simplify_network, circ, "0" * n)
    t0 = time.perf_counter()
    amp_plan, report = plan_compiled(tn, target)
    plan_s = time.perf_counter() - t0
    kern = phase_kernels(torch, amp_plan, cg, ops, H100_SXM)
    torch.cuda.empty_cache()
    kern.update(phase_lm_kernels(torch, fa, ssd))
    for name, rec in kern.items():
        emit(phase="kernel", name=name, **rec)
    torch.cuda.empty_cache()

    # 3. amplitude, every slice, against the statevector --------------
    cg.reset_launches()
    launches, routes = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = simulate_amplitude(circ, "0" * n, target_dim=target, backend="gemm")
    torch.cuda.synchronize()
    exec_s = time.perf_counter() - t0 - res.report.plan_wall_s
    amp_peak = torch.cuda.max_memory_allocated() - base
    check_peak("amplitude", amp_peak, res.report.peak_bytes_hoisted)
    launches["amplitude"] = dict(cg.LAUNCHES)
    routes["amplitude"] = dict(cg.FUSED_ROUTES)
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
    amp_exec_s = exec_s
    amp_err = abs(amp - sv_amp) / abs(sv_amp)
    check(amp_err <= AMP_TOL, f"amplitude vs statevector: {amp_err}")
    emit(phase="amplitude", qubits=n, cycles=cycles, target_dim=target,
         num_sliced=res.report.num_sliced, slices=1 << res.report.num_sliced,
         plan_s=res.report.plan_wall_s, exec_s=exec_s, statevector_s=sv_s,
         amplitude=[amp.real, amp.imag], statevector=[sv_amp.real, sv_amp.imag],
         rel_err=amp_err, backends=res.report.lowered_backends,
         chains=res.report.fused_chains, max_chain_len=res.report.max_chain_len,
         peak_bytes=amp_peak, peak_bytes_planned=res.report.peak_bytes_hoisted,
         launches=launches["amplitude"], first_plan_s=plan_s)
    del res
    torch.cuda.empty_cache()

    # 3a. mixed precision under the XEB budget: fp32 and auto, peak mode
    prec = phase_precision(torch, simulate_amplitude, cg, circ, n, target, sv_amp)
    emit(phase="precision", **prec)
    torch.cuda.empty_cache()

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
    routes["sampling"] = dict(cg.FUSED_ROUTES)
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
    samp_flat = samp.batch.flat().copy()
    del samp, oracle
    torch.cuda.empty_cache()

    # 4a. the contraction server on samp30: calibration, then a cold and
    # a warm burst of amplitude and sampling tenants
    eng = phase_engine(torch, cg, circ, n, target, seed4, samp_flat, sv_batch,
                       amp_plan, amp_arrays)
    launches["engine"] = eng.pop("launches")
    routes["engine"] = eng.pop("fused_routes")
    emit(phase="engine", **eng)
    torch.cuda.empty_cache()

    # 4b. the anytime plan search on amp30 (and samp30 on the host)
    srch = phase_search(torch, obs, cg, circ, tn, tn4, target, sv_amp,
                        amp_plan, amp_exec_s, costs)
    launches["search"] = srch.pop("launches")
    routes["search"] = srch.pop("fused_routes")
    emit(phase="search", **srch)
    torch.cuda.empty_cache()

    # 4c. slice-level fault tolerance: a failure, then a resume
    resu = phase_resume(torch, obs, cg, amp_plan, amp_arrays, amp)
    launches["resume"] = resu.pop("launches")
    routes["resume"] = resu.pop("fused_routes")
    emit(phase="resume", **resu)
    torch.cuda.empty_cache()

    # 4d. multi-host scheduling at world size 1, and the explicit-device
    # paths on samp30
    tn4, arrays4 = open_batch_network(circ, "0" * n, open_q)
    samp_plan, _ = plan_compiled(tn4, target, seed=seed4, repeats=32)
    mh = phase_multihost(torch, cg, amp_plan, amp_arrays, report, amp,
                         samp_plan, arrays4, samp_flat, circ, open_q, target,
                         seed4, torch.device("cuda", 0))
    launches["multihost"] = mh.pop("launches")
    routes["multihost"] = mh.pop("fused_routes")
    emit(phase="multihost", **mh)
    del amp_plan, amp_arrays, samp_plan, arrays4
    PLAN_CACHE.clear()
    torch.cuda.empty_cache()

    # 5. 36 qubits, two slices of the full width --------------------
    rows5, cols5, target5 = 6, 6, 30
    n5 = rows5 * cols5
    circ5 = circuits.sycamore_like(rows5, cols5, cycles, seed=0)
    ids = [0, 1]
    cg.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
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
    peak = torch.cuda.max_memory_allocated() - base
    check_peak("share", peak, rep5.peak_bytes_hoisted)
    launches["share"] = dict(cg.LAUNCHES)
    routes["share"] = dict(cg.FUSED_ROUTES)
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

    del ein_val, val
    PLAN_CACHE.clear()  # the plans' hoisted buffers leave the card
    torch.cuda.empty_cache()

    # 6. LM serving at full width, each model's own launches ----------
    for arch in ("qwen3-4b", "mamba2-130m"):
        rec = phase_serve(torch, arch, serve, build_model, get_config,
                          lm_counts, lm_reset)
        launches[f"serve:{arch}"] = rec["launches"]
        emit(phase="serve", **rec)
        torch.cuda.empty_cache()
    check(launches["serve:qwen3-4b"]["flash_attention"] > 0,
          "flash_attention was not launched serving qwen3-4b")
    check(launches["serve:mamba2-130m"]["ssd_chunk"] > 0,
          "ssd_chunk was not launched serving mamba2-130m")
    ssd_routes = launches["serve:mamba2-130m"]["ssd_routes"]
    check(ssd_routes["simt"] == 0
          and ssd_routes["wgmma"] == launches["serve:mamba2-130m"]["ssd_chunk"],
          f"ssd_chunk took the simt route serving mamba2-130m: {ssd_routes}")

    # 7. every kernel went through its path ---------------------------
    total = {k: sum(launches[ph][k]
                    for ph in ("amplitude", "sampling", "engine", "search",
                               "resume", "multihost", "share"))
             for k in cg.LAUNCHES}
    total["flash_attention"] = launches["serve:qwen3-4b"]["flash_attention"]
    total["ssd_chunk"] = launches["serve:mamba2-130m"]["ssd_chunk"]
    for name, count in total.items():
        check(count > 0, f"{name} was not launched on its path")
    # every fused_gemm launch of phases 3-5 and engine took the wgmma
    # kernel, with the coalesced gather of one map for every tile
    fused_routes = {r: sum(routes[ph][r] for ph in routes) for r in cg.FUSED_ROUTES}
    check(sum(fused_routes.values()) == total["fused_gemm"],
          f"fused_gemm launches {total['fused_gemm']} vs routes {fused_routes}")
    check(fused_routes["general"] == 0,
          f"fused_gemm took the general gather on the path: {fused_routes}")
    for name in BF16_ROUTES:
        check(prec["bf16_launches"][name] > 0,
              f"{name}'s bf16 route was not launched in the precision phase")
    records = []
    for name in TPU_KERNELS:
        rec = kern[name]
        records.append(dict(
            name=name, route="cuda", design=DESIGNS[name],
            source=SOURCES[name],
            replaces=TPU_KERNELS[name], launches=total[name],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            **{k: rec[k] for k in ("simt_ms",) if k in rec},
        ))
    for name in BF16_ROUTES:
        rec = kern[f"{name}:bf16"]
        records.append(dict(
            name=f"{name}:bf16", route="cuda", design=BF16_DESIGNS[name],
            source=SOURCES[name], replaces=TPU_KERNELS[name],
            launches=prec["bf16_launches"][name],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
        ))
    emit(phase="done", seconds=time.perf_counter() - t_start,
         launches_by_phase=launches, fused_routes_by_phase=routes,
         bf16_launches_precision_phase=prec["bf16_launches"])
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
