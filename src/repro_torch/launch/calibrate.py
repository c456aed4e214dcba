"""Measure what each lowering backend costs on the card, step by step.

    PYTHONPATH=src python3 -m repro_torch.launch.calibrate [--out PATH] [--trees]

The refiner (``lowering/refiner.py``) and the merging surface
(``core/merging.py``) price every contraction step with the constants of
``hardware.H100_SXM``.  This script reads those constants off the card.
For every distinct GEMM form of the 30-qubit amplitude plan and the
36-qubit share plan of ``chip_smoke.py`` it times, on complex64
operands, each backend the refiner can give the step: ``fused``
(``ops.fused_matmul``, K2), ``tiled`` (the permuted copies, then
``ops.matmul``, K1), ``dot`` (the permuted copies, then ``torch.matmul``)
and ``einsum`` (``torch.einsum``), with CUDA events around back-to-back
calls, which is what the executor pays.  Beside each it prints the
form's real operations as the refiner counts them, so a backend's rate
is ``flops / ms``.  It also times the bf16 routes where the kernels
have one (``precision="bf16"``), and K1 and K2 alone at their path
shapes on the profiler's device clock.

With ``--trees`` it also runs the 30-qubit amplitude (every slice) and
two slices of the 36-qubit share on the trees the merging surface builds
at each of the kernels' tile edges, 64 and 128 (``Hardware.tile``, the
surface's quantization step; the rest of ``H100_SXM`` as it is), so that
the edge the constants carry is the one the card runs fastest.

Prints one JSON summary line (the card's name and power limit first)
and writes every record to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

BACKENDS = ("fused", "tiled", "dot", "einsum")


def time_ms(fn, n: int = 5, device="cuda") -> float:
    """Mean milliseconds of ``fn()`` over back-to-back calls, after one
    untimed warm-up call: CUDA events around the calls on a CUDA
    ``device`` (at least ``n`` calls, more for a short ``fn``, up to
    about 100 ms), ``time.perf_counter`` over ``n`` calls on the CPU."""
    import time

    import torch

    if torch.device(device).type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e3 * (time.perf_counter() - t0) / n
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    n = int(max(n, min(50, 100.0 / once)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _device_ms(torch, fn, name: str, n: int = 10) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name in e.key)
    return us / 1e3 / n


def time_forms(torch, plans) -> list[dict]:
    """Every distinct form of ``plans``, each backend timed."""
    from repro_torch.lowering import gemm_form
    from repro_torch.lowering.refiner import _real_gemm_count

    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")

    def crnd(shape):
        re, im = torch.randn(tuple(shape), generator=gen), torch.randn(
            tuple(shape), generator=gen)
        return torch.complex(re, im).to(dev)

    seen, out = {}, []
    for name, plan in plans.items():
        for spec in plan.schedule.specs:
            f = spec.form
            if f in seen:
                seen[f]["count"][name] = seen[f]["count"].get(name, 0) + 1
                continue
            a, b = crnd(f.a_shape), crnd(f.b_shape)
            rec = dict(shape=[f.B, f.M, f.N, f.K], chosen=spec.backend,
                       count={name: 1}, ms={}, flops={})
            for backend in BACKENDS:
                s = dataclasses.replace(spec, backend=backend, bm=128, bn=128,
                                        bk=128)
                rec["flops"][backend] = f.flops * _real_gemm_count(
                    torch.complex64, backend)
                for prec in ("fp32", "bf16"):
                    if prec == "bf16" and backend not in ("fused", "tiled"):
                        continue
                    sp = dataclasses.replace(s, precision=prec)
                    key = backend if prec == "fp32" else f"{backend}:bf16"
                    try:
                        rec["ms"][key] = time_ms(lambda: gemm_form.apply(sp, a, b))
                    except Exception as e:  # noqa: BLE001 - recorded, not hidden
                        rec["ms"][key] = None
                        rec.setdefault("errors", {})[key] = repr(e)[:200]
            seen[f] = rec
            out.append(rec)
            del a, b
            torch.cuda.empty_cache()
    return out


def kernels_alone(torch, plan) -> dict:
    """K1 and K2 alone (device clock) at the largest tiled and fused
    steps of ``plan``: fp32 (3xTF32) and, where there is one, bf16."""
    from repro_torch.kernels import contract_gemm as cg

    gen = torch.Generator().manual_seed(1)
    dev = torch.device("cuda")
    out = {}
    specs = plan.schedule.specs
    for backend in ("tiled", "fused"):
        cand = [s for s in specs if s.backend == backend]
        if not cand:
            continue
        f = max(cand, key=lambda s: s.form.flops).form
        if backend == "tiled":
            a = torch.randn(f.B, f.M, f.K, generator=gen).to(dev)
            b = torch.randn(f.B, f.K, f.N, generator=gen).to(dev)
            ac = torch.complex(a, torch.randn_like(a))
            bc = torch.complex(b, torch.randn_like(b))
            rows = {
                "fp32": (lambda: cg.tiled_gemm(a, b), 2.0 * f.B * f.M * f.N * f.K),
                "c64": (lambda: cg.tiled_gemm(ac, bc), 8.0 * f.B * f.M * f.N * f.K),
                "bf16": (lambda: cg.tiled_gemm(a, b, precision="bf16"),
                         2.0 * f.B * f.M * f.N * f.K),
                "c64:bf16": (lambda: cg.tiled_gemm(ac, bc, precision="bf16"),
                             8.0 * f.B * f.M * f.N * f.K),
            }
            name = "gemm"
        else:
            ac = torch.complex(torch.randn(f.a_shape, generator=gen),
                               torch.randn(f.a_shape, generator=gen)).to(dev)
            bc = torch.complex(torch.randn(f.b_shape, generator=gen),
                               torch.randn(f.b_shape, generator=gen)).to(dev)
            rows = {
                "c64": (lambda: cg.fused_gemm_c64(ac, bc, f),
                        8.0 * f.B * f.M * f.N * f.K),
                "c64:bf16": (lambda: cg.fused_gemm_c64(ac, bc, f, precision="bf16"),
                             8.0 * f.B * f.M * f.N * f.K),
            }
            name = "fused_gemm"
        rec = dict(shape=[f.B, f.M, f.N, f.K])
        for key, (fn, flops) in rows.items():
            try:
                ms = _device_ms(torch, fn, name)
                rec[key] = dict(ms=ms, tflops=flops / ms / 1e9)
            except Exception as e:  # noqa: BLE001 - recorded, not hidden
                rec[key] = dict(error=repr(e)[:200])
        out[backend] = rec
    return out


TREE_TILES = (64, 128)  # K2/K3's tile edge and K1's


def trees(torch, tiles=TREE_TILES) -> list[dict]:
    """End-to-end seconds of the amp30 amplitude and the share36 slices
    on the trees of each merging-surface tile edge."""
    import time

    from repro_torch.core import open_session, simulate_amplitude
    from repro_torch.hardware import H100_SXM
    from repro_torch.quantum import circuits

    out = []
    for tile in tiles:
        hw = dataclasses.replace(H100_SXM, tile=tile)
        rec = dict(tile=tile)
        circ = circuits.sycamore_like(5, 6, 14, seed=0)
        for _ in range(2):  # the second run is warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = simulate_amplitude(circ, "0" * 30, target_dim=28, hw=hw)
            torch.cuda.synchronize()
            rec["amp30_exec_s"] = time.perf_counter() - t0 - res.report.plan_wall_s
        rec.update(amp30_log2_cost=res.report.log2_sliced_cost,
                   amp30_num_sliced=res.report.num_sliced,
                   amp30_backends=res.report.lowered_backends)
        del res
        circ6 = circuits.sycamore_like(6, 6, 14, seed=0)
        sess, rep = open_session(circ6, "0" * 36, target_dim=30, hw=hw)
        sess.hoisted()
        sess.run_slices([0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run_slices([1, 2])
        torch.cuda.synchronize()
        per = (time.perf_counter() - t0) / 2
        rec.update(share36_seconds_per_slice=per, share36_num_sliced=rep.num_sliced,
                   share36_all_slices_s=per * (1 << rep.num_sliced),
                   share36_log2_cost=rep.log2_sliced_cost,
                   share36_peak_planned=rep.peak_bytes_hoisted,
                   share36_backends=rep.lowered_backends)
        del sess
        torch.cuda.empty_cache()
        out.append(rec)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/calibrate.json")
    ap.add_argument("--trees", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import plan_compiled
    from repro_torch.core.executor import exact_fp32_matmul, simplify_network
    from repro_torch.kernels import build
    from repro_torch.quantum import circuits

    build.build_all()
    exact_fp32_matmul()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    plans = {}
    for name, (rows, cols, target) in (("amp30", (5, 6, 28)),
                                       ("share36", (6, 6, 30))):
        circ = circuits.sycamore_like(rows, cols, 14, seed=0)
        tn, _ = simplify_network(*circuits.circuit_to_network(
            circ, bitstring="0" * (rows * cols)))
        plans[name], _ = plan_compiled(tn, target)
    alone = kernels_alone(torch, plans["amp30"])
    forms = time_forms(torch, plans)
    tree_recs = trees(torch) if args.trees else []
    with open(args.out, "w") as f:
        json.dump(dict(card=card, kernels_alone=alone, forms=forms, trees=tree_recs), f)
    best = {}
    for r in forms:
        ms = {k: v for k, v in r["ms"].items() if v is not None and ":" not in k}
        if ms:
            w = min(ms, key=ms.get)
            best[w] = best.get(w, 0) + sum(r["count"].values())
    print(json.dumps(dict(card=card, kernels_alone=alone, forms=len(forms),
                          fastest_backend_steps=best, trees=tree_recs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
