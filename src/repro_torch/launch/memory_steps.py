"""Measured device memory of one slice, step by step, against the plan.

    PYTHONPATH=src python3 -m repro_torch.launch.memory_steps [--out PATH]
        [--precision fp32|auto] [--fidelity-tol TOL]

For the 30-qubit amplitude plan of ``chip_smoke.py`` (``sycamore_like(5,
6, 14)``, ``target_dim=28``, in width- and in peak-mode slicing, the
latter the smoke's precision phase) and the 36-qubit share plan
(``sycamore_like(6, 6, 14)``, ``target_dim=30``), opens a session on the
card, runs the hoisted prologue, then one epilogue slice with every
dispatch of the executor (one step, or one chain call) wrapped: the
allocator's peak during the dispatch (``torch.cuda.max_memory_allocated``
after a reset) is set against the lifetime plan's live bytes at that
step.  ``excess`` is what the dispatch held beyond its plan: the
measured peak less the bytes resident before the slice (leaf tensors,
hoisted buffers) less the planned live set without the hoisted buffers.

Prints one JSON line per plan (the worst dispatches first) and writes
the full records to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def planned_live(seg) -> dict[int, int]:
    """Planned live bytes of ``seg`` right after each step's output is
    allocated (its inputs still resident), keyed by the step's output
    node: the sweep behind ``SegmentPlan.peak_bytes``."""
    cur = sum(seg.nbytes[v] for v in seg.entry)
    live = {}
    for _, _, out in seg.steps:
        cur += seg.nbytes[out]
        live[out] = cur
        cur -= sum(seg.nbytes[u] for u in seg.frees[out])
    return live


def measure(torch, circ, n: int, target: int, **plan_kw) -> dict:
    from repro_torch.core import open_session
    from repro_torch.lowering import gemm_form

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    sess, report = open_session(circ, "0" * n, target_dim=target, **plan_kw)
    plan = sess.plan
    mem = plan.memory_plan()
    leaves = torch.cuda.memory_allocated() - start
    torch.cuda.reset_peak_memory_stats()
    sess.hoisted()
    torch.cuda.synchronize()
    prologue_peak = torch.cuda.max_memory_allocated() - start
    seg = mem.segment_for("epilogue") or mem.naive
    live = planned_live(seg)
    pinned = seg.pinned_bytes
    specs = plan.schedule.specs
    pos = {st.out: k for k, st in enumerate(plan.steps)}
    records = []
    apply, apply_chain = gemm_form.apply, gemm_form.apply_chain

    def record(kind, outs, fn, *args, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        want = max(live.get(v, 0) for v in outs) - pinned
        f = specs[pos[outs[-1]]].form
        records.append(dict(
            kind=kind, steps=[pos[v] for v in outs], shape=[f.B, f.M, f.N, f.K],
            precision=[specs[pos[v]].precision for v in outs],
            before=before - base, peak=peak - base, planned_live=want,
            excess=peak - base - want,
        ))
        return out

    def wrapped_apply(spec, a, b, **kw):
        out_node = next(st.out for st in plan.steps if specs[pos[st.out]] is spec)
        return record(spec.backend, [out_node], apply, spec, a, b, **kw)

    def wrapped_chain(chain, cspecs, operands, **kw):
        return record("chain", [n[2] for n in chain.nodes], apply_chain,
                      chain, cspecs, operands, **kw)

    sess.run_slice(0)  # warm: launch states, maps
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gemm_form.apply, gemm_form.apply_chain = wrapped_apply, wrapped_chain
    try:
        out = sess.run_slice(1)
    finally:
        gemm_form.apply, gemm_form.apply_chain = apply, apply_chain
    torch.cuda.synchronize()
    del out
    # the whole slice again, unwrapped: its peak over the resident bytes
    torch.cuda.reset_peak_memory_stats()
    out = sess.run_slice(1)
    torch.cuda.synchronize()
    slice_peak = torch.cuda.max_memory_allocated() - base
    del out, sess
    records.sort(key=lambda r: -r["excess"])
    return dict(
        qubits=n, target_dim=target, num_sliced=report.num_sliced,
        precision=report.precision, backends=report.lowered_backends,
        planned=dict(peak_bytes_hoisted=report.peak_bytes_hoisted,
                     prologue=mem.prologue.peak_bytes if mem.prologue else 0,
                     epilogue=seg.peak_bytes, pinned=pinned),
        leaves_bytes=leaves, prologue_peak=prologue_peak,
        slice_peak_over_resident=slice_peak,
        slice_planned_over_pinned=seg.peak_bytes - pinned,
        worst=records[:12], records=records,
    )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/memory_steps.json")
    ap.add_argument("--precision", default="fp32")
    ap.add_argument("--fidelity-tol", type=float, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("memory_steps: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.quantum import circuits

    build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kw = dict(precision=args.precision)
    if args.fidelity_tol is not None:
        kw["fidelity_tol"] = args.fidelity_tol
    full = {}
    for name, (rows, cols, target, mode) in (("amp30", (5, 6, 28, "width")),
                                             ("amp30_peak", (5, 6, 28, "peak")),
                                             ("share36", (6, 6, 30, "width"))):
        circ = circuits.sycamore_like(rows, cols, 14, seed=0)
        rec = measure(torch, circ, rows * cols, target, slicing_mode=mode, **kw)
        full[name] = rec
        print(json.dumps(dict(plan=name, card=card, **{
            k: v for k, v in rec.items() if k != "records"})), flush=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, plans=full), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
