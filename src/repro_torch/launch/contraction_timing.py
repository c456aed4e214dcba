"""Time the fused (K2) and chain (K3) kernels' path calls on the card.

    python3 src/repro_torch/launch/contraction_timing.py [--src DIR]

Imports ``repro_torch`` from ``DIR`` (default: the ``src`` of the
checkout around this file), so one call on the card can time two trees
in turn with the same script.  Plans the 30-qubit amplitude circuit of
``chip_smoke.py`` (``sycamore_like(5, 6, 14)``, ``target_dim=28``) on
the card and measures, warm:

* ``ops.fused_matmul`` on complex64 operands at each fused step of the
  plan (CUDA events around back-to-back calls: what the path pays);
* ``ops.fused_chain`` on complex64 externals at the longest epilogue
  chain (the chain ``chip_smoke.py`` times), the same way;
* the chain kernel alone, relaunched through
  ``contract_gemm.chain_gemm_launcher`` with its state built once, for
  the whole chain and for its first step only, on the profiler's device
  clock;
* for one path call of each, the device time of every kernel it
  launched and of the contraction kernel among them (profiler), so the
  time of the glue around the kernel shows.

Prints one JSON line, with the card's name and power limit.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _ms(torch, fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _device(torch, fn, n: int = 10) -> dict:
    """Device milliseconds per call of ``fn``: all kernels, and by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by[e.key[:60]] = e.self_device_time_total / 1e3 / n
    return by


def _sum(by: dict, name: str = "") -> float:
    return sum(v for k, v in by.items() if name in k)


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.normpath(os.path.join(here, "..", "..")))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("contraction_timing: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import plan_compiled
    from repro_torch.core.executor import simplify_network
    from repro_torch.kernels import build, contract_gemm as cg, ops
    from repro_torch.quantum import circuits

    build.build_all(["gemm"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    circ = circuits.sycamore_like(5, 6, 14, seed=0)
    tn, _ = simplify_network(*circuits.circuit_to_network(circ, bitstring="0" * 30))
    plan, _ = plan_compiled(tn, 28)
    specs = plan.schedule.specs
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")

    def crnd(shape, scale=1.0):
        re = torch.randn(tuple(shape), generator=gen)
        im = torch.randn(tuple(shape), generator=gen)
        return (scale * torch.complex(re, im)).to(dev)

    fused = []
    for f in sorted({s.form for s in specs if s.backend == "fused"},
                    key=lambda f: -f.flops):
        a, b = crnd(f.a_shape), crnd(f.b_shape)
        by = _device(torch, lambda: ops.fused_matmul(a, b, f))
        fused.append(dict(
            shape=[f.B, f.M, f.N, f.K],
            path_ms=_ms(torch, lambda: ops.fused_matmul(a, b, f)),
            path_device_ms=_sum(by), kernel_device_ms=_sum(by, "fused_gemm"),
        ))
        del a, b

    chains = plan.chain_plan.segment_chains("epilogue") or list(plan.chain_plan.chains)
    ch = max(chains, key=lambda c: (c.n_steps, sum(specs[p].form.flops for p in c.positions)))
    forms = tuple(specs[p].form for p in ch.positions)
    shapes = [forms[0].a_shape, forms[0].b_shape] + [
        forms[t].b_shape if ch.carry_side[t] == "l" else forms[t].a_shape
        for t in range(1, len(forms))
    ]
    scales = [forms[0].K ** -0.25] * 2 + [f.K ** -0.5 for f in forms[1:]]
    ext = [crnd(s, sc) for s, sc in zip(shapes, scales)]
    kw = dict(forms=forms, carry_side=ch.carry_side, slot_ids=ch.slot_ids,
              slot_elems=ch.slot_elems)
    by = _device(torch, lambda: ops.fused_chain(ext, **kw))
    comps = [c for e in ext for c in (e.real.contiguous(), e.imag.contiguous())]
    launch, _ = cg.chain_gemm_launcher(comps, forms, ch.carry_side, ch.slot_ids,
                                       ch.slot_elems, complex_mode=True)
    one, _ = cg.chain_gemm_launcher(comps[:4], forms[:1], ch.carry_side[:1], (), (),
                                    complex_mode=True)
    chain = dict(
        shapes=[[f.B, f.M, f.N, f.K] for f in forms],
        path_ms=_ms(torch, lambda: ops.fused_chain(ext, **kw), 100),
        path_device_ms=_sum(by), kernel_device_ms=_sum(by, "chain_gemm"),
        kernel_ms=_sum(_device(torch, launch, 50), "chain_gemm"),
        one_step_kernel_ms=_sum(_device(torch, one, 50), "chain_gemm"),
    )
    print(json.dumps(dict(src=os.path.abspath(args.src), card=card,
                          fused_matmul=fused, fused_chain=chain)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
