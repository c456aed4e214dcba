"""Time variants of the fused kernel's source (K2) on the card: where its
time goes.

    PYTHONPATH=src python3 -m repro_torch.launch.fused_variants [variant ...]

Builds ``kernels/csrc/gemm.cu`` as it is (``base``) and with named edits,
each with ``nvcc`` into its own library under ``build/kernels/variants/``
(all at once), and times ``contract_gemm.fused_gemm_c64`` with each on
complex64 operands of every fused step of the 30-qubit plan that
``chip_smoke.py`` runs (CUDA events, warm). The variants:

* ``pwg1``, ``pwg4`` — one or four producer warpgroups instead of two;
* ``stream`` — the gather's loads bypass L1 (``L1::no_allocate``);
* ``noproducer`` — the producers only signal the stages (no gather):
  the consumers', the epilogue's and the pipeline's time;
* ``noproducer_nomma`` — neither gather nor ``wgmma``: the pipeline and
  the epilogue alone.

A variant other than ``base`` computes wrong results by design; only its
time is read. Prints one JSON line with the card's name and power limit.
Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import json
import sys

from .variants import build_variants, card, edit, use

_GATHER_A = "          gather_operand<CPLX, BM, BF>(a16, stage, p.a, a_base,"
_GATHER_B = "          gather_operand<CPLX, BN, BF>(b16, stage + 4 * A_PLANE,"
_MMA_LOOP = "      for (int k = 0; k < 4; ++k) {"
VARIANTS = ("base", "pwg1", "pwg4", "stream", "noproducer", "noproducer_nomma")


def variant_source(name: str, src: str) -> str:
    """``src`` with the edits of variant ``name``."""
    if name == "base":
        return src
    if name == "pwg1":
        src = edit(src, "#define F_PWG 2 ", "#define F_PWG 1 ")
        src = edit(src, 'asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" '
                    '::"n"(F_PREG));', "")
        return edit(src, 'asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" '
                     '::"n"(F_CREG));', "")
    if name == "stream":
        src = edit(src, "hopper::ldg_f2(", "hopper::ldg_stream_f2(")
        src = edit(src, "hopper::ldg_f1(", "hopper::ldg_stream_f1(")
        return edit(src, '#include "hopper.cuh"', """#include "hopper.cuh"
namespace hopper {
__device__ __forceinline__ float2 ldg_stream_f2(const float2* p) {
  float2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];\\n"
               : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ float ldg_stream_f1(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];\\n"
               : "=f"(v) : "l"(p));
  return v;
}
}  // namespace hopper""")
    if name == "pwg4":
        src = edit(src, "#define F_PWG 2 ", "#define F_PWG 4 ")
        return edit(src, "#define F_PREG 96", "#define F_PREG 40")
    if name in ("noproducer", "noproducer_nomma"):
        src = edit(src, _GATHER_A, "          if (M < 0) " + _GATHER_A.lstrip())
        src = edit(src, _GATHER_B, "          if (M < 0) " + _GATHER_B.lstrip())
        if name == "noproducer_nomma":
            src = edit(src, _MMA_LOOP, "      for (int k = 0; k < 0; ++k) {")
        return src
    raise ValueError(f"unknown variant {name!r}")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("fused_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import plan_compiled
    from repro_torch.core.executor import simplify_network
    from repro_torch.kernels import contract_gemm as cg
    from repro_torch.quantum import circuits

    names = argv or list(VARIANTS)
    libs = build_variants("gemm", names, variant_source)
    name_power = card()
    circ = circuits.sycamore_like(5, 6, 14, seed=0)
    tn, _ = simplify_network(*circuits.circuit_to_network(circ, bitstring="0" * 30))
    plan, _ = plan_compiled(tn, 28)
    forms = sorted({s.form for s in plan.schedule.specs if s.backend == "fused"},
                   key=lambda f: -f.flops)
    gen = torch.Generator().manual_seed(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    rows = []
    for f in forms:
        a = torch.complex(torch.randn(f.a_shape, generator=gen),
                          torch.randn(f.a_shape, generator=gen)).cuda()
        b = torch.complex(torch.randn(f.b_shape, generator=gen),
                          torch.randn(f.b_shape, generator=gen)).cuda()
        row = dict(shape=[f.B, f.M, f.N, f.K])
        for name, lib in libs.items():
            use("gemm", lib)  # the wrapper launches this library now
            cg.fused_gemm_c64(a, b, f)
            torch.cuda.synchronize()
            start.record()
            for _ in range(10):
                cg.fused_gemm_c64(a, b, f)
            end.record()
            torch.cuda.synchronize()
            row[name] = start.elapsed_time(end) / 10
        rows.append(row)
        del a, b
    use("gemm", None)
    print(json.dumps(dict(card=name_power, ms=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
