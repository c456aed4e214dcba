"""Time variants of the SSD chunk backward's wgmma kernel (K5 backward) on
the card: where its time goes.

    PYTHONPATH=src python3 -m repro_torch.launch.ssd_bwd_variants [variant ...]

Builds ``kernels/csrc/mamba2_ssd.cu`` as it is (``base``) and with named
edits, each with ``nvcc`` into its own library under
``build/kernels/variants/`` (all at once), and times
``ssd_chunk_bwd_wgmma_kernel`` through ``mamba2_ssd.ssd_intra_chunk_bwd``
at the mamba2-130m training shape that ``chip_smoke.py`` uses (BH 96, 8
chunks of 64, D 64, S 128, 4 B/C groups), the kernel alone on the
profiler's device clock. The variants:

* ``nomma`` — the products issue no ``wgmma`` (their A operands are
  still loaded and split): the loads', the element-wise work's and the
  barriers' time;
* ``noload`` — the A operands are not read from device memory (each
  fragment is a value of its indices): the products', the element-wise work's and the
  barriers' time;
* ``noplanes`` — the rows-i warpgroup writes no M^T, G^T and G planes;
* ``noexp`` — the decay factors are 1 (no ``expf``);
* ``nogx`` — the rows-d warpgroup reads no x and writes no gx (its
  gw and gdt sums take the product alone);
* ``hb1``, ``hb24`` — the base kernel with 1 or 24 heads a block (768 or
  32 blocks, against 6 heads and 128 blocks by ``heads_per_block``).

Beside them: the base wrapper's time with CUDA events over back-to-back
calls (host time and the block shares' group sum included). A variant
other than ``base``, ``hb1`` and ``hb24`` computes wrong results by
design; only its time is read. Prints one JSON line with the card's name
and power limit. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import json
import sys

from .variants import build_variants, card, edit, use

_MMA = ("      ktile_rs(res, ah, al, b, b_lo);\n",
        "      ktile_rs(part, ah, al, b + kt * 8192, b_lo);\n")
_LOAD = "      raw[4 * s + r] = hopper::ldg_f1(a + m * sm + k * sk);\n"
_NO_LOAD = "      raw[4 * s + r] = 1e-3f * (float)(m + k + sm + sk);\n"
_PLANES = ("            wb_put(sm + LY::MT, 16384, wb_off(j, i), m);\n"
           "            wb_put(sm + LY::GT, 16384, wb_off(j, i), gv);\n"
           "            wb_put(sm + LY::GN, 16384, wb_off(i, j), gv);\n")
_EXP = "            const float lm = low ? expf(ci[hf] - cum1[j]) : 0.f;\n"
_GX = ("          acc[2 * jb + (i & 1)] += xh[j * D + d] * dv[j] * bgv;\n"
       "          gxh[j * D + d] = wv[j] * bgv;\n",
       "          const float gxd = res[4 * jb + i] + gxh[j * D + d];\n"
       "          acc[2 * jb + (i & 1)] += gxd * xh[j * D + d];\n"
       "          gxh[j * D + d] = gxd * dv[j];\n")
VARIANTS = ("base", "nomma", "noload", "noplanes", "noexp", "nogx", "hb1",
            "hb24")


def variant_source(name: str, src: str) -> str:
    """``src`` with the edits of variant ``name``."""
    if name in ("base", "hb1", "hb24"):
        return src
    if name == "nomma":
        return edit(edit(src, _MMA[0], ""), _MMA[1], "")
    if name == "noload":
        return edit(src, _LOAD, _NO_LOAD)
    if name == "noexp":
        return edit(src, _EXP, "            const float lm = low ? 1.f : 0.f;\n")
    if name == "nogx":
        src = edit(src, _GX[0], "          acc[2 * jb + (i & 1)] += bgv;\n")
        return edit(src, _GX[1], "          acc[2 * jb + (i & 1)] += res[4 * jb + i];\n")
    if name == "noplanes":
        return edit(src, _PLANES, "            (void)m;\n")
    raise ValueError(f"unknown variant {name!r}")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import mamba2_ssd as ssd

    names = argv or list(VARIANTS)
    libs = build_variants("mamba2_ssd", names, variant_source)
    name_power = card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, C, L, D, N = 4, 24, 8, 64, 64, 128
    x = torch.randn(B * H, C, L, D, generator=gen, device="cuda")
    dt = 0.1 + 0.9 * torch.rand(B * H, C, L, generator=gen, device="cuda")
    a = -(0.01 + 0.49 * torch.rand(B * H, C, L, generator=gen, device="cuda"))
    b = torch.randn(B, C, L, N, generator=gen, device="cuda")
    c = torch.randn(B, C, L, N, generator=gen, device="cuda")
    gy = torch.randn(B * H, C, L, D, generator=gen, device="cuda")
    gst = torch.randn(B * H, C, N, D, generator=gen, device="cuda")

    def call():
        return ssd.ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst, route="wgmma")

    def device_ms(key: str, n: int = 20) -> float:
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and key in e.key)
        return us / 1e3 / n

    def wrapper_ms(n: int = 50) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        call()
        start.record()
        for _ in range(n):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    hb_of = {"hb1": 1, "hb24": 24}
    chosen = ssd.heads_per_block
    ms = {}
    for name, lib in libs.items():
        use("mamba2_ssd", lib)  # the wrapper launches this library now
        ssd.heads_per_block = (
            (lambda *_a, hb=hb_of[name]: hb) if name in hb_of else chosen)
        ms[name] = device_ms("ssd_chunk_bwd_wgmma")
    ssd.heads_per_block = chosen
    use("mamba2_ssd", libs[names[0]])
    extra = dict(wrapper_ms=wrapper_ms())
    use("mamba2_ssd", None)
    print(json.dumps(dict(card=name_power, ms=ms, **extra)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
