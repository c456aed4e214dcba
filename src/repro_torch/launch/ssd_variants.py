"""Time variants of the SSD chunk kernel's source (K5) on the card: where
its time goes.

    PYTHONPATH=src python3 -m repro_torch.launch.ssd_variants [variant ...]

Builds ``kernels/csrc/mamba2_ssd.cu`` as it is (``base``) and with named
edits, each with ``nvcc`` into its own library under
``build/kernels/variants/`` (all at once), and times the wgmma kernel
through ``mamba2_ssd.ssd_intra_chunk`` at the mamba2-130m serve shape
that ``chip_smoke.py`` uses (BH 96, 8 chunks of 64, D 64, S 128, 4 B/C
groups), the kernel alone on the profiler's device clock. The variants:

* ``noproducer`` — the producers write no xdt planes (they still load,
  scan and signal each unit): the consumers', the stores' and the
  pipeline's time;
* ``nomma`` — the consumers run no ``wgmma`` for y and the states;
* ``noexp`` — the y warpgroup's decay factors are 1 (no ``expf``);
* ``nostore`` — y and the states are not written to device memory;
* ``hb1``, ``hb24`` — the base kernel with 1 or 24 heads a block (768 or
  32 blocks, against 6 heads and 128 blocks by ``heads_per_block``).

Beside them: the base wrapper's time with CUDA events over back-to-back
calls (host time included) and the simt kernel's device time. A variant
other than ``base``, ``hb1`` and ``hb24`` computes wrong results by
design; only its time is read. Prints one JSON line with the card's name
and power limit. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import json
import sys

from .variants import build_variants, card, edit, use

_PLANES = "      for (int r = 0; r < 8; ++r) {"
_Y_MMA = ("      ktile_rs(acc, ah[0], al[0], xp, W_PLANE);\n"
          "      ktile_rs(part, ah[1], al[1], xp + W_SUB, W_PLANE);\n")
_ST_MMA = ("      ktile_ss(acc, am, S * 256, vp, W_PLANE);\n"
           "      ktile_ss(part, am + S * 128, S * 256, vp + W_SUB, W_PLANE);\n")
_Y_STORE = "      store_tile(y + cell_of(u)"
_ST_STORE = "      store_tile(out + (long long)64 * mt * D"
VARIANTS = ("base", "noproducer", "nomma", "noexp", "nostore", "hb1", "hb24")


def variant_source(name: str, src: str) -> str:
    """``src`` with the edits of variant ``name``."""
    if name in ("base", "hb1", "hb24"):
        return src
    if name == "noproducer":
        return edit(src, _PLANES, "      for (int r = 0; r < 0; ++r) {")
    if name == "nomma":
        return edit(edit(src, _Y_MMA, ""), _ST_MMA, "")
    if name == "noexp":
        src = edit(src, "expf(ci[h] - cj.x)", "1.f")
        return edit(src, "expf(ci[h] - cj.y)", "1.f")
    if name == "nostore":
        src = edit(src, _Y_STORE, "      if (D < 0) " + _Y_STORE.lstrip())
        return edit(src, _ST_STORE, "      if (D < 0) " + _ST_STORE.lstrip())
    raise ValueError(f"unknown variant {name!r}")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device", file=sys.stderr)
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

    def device_ms(route: str, key: str, n: int = 20) -> float:
        ssd.ssd_intra_chunk(x, dt, a, b, c, route=route)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                ssd.ssd_intra_chunk(x, dt, a, b, c, route=route)
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and key in e.key)
        return us / 1e3 / n

    def wrapper_ms(n: int = 50) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ssd.ssd_intra_chunk(x, dt, a, b, c)
        start.record()
        for _ in range(n):
            ssd.ssd_intra_chunk(x, dt, a, b, c)
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
        ms[name] = device_ms("wgmma", "ssd_chunk_wgmma")
    ssd.heads_per_block = chosen
    use("mamba2_ssd", libs[names[0]])
    extra = dict(wrapper_ms=wrapper_ms(),
                 simt_ms=device_ms("simt", "ssd_chunk_kernel"))
    use("mamba2_ssd", None)
    print(json.dumps(dict(card=name_power, ms=ms, **extra)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
