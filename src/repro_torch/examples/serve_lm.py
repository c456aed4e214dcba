"""Batched serving example: prefill + decode with KV cache for a dense
GQA model and an attention-free SSM, reporting tokens/s.  The port's twin
of ``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device {cuda,cpu}]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch seamless-m4t-medium

By default both of the reference example's models, each its reference
smoke shrink (batch 4, prompt 64, 24 generated tokens); ``--arch`` serves
another registered architecture's shrink the same way (zamba2-7b: the
hybrid, whose shrink's window of 64 keys the prompt fills;
seamless-m4t-medium: the encoder-decoder, on as many frames as prompt
tokens).  Served by
:func:`repro_torch.launch.decode_demo.serve` on ``--device`` (default
``cuda``; with no GPU it fails unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse

from ..launch.decode_demo import serve

ARCHS = ("qwen3-4b", "mamba2-130m")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", action="append",
                    help="an architecture to serve (repeatable; default "
                    "the reference example's two)")
    args = ap.parse_args(argv)
    out = {}
    for arch in args.arch or ARCHS:
        r = serve(arch, smoke=True, batch=4, prompt_len=64, gen_tokens=24,
                  device=args.device)
        print(
            f"{arch:<16} prefill {r['prefill_s']*1e3:8.1f} ms   "
            f"decode {r['decode_tok_per_s']:8.1f} tok/s   "
            f"sample: {r['generated'][0][:8].tolist()}"
        )
        out[arch] = r
    return out


if __name__ == "__main__":
    main()
