"""Batched LM decode: prefill a batch of prompts, then decode greedily.

The port's twin of the reference's ``repro.launch.decode_demo`` (which
``examples/serve_lm.py`` drives): build the model with random weights
from a seed, prefill a batch of random prompts into a KV or SSM state
cache, decode ``gen_tokens`` tokens by greedy argmax, and report
``prefill_s``, ``decode_s`` and ``decode_tok_per_s``.  A VLM backbone
(``embed_inputs``) takes random prompt embeddings in place of the
vision frontend, and M-RoPE models their (3, B, S) positions, as in the
reference; an encoder-decoder (seamless-m4t-medium) takes as many
random frame embeddings as prompt tokens, as the reference's demo does,
its encoder reading the frames and its decoder the tokens.  Prefill
attention runs the flash kernel (with the hybrid's sliding window for
zamba2-7b, without the causal mask in the encoder-decoder's encoder and
cross-attention) and the Mamba-2 prefill the SSD chunk kernel on the
card.

    PYTHONPATH=src python -m repro_torch.launch.decode_demo --arch qwen3-4b \\
        --batch 4 --prompt-len 512 --gen 32 --full
    PYTHONPATH=src python -m repro_torch.launch.decode_demo \\
        --arch deepseek-moe-16b --batch 4 --prompt-len 512 --full
    PYTHONPATH=src python -m repro_torch.launch.decode_demo \\
        --arch zamba2-7b --batch 1 --prompt-len 8192 --full
    PYTHONPATH=src python -m repro_torch.launch.decode_demo \\
        --arch seamless-m4t-medium --batch 4 --prompt-len 512 --full

Without ``--full`` the model is the reference's smoke shrink of the
architecture.  The default device is the card; ``--device cpu`` runs the
plain versions of the kernels on the host.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import get_config, smoke_shrink
from ..core.executor import resolve_device
from ..models import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_inputs(cfg, batch: int, prompt_len: int,
                  generator: torch.Generator) -> dict:
    """The prompt of a serve run, drawn from ``generator`` on its device
    as the reference's demo draws it: ``tokens`` (batch, prompt_len);
    for an ``embed_inputs`` config (the VLM backbone, the
    encoder-decoder) random fp32 ``embeds`` (batch, prompt_len, d_model)
    (the stub frontend's output); for M-RoPE
    ``positions`` (3, batch, prompt_len), the text positions on all
    three axes."""
    dev = generator.device
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=generator, device=dev)}
    if cfg.embed_inputs:
        out["embeds"] = torch.randn(batch, prompt_len, cfg.d_model,
                                    generator=generator, device=dev)
    if cfg.mrope:
        out["positions"] = torch.arange(prompt_len, device=dev).expand(
            3, batch, prompt_len)
    return out


def prefill(model, inputs: dict, max_len: int | None = None):
    """``model.prefill`` on :func:`prompt_inputs`' dict."""
    extra = {k: inputs[k] for k in ("embeds", "positions") if k in inputs}
    return model.prefill(inputs["tokens"], max_len, **extra)


def decode_step(model, cache, tokens, pos: int):
    """``model.decode_step`` on ``tokens`` (B, 1) at ``pos``, with the
    (3, B, 1) M-RoPE positions ``pos`` where the model uses them."""
    if not model.cfg.mrope:
        return model.decode_step(cache, tokens, pos)
    mrope = torch.full((3, tokens.shape[0], 1), pos, device=tokens.device)
    return model.decode_step(cache, tokens, pos, mrope)


def generate(model, inputs: dict, gen_tokens: int) -> dict:
    """Prefill ``inputs`` (:func:`prompt_inputs`), then ``gen_tokens``
    greedy tokens, the first from the prefill's logits.  Returns what
    :func:`serve` returns."""
    dev = model.top.embed.device
    batch, prompt_len = inputs["tokens"].shape

    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = prefill(model, inputs, max_len=prompt_len + gen_tokens)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tokens = torch.argmax(logits, -1)[:, None]
    outs = [tokens]
    t0 = time.perf_counter()
    for i in range(gen_tokens - 1):
        step_logits, cache = decode_step(model, cache, tokens, prompt_len + i)
        tokens = torch.argmax(step_logits, -1)[:, None]
        outs.append(tokens)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {
        "generated": torch.cat(outs, dim=1).cpu().numpy(),
        "prefill_logits": logits,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen_tokens - 1) / max(t_decode, 1e-9),
    }


def serve(
    arch: str,
    smoke: bool = True,
    batch: int = 4,
    prompt_len: int = 64,
    gen_tokens: int = 32,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Prefill + greedy decode of ``arch``.  Returns the generated tokens
    (numpy, (batch, gen_tokens)), the prefill's last-position logits
    (on ``device``), ``prefill_s``, ``decode_s`` and ``decode_tok_per_s``
    (host clock around work that ends in a device synchronise)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_shrink(cfg)
    model = build_model(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return generate(model, prompt_inputs(cfg, batch, prompt_len, gen),
                    gen_tokens)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: its smoke shrink)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    r = serve(args.arch, smoke=not args.full, batch=args.batch,
              prompt_len=args.prompt_len, gen_tokens=args.gen,
              seed=args.seed, device=args.device)
    print(json.dumps({
        "arch": args.arch, "full": args.full, "device": args.device,
        "prefill_s": r["prefill_s"], "decode_s": r["decode_s"],
        "decode_tok_per_s": r["decode_tok_per_s"],
        "sample": r["generated"][0][:16].tolist(),
    }))


if __name__ == "__main__":
    main()
