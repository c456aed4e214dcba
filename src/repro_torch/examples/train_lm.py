"""End-to-end training: a ~100M-parameter llama3-family model for a few
hundred steps through the production loop (resumable synthetic data,
async checkpoints, straggler watchdog, auto-resume).  The port's twin of
``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 \\
        [--ckpt-dir DIR] [--device {cuda,cpu}]

The model is llama3.2-3b's family cut to 6 layers of width 512 (8 query
and 4 kv heads of 64, d_ff 1536, vocabulary 32000, tied embeddings),
registered as ``llama3-100m`` as the reference registers it.  It asserts
that the last loss is below the first.
"""

from __future__ import annotations

import argparse
import dataclasses

from .. import configs
from ..configs import ArchConfig, get_config
from ..launch.train import train

NAME = "llama3-100m"


def llama3_100m() -> ArchConfig:
    """~100M-parameter llama3-family config (the reference example's)."""
    return dataclasses.replace(
        get_config("llama3.2-3b"),
        name=NAME,
        num_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        head_dim=64,
        d_ff=1536,
        vocab_size=32000,
        tie_embeddings=True,
    )


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: none)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # register it so the launcher can find it
    configs.ARCHS[NAME] = llama3_100m()
    losses = train(
        NAME,
        steps=args.steps,
        smoke=False,
        global_batch=4,
        seq_len=128,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=100,
        lr=3e-3,
        device=args.device,
    )
    print(f"loss: {losses[0]:.3f} → {losses[-1]:.3f} over {args.steps} steps")
    assert losses[-1] < losses[0], "training did not reduce the loss"
    return losses


if __name__ == "__main__":
    main()
