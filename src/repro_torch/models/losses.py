"""Losses — chunked vocabulary cross-entropy.

Counterpart of the reference's ``models/losses.py``.  The full logits
tensor (B·S·V) of a 100k+ vocabulary at long sequences would not fit, so
the loss runs over sequence chunks, each chunk's logits and logsumexp
under :func:`torch.utils.checkpoint.checkpoint` (the reference's
``jax.checkpoint``): the backward recomputes them, and a chunk's logits
live for one chunk only.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

F32 = torch.float32


def _chunk_loss(h_c: torch.Tensor, head_w: torch.Tensor,
                l_c: torch.Tensor) -> torch.Tensor:
    logits = h_c @ head_w
    logits = logits.to(torch.promote_types(logits.dtype, F32))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, l_c[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_cross_entropy(
    hidden: torch.Tensor,  # (B, S, D)
    head_w: torch.Tensor,  # (D, V)
    labels: torch.Tensor,  # (B, S) int
    chunk: int = 512,
) -> torch.Tensor:
    """Mean token cross-entropy, fp32 (fp64 for fp64 inputs): the chunks' sums of
    ``logsumexp − gold logit`` added in order, over ``B·S``."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    labels = labels.long()
    total = torch.zeros((), dtype=torch.promote_types(hidden.dtype, F32),
                        device=hidden.device)
    for s0 in range(0, S, chunk):
        total = total + checkpoint(
            _chunk_loss, hidden[:, s0:s0 + chunk], head_w,
            labels[:, s0:s0 + chunk], use_reentrant=False,
        )
    return total / (B * S)
