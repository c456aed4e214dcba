"""Losses — chunked vocabulary cross-entropy.

Counterpart of the reference's ``models/losses.py``.  The full logits
tensor (B·S·V) of a 100k+ vocabulary at long sequences would not fit, so
the loss runs over sequence chunks, each chunk's logits and logsumexp
under :func:`torch.utils.checkpoint.checkpoint` (the reference's
``jax.checkpoint``): the backward recomputes them, and a chunk's logits
live for one chunk only.

Under the sharded step a head split over "model" makes the loss
vocabulary-parallel (Megatron's): each rank holds its rows' logits of a
chunk, the row maximum and the sum of exponentials are all-reduced over
"model", and the target's logit comes from the rank that owns it
(:class:`_VocabParallelChunk`, whose backward recomputes the chunk's
logits, as the checkpoint does).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel import sharding

F32 = torch.float32


def _chunk_loss(h_c: torch.Tensor, head_w: torch.Tensor,
                l_c: torch.Tensor) -> torch.Tensor:
    logits = h_c @ head_w
    logits = logits.to(torch.promote_types(logits.dtype, F32))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, l_c[..., None])[..., 0]
    return torch.sum(lse - gold)


class _VocabParallelChunk(torch.autograd.Function):
    """One chunk's ``Σ logsumexp − gold logit`` from this rank's vocabulary
    rows ``[v0, v0 + V_local)`` of the head: the row maximum, the sum of
    exponentials and the gold logit all-reduced over ``tp``'s group.  The
    backward recomputes the chunk's logits: ``softmax − one-hot`` on this
    rank's rows, cast to the logits' type as autograd casts the plain
    chunk's gradient."""

    @staticmethod
    def forward(ctx, h_c, head_w, l_c, tp):
        logits = h_c @ head_w
        wide = logits.to(torch.promote_types(logits.dtype, F32))
        v0, n = tp.rank * head_w.shape[1], head_w.shape[1]
        m = wide.amax(-1)
        tp.all_reduce(m, "max")
        se = torch.exp(wide - m[..., None]).sum(-1)
        tp.all_reduce(se)
        local = l_c - v0
        mine = (local >= 0) & (local < n)
        gold = torch.gather(wide, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = torch.where(mine, gold, torch.zeros_like(gold))
        tp.all_reduce(gold)
        lse = m + torch.log(se)
        ctx.save_for_backward(h_c, head_w, lse, local, mine)
        return torch.sum(lse - gold)

    @staticmethod
    def backward(ctx, grad):
        h_c, head_w, lse, local, mine = ctx.saved_tensors
        logits = h_c @ head_w
        wide = logits.to(torch.promote_types(logits.dtype, F32))
        p = torch.exp(wide - lse[..., None])
        p.scatter_add_(-1, local.clamp(0, head_w.shape[1] - 1)[..., None],
                       -mine[..., None].to(p.dtype))
        p = (p * grad).to(logits.dtype)
        dh = p @ head_w.T
        dw = h_c.reshape(-1, h_c.shape[-1]).T @ p.reshape(-1, p.shape[-1])
        return dh, dw, None, None


def chunked_cross_entropy(
    hidden: torch.Tensor,  # (B, S, D)
    head_w: torch.Tensor,  # (D, V), or this rank's (D, V / P) with ``tp``
    labels: torch.Tensor,  # (B, S) int
    chunk: int = 512,
    tp: sharding.TensorParallel | None = None,
) -> torch.Tensor:
    """Mean token cross-entropy, fp32 (fp64 for fp64 inputs): the chunks' sums of
    ``logsumexp − gold logit`` added in order, over ``B·S``.  With ``tp``
    the head is this rank's vocabulary rows (rank ``r`` of ``P`` holding
    ``[r·V/P, (r+1)·V/P)``) and the loss vocabulary-parallel, the same on
    every rank of its group."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    labels = labels.long()
    total = torch.zeros((), dtype=torch.promote_types(hidden.dtype, F32),
                        device=hidden.device)
    if tp is not None:
        hidden = sharding.tp_enter(hidden, tp)
    for s0 in range(0, S, chunk):
        h_c, l_c = hidden[:, s0:s0 + chunk], labels[:, s0:s0 + chunk]
        if tp is None:
            part = checkpoint(_chunk_loss, h_c, head_w, l_c,
                              use_reentrant=False)
        else:
            part = _VocabParallelChunk.apply(h_c, head_w, l_c, tp)
        total = total + part
    return total / (B * S)
