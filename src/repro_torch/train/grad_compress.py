"""Gradient compression for the all-reduce across hosts.

Counterpart of the reference's ``train/grad_compress.py``: int8
quantization with error feedback.  Each worker keeps the quantization
residual and adds it back before the next round, so the compressed sum
is unbiased over time (EF-SGD).  :func:`compressed_all_reduce` is the
twin of the reference's ``compressed_psum`` on ``torch.distributed``
(``gloo`` for CPU tensors, ``nccl`` for CUDA ones): each rank's
dequantized contribution goes on the wire as bf16 (half of fp32) and is
summed there; the sum comes back as fp32.  The reference also takes the
maximum of the ranks' scales and drops it (its docstring says the sum is
de-scaled by it; its code does not): the port returns the same values
and skips that collective.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..tree import leaves, tree_map, with_leaves

F32 = torch.float32


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_with_feedback(grads: Any, residuals: Any):
    """Returns (quantized, scales, new_residuals), each in ``grads``'
    structure."""
    qs, ss, rs = [], [], []
    for g, r in zip(leaves(grads), leaves(residuals)):
        g = g.to(F32) + r
        q, s = quantize(g)
        qs.append(q)
        ss.append(s)
        rs.append(g - dequantize(q, s))
    return (with_leaves(grads, qs), with_leaves(grads, ss),
            with_leaves(grads, rs))


def init_residuals(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32, device=g.device),
                    grads)


def compressed_all_reduce(grads: Any, residuals: Any, group=None):
    """All-reduce ``grads`` over ``group`` (default: the world) in int8
    with error feedback: returns (the sum over ranks of each rank's
    dequantized contribution, summed as bf16, in fp32; this rank's new
    residuals)."""
    q, s, r2 = compress_with_feedback(grads, residuals)
    summed = []
    for qq, sc in zip(leaves(q), leaves(s)):
        contrib = dequantize(qq, sc).to(torch.bfloat16)
        dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=group)
        summed.append(contrib.to(F32))
    return with_leaves(grads, summed), r2
