"""Plain PyTorch helpers shared by the kernels' plain versions and the
lowering layer."""

from __future__ import annotations

import math

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 product of the library's matmul (the dot fallback below the
    kernels' tile size)."""
    return torch.matmul(a.float(), b.float())


def permute_reshape(x: torch.Tensor, perm, shape) -> torch.Tensor:
    """``x.permute(perm).reshape(shape)``, with runs of axes that stay
    adjacent under ``perm`` merged first.

    A network tensor has one size-2 axis per index, up to the sliced
    width (28–30 axes), while a CUDA copy kernel takes at most 25 axes.
    Merging the runs here keeps the permuted copy to as many axes as the
    permutation really has breaks."""
    perm = tuple(perm)
    if perm == tuple(range(x.dim())):
        return x.reshape(shape)
    runs: list[list[int]] = []
    for p in perm:
        if runs and p == runs[-1][-1] + 1:
            runs[-1].append(p)
        else:
            runs.append([p])
    order = sorted(range(len(runs)), key=lambda i: runs[i][0])
    merged = [math.prod(x.shape[p] for p in runs[i]) for i in order]
    rank_of = {i: r for r, i in enumerate(order)}
    y = x.reshape(merged).permute([rank_of[i] for i in range(len(runs))])
    return y.reshape(shape)
