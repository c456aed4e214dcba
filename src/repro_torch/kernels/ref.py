"""Plain PyTorch helpers shared by the kernels' plain versions and the
lowering layer."""

from __future__ import annotations

import math

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 product of the library's matmul (the dot fallback below the
    kernels' tile size)."""
    return torch.matmul(a.float(), b.float())


def to_pairs16(x: torch.Tensor) -> torch.Tensor:
    """Half-width storage of ``x``: complex64 as bf16 (re, im) pairs (a
    ``torch.bfloat16`` tensor with a trailing axis of 2), float32 as
    bf16.  Each component is rounded to nearest even."""
    if x.is_complex():
        return torch.view_as_real(x.contiguous()).to(torch.bfloat16)
    return x.to(torch.bfloat16)


def widen(x: torch.Tensor, shape) -> torch.Tensor:
    """The fp32 value of an operand of logical ``shape``: bf16 pairs
    (``shape + (2,)``) as complex64, bf16 as float32, anything else as
    it is."""
    if x.dtype != torch.bfloat16:
        return x
    if tuple(x.shape) == tuple(shape) + (2,):
        return torch.view_as_complex(x.float().contiguous())
    return x.float()


def round16(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every real component rounded to bf16, kept in fp32 (or
    complex64): what a bf16 route reads."""
    if x.is_complex():
        return torch.view_as_complex(
            torch.view_as_real(x.contiguous()).to(torch.bfloat16).float())
    return x.to(torch.bfloat16).float()


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


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
) -> torch.Tensor:
    """q: (bh, sq, d), k/v: (bh, sk, d) — naive softmax attention in fp32
    with scale 1/sqrt(d), ``q.dtype`` out (the reference's
    ``attention_ref``).  ``window > 0`` hides key ``kp`` from query
    ``qp`` unless ``qp - window < kp`` (the reference model's sliding
    window), a select before the softmax like the causal mask."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    sm_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal or window:
        qp = q_offset + torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        ok = qp >= kp if causal else torch.ones_like(qp >= kp)
        if window:
            ok = ok & (kp > qp - window)
        s = torch.where(ok, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    return o.to(q.dtype)


def ssd_scan_ref(
    x: torch.Tensor,  # (BH, T, D)
    dt: torch.Tensor,  # (BH, T)
    a: torch.Tensor,  # (BH, T) per-step log decay
    b: torch.Tensor,  # (BH, T, S)
    c: torch.Tensor,  # (BH, T, S)
    state0: torch.Tensor | None = None,  # (BH, S, D)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential (exact) selective scan, the reference's ``ssd_scan_ref``:

        h_t = exp(a_t) h_{t-1} + b_t (dt_t x_t)ᵀ ;  y_t = c_t h_t

    Returns (y (BH, T, D), h_T (BH, S, D)), fp32."""
    BH, T, D = x.shape
    S = b.shape[-1]
    h = (
        torch.zeros((BH, S, D), dtype=torch.float32, device=x.device)
        if state0 is None else state0.float()
    )
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
    ys = []
    for t in range(T):
        h = torch.exp(a[:, t])[:, None, None] * h + torch.einsum(
            "bs,bd->bsd", b[:, t], x[:, t] * dt[:, t, None]
        )
        ys.append(torch.einsum("bs,bsd->bd", c[:, t], h))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((BH, 0, D))
    return y, h
