"""Wrappers around the contraction kernels, as the lowering layer calls them.

They handle the parts around the kernels: the complex 3-real-GEMM
Karatsuba of :func:`matmul` (25% fewer real FLOPs than the naive 4-GEMM
form), the library-matmul fallback below the kernels' tile size, and the
complex split into separate fp32 re/im planes — once per call at the
kernel boundary, never interleaved.  The tiled kernel masks its ragged
edge itself, so unlike the reference's ``ops.matmul`` nothing is padded.
"""

from __future__ import annotations

import torch

from ..hardware import DEFAULT_HARDWARE
from . import ref
from .contract_gemm import chain_gemm, fused_gemm, tiled_gemm


def _planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Separate contiguous fp32 (re, im) planes of ``x``."""
    if x.is_complex():
        return x.real.float().contiguous(), x.imag.float().contiguous()
    return x.float().contiguous(), torch.zeros_like(x, dtype=torch.float32)


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    min_kernel_dim: int = DEFAULT_HARDWARE.tile,
) -> torch.Tensor:
    """(Batched) GEMM through the tiled kernel, with complex support.

    ``a`` is (M, K) or (B, M, K), ``b`` (K, N) or (B, K, N).  Falls back
    to the library's matmul for shapes under ``min_kernel_dim`` where the
    64-wide output tile would be mostly idle (the paper's Sec. V-A
    pathology)."""
    if a.is_complex() or b.is_complex():
        return _complex_matmul(a, b, min_kernel_dim=min_kernel_dim)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if min(m, n, k) < min_kernel_dim:
        return ref.matmul_ref(a, b)
    if a.dim() == 2:
        return tiled_gemm(a[None].float(), b[None].float())[0]
    return tiled_gemm(a.float(), b.float())


def _complex_matmul(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """Karatsuba: 3 real GEMMs instead of 4.

    P1 = Ar·Br, P2 = Ai·Bi, P3 = (Ar+Ai)·(Br+Bi)
    C  = (P1 − P2) + i·(P3 − P1 − P2)
    """
    ar, ai = _planes(a)
    br, bi = _planes(b)
    p1 = matmul(ar, br, **kw)
    p2 = matmul(ai, bi, **kw)
    p3 = matmul(ar + ai, br + bi, **kw)
    return torch.complex(p1 - p2, p3 - p1 - p2)


def fused_matmul(a: torch.Tensor, b: torch.Tensor, form) -> torch.Tensor:
    """One contraction step ``form`` through the fused kernel, operands in
    their tree-native layouts, output in ``inds_out`` order.  Complex
    operands are split into planes here and the kernel runs the
    Karatsuba products in one pass."""
    if a.is_complex() or b.is_complex():
        re, im = fused_gemm(_planes(a), _planes(b), form)
        return torch.complex(re, im)
    return fused_gemm((a.float(),), (b.float(),), form)[0]


def fused_chain(operands, *, forms, carry_side, slot_ids, slot_elems):
    """Execute a fused GEMM chain (see :class:`repro_torch.lowering.
    refiner.FusedChainSpec`) as one chain-kernel call, with complex
    support.  Complex operands are split into fp32 ``(re, im)`` planes
    here, once, at the chain boundary — the carry stays split through
    every step (per-step Karatsuba)."""
    complex_mode = any(o.is_complex() for o in operands)
    comps = []
    for o in operands:
        if complex_mode:
            comps.extend(_planes(o))
        else:
            comps.append(o.float().contiguous())
    out = chain_gemm(
        comps, tuple(forms), tuple(carry_side), tuple(slot_ids),
        tuple(slot_elems), complex_mode=complex_mode,
    )
    if complex_mode:
        return torch.complex(*out)
    return out[0]
