"""Wrappers around the kernels, as the lowering layer and the models call
them.

For the contraction kernels they handle the parts around the kernels:
the complex 3-real-GEMM Karatsuba of :func:`matmul` (25% fewer real FLOPs
than the naive 4-GEMM form) on separate fp32 re/im planes, and the
library-matmul fallback below the kernels' tile size.  The tiled kernel
masks its ragged edge itself, so unlike the reference's ``ops.matmul``
nothing is padded.  :func:`fused_matmul` and :func:`fused_chain` hand
complex64 tensors to their kernels as they are (the kernels read and
write (re, im) pairs in place): one kernel launch per call, no plane
copies.

For the LM side, :func:`attention` puts (b, s, h, d) heads into the flash
kernel's (b·h, s, d) layout with the reference's dispatch rule, and
:func:`ssd_scan` runs the SSD intra-chunk kernel and the inter-chunk
state recurrence.
"""

from __future__ import annotations

import torch

from ..hardware import DEFAULT_HARDWARE
from . import ref
from .contract_gemm import chain_gemm_c64, fused_gemm_c64, tiled_gemm
from .flash_attention import flash_attention
from .mamba2_ssd import ssd_intra_chunk

_DISPATCH_TILE = 128  # the reference's dispatch rule for attention


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
    kernel's output tile would be mostly idle (the paper's Sec. V-A
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


def _kernel_dtype(*xs: torch.Tensor) -> torch.dtype:
    return torch.complex64 if any(x.is_complex() for x in xs) else torch.float32


def fused_matmul(a: torch.Tensor, b: torch.Tensor, form) -> torch.Tensor:
    """One contraction step ``form`` through the fused kernel, operands in
    their tree-native layouts, output in ``inds_out`` order: complex64
    in place (one launch; a real operand beside a complex one is cast
    first), or fp32."""
    dt = _kernel_dtype(a, b)
    return fused_gemm_c64(a.to(dt), b.to(dt), form)


def fused_chain(operands, *, forms, carry_side, slot_ids, slot_elems):
    """Execute a fused GEMM chain (see :class:`repro_torch.lowering.
    refiner.FusedChainSpec`) as one chain-kernel call: complex64
    externals in place (one launch), or fp32."""
    dt = _kernel_dtype(*operands)
    return chain_gemm_c64(
        [o.to(dt) for o in operands], tuple(forms), tuple(carry_side),
        tuple(slot_ids), tuple(slot_elems),
    )


def attention(
    q: torch.Tensor,  # (batch, seq_q, n_heads, d)
    k: torch.Tensor,  # (batch, seq_k, n_kv, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Multi-head attention with GQA, (b, s, h, d) layout.

    The reference's dispatch rule, with its default tiles of 128: decode
    and ragged shapes (``sq``, ``sk`` or ``q_offset`` not a multiple of
    128, ``d % 8``) take the naive reference,
    which the reference package runs in jnp too; the rest runs the flash
    kernel, whose GQA reads kv head ``h // group`` instead of a
    head-repeated copy."""
    batch, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    group = hq // hkv
    qf = q.transpose(1, 2).reshape(batch * hq, sq, d)
    kf = k.transpose(1, 2).reshape(batch * hkv, sk, d)
    vf = v.transpose(1, 2).reshape(batch * hkv, sk, d)
    t = _DISPATCH_TILE
    if sq % t or sk % t or q_offset % t or d % 8:
        o = ref.attention_ref(
            qf, kf.repeat_interleave(group, dim=0),
            vf.repeat_interleave(group, dim=0),
            causal=causal, q_offset=q_offset,
        )
    else:
        o = flash_attention(qf, kf, vf, causal=causal, q_offset=q_offset)
    return o.reshape(batch, hq, sq, d).transpose(1, 2)


def ssd_scan(
    x: torch.Tensor,  # (BH, T, D)
    dt: torch.Tensor,  # (BH, T)
    a: torch.Tensor,  # (BH, T) per-step log decay
    b: torch.Tensor,  # (G, T, S), G divides BH
    c: torch.Tensor,  # (G, T, S)
    *,
    chunk: int = 64,
    state0: torch.Tensor | None = None,  # (BH, S, D)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: the intra-chunk kernel, then the inter-chunk state
    recurrence in plain PyTorch (O(T/chunk) steps of O(S·D) work; it is
    not a kernel in the reference either).

    ``b``/``c`` carry ``G`` groups, each shared by ``BH // G`` consecutive
    rows of ``x`` (``G == BH`` is the reference's signature; the model
    passes head-free B/C with one group per batch row).  A ``T`` that is
    not a multiple of ``chunk`` takes the sequential reference.
    Returns (y (BH, T, D) fp32, final_state (BH, S, D) fp32)."""
    BH, T, D = x.shape
    G, S = b.shape[0], b.shape[-1]
    hpg = BH // G
    if T % chunk:
        return ref.ssd_scan_ref(
            x, dt, a, b.repeat_interleave(hpg, dim=0),
            c.repeat_interleave(hpg, dim=0), state0,
        )
    C = T // chunk
    xr = x.float().reshape(BH, C, chunk, D)
    dtr = dt.float().reshape(BH, C, chunk)
    ar = a.float().reshape(BH, C, chunk)
    br = b.float().reshape(G, C, chunk, S)
    cr = c.float().reshape(G, C, chunk, S)
    y_intra, chunk_states = ssd_intra_chunk(xr, dtr, ar, br, cr)
    cum_a = torch.cumsum(ar, dim=2)  # (BH, C, L)
    chunk_decay = torch.exp(cum_a[:, :, -1])  # (BH, C) total decay of chunk
    h = (
        torch.zeros((BH, S, D), dtype=torch.float32, device=x.device)
        if state0 is None else state0.float()
    )
    h_ins = []  # the state entering each chunk
    for ci in range(C):
        h_ins.append(h)
        h = chunk_decay[:, ci, None, None] * h + chunk_states[:, ci]
    h_in = torch.stack(h_ins, dim=1).reshape(G, hpg, C, S, D)
    # cross-chunk contribution: y_t += c_t · (decay_to_t · h_in)
    y_cross = torch.einsum("gcls,ghcsd->ghcld", cr, h_in).reshape(
        BH, C, chunk, D
    ) * torch.exp(cum_a)[..., None]
    return (y_intra + y_cross).reshape(BH, T, D), h
