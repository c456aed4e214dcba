"""Wrappers around the kernels, as the lowering layer and the models call
them.

For the contraction kernels they handle the parts around the kernels:
the library-matmul fallback below the kernels' tile size, a real operand
beside a complex one (cast to complex64), and the precision of the step.
Every contraction kernel reads complex64 in place as (re, im) pairs and
computes a complex product in the direct form, so :func:`matmul`,
:func:`tiled_step`, :func:`fused_matmul` and :func:`fused_chain` each
make one kernel launch and no plane copies.  ``precision="bf16"`` runs
the kernels' bf16 routes (operands rounded to bf16 at the kernel's
loads, fp32 accumulation); ``out16`` asks for the output at half width,
as bf16 (re, im) pairs (:func:`repro_torch.kernels.ref.to_pairs16`),
which is how the executor stores a node every consumer of which reads
bf16.  Half-width operands are taken as they are.

For the LM side, :func:`attention` puts (b, s, h, d) heads into the flash
kernel's (b·h, s, d) layout with the reference's dispatch rule, and
:func:`ssd_scan` runs the SSD intra-chunk kernel and the inter-chunk
state recurrence.  Both are differentiable: the kernels run through
:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn` and
:class:`~repro_torch.kernels.mamba2_ssd.SSDIntraChunkFn`, whose backward
passes are kernels too (without autograd they launch the forward
kernels alone, and attention writes no logsumexp); the ragged
shapes' plain references and the inter-chunk recurrence are plain
PyTorch under autograd, as the reference runs them in jnp.
"""

from __future__ import annotations

import torch

from ..hardware import DEFAULT_HARDWARE
from . import ref
from .contract_gemm import (
    _external_shape,
    chain_gemm_c64,
    fused_gemm_c64,
    operand_kind,
    tiled_gemm,
    tiled_gemm_step,
)
from .flash_attention import FlashAttentionFn
from .mamba2_ssd import SSDIntraChunkFn
from .ref import to_pairs16, widen

_DISPATCH_TILE = 128  # the reference's dispatch rule for attention


def _as_complex(xs, shapes):
    """The operands, a real full-width one cast to complex64 when another
    is complex (a half-width real operand beside a complex one is
    widened first)."""
    kinds = [operand_kind(x, s) for x, s in zip(xs, shapes)]
    if not any(c for c, _ in kinds) or all(c for c, _ in kinds):
        return list(xs)
    return [x if c else widen(x, s).to(torch.complex64)
            for x, s, (c, _) in zip(xs, shapes, kinds)]


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    min_kernel_dim: int = DEFAULT_HARDWARE.tile,
    precision: str = "fp32",
    out16: bool = False,
) -> torch.Tensor:
    """(Batched) GEMM through the tiled kernel (K1), complex in place.

    ``a`` is (M, K) or (B, M, K), ``b`` (K, N) or (B, K, N); half-width
    operands come batched (bf16 (B, M, K), or bf16 pairs (B, M, K, 2)).
    Falls back to the library's fp32 matmul for shapes under
    ``min_kernel_dim`` where the kernel's output tile would be mostly
    idle (the paper's Sec. V-A pathology)."""
    squeeze = a.dim() == 2 and a.dtype != torch.bfloat16
    if squeeze:
        a, b = a[None], b[None]
    Bt, M, K = a.shape[:3]
    N = b.shape[2]
    a, b = _as_complex((a, b), ((Bt, M, K), (Bt, K, N)))
    if min(M, N, K) < min_kernel_dim:
        x, y = widen(a, (Bt, M, K)), widen(b, (Bt, K, N))
        if precision == "bf16":
            x, y = ref.round16(x), ref.round16(y)
        out = torch.matmul(x, y) if x.is_complex() else ref.matmul_ref(x, y)
        out = to_pairs16(out) if out16 else out
    else:
        out = tiled_gemm(a, b, precision=precision, out16=out16)
    return out[0] if squeeze else out


def tiled_step(a: torch.Tensor, b: torch.Tensor, form, *,
               precision: str = "fp32", out16: bool = False) -> torch.Tensor:
    """One ``tiled`` contraction step ``form`` through the tiled kernel,
    read in place in the operands' native layouts (no copies in GEMM
    order), output in ``inds_out`` order; a real operand beside a
    complex one is cast first."""
    a, b = _as_complex((a, b), (form.a_shape, form.b_shape))
    return tiled_gemm_step(a, b, form, precision=precision, out16=out16)


def fused_matmul(a: torch.Tensor, b: torch.Tensor, form, *,
                 precision: str = "fp32", out16: bool = False) -> torch.Tensor:
    """One contraction step ``form`` through the fused kernel, operands in
    their tree-native layouts, output in ``inds_out`` order: complex in
    place (one launch; a real operand beside a complex one is cast
    first), or real."""
    a, b = _as_complex((a, b), (form.a_shape, form.b_shape))
    return fused_gemm_c64(a, b, form, precision=precision, out16=out16)


def fused_chain(operands, *, forms, carry_side, slot_ids, slot_elems,
                precisions=None, slot_prec=(), out16: bool = False):
    """Execute a fused GEMM chain (see :class:`repro_torch.lowering.
    refiner.FusedChainSpec`) as one chain-kernel call: complex externals
    in place (one launch), or real.  ``precisions[t]`` is step ``t``'s
    input precision; ``slot_prec`` says which workspace slots hold their
    carries as bf16."""
    shapes = [_external_shape(forms, carry_side, i) for i in range(len(operands))]
    return chain_gemm_c64(
        _as_complex(operands, shapes), tuple(forms), tuple(carry_side),
        tuple(slot_ids), tuple(slot_elems), precisions=precisions,
        slot_prec=tuple(slot_prec), out16=out16,
    )


def attention(
    q: torch.Tensor,  # (batch, seq_q, n_heads, d)
    k: torch.Tensor,  # (batch, seq_k, n_kv, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
) -> torch.Tensor:
    """Multi-head attention with GQA, (b, s, h, d) layout, with the
    sliding ``window`` where it is > 0.

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
            causal=causal, q_offset=q_offset, window=window,
        )
    else:
        o = FlashAttentionFn.apply(qf, kf, vf, causal, q_offset, window)
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
    Returns (y (BH, T, D) fp32, final_state (BH, S, D) fp32; fp64 for
    fp64 inputs on the CPU)."""
    BH, T, D = x.shape
    G, S = b.shape[0], b.shape[-1]
    hpg = BH // G
    if T % chunk:
        return ref.ssd_scan_ref(
            x, dt, a, b.repeat_interleave(hpg, dim=0),
            c.repeat_interleave(hpg, dim=0), state0,
        )
    C = T // chunk
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    xr = x.to(work).reshape(BH, C, chunk, D)
    dtr = dt.to(work).reshape(BH, C, chunk)
    ar = a.to(work).reshape(BH, C, chunk)
    br = b.to(work).reshape(G, C, chunk, S)
    cr = c.to(work).reshape(G, C, chunk, S)
    y_intra, chunk_states = SSDIntraChunkFn.apply(xr, dtr, ar, br, cr)
    cum_a = torch.cumsum(ar, dim=2)  # (BH, C, L)
    chunk_decay = torch.exp(cum_a[:, :, -1])  # (BH, C) total decay of chunk
    h = (
        torch.zeros((BH, S, D), dtype=work, device=x.device)
        if state0 is None else state0.to(work)
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
