"""Mamba-2 SSD intra-chunk work on Hopper (K5), with its plain version.

:func:`ssd_intra_chunk` launches the hand-written CUDA kernel of
``csrc/mamba2_ssd.cu``, which replaces the reference's Pallas kernel
``ssd_intra_chunk`` (``_ssd_chunk_kernel``, ``src/repro/kernels/
mamba2_ssd.py``).  Per (bh, chunk) cell of length L:

    L_mat[i,j] = exp(cum_a[i] - cum_a[j]) if i >= j else 0
    y_intra    = ((C Bᵀ) ⊙ L_mat) · (dt ⊙ X)
    state      = Σ_j exp(cum_a[L-1] - cum_a[j]) B_jᵀ (dt_j X_j)

The decay matrix is masked with a select (``torch.where`` here, a
select in the kernel), never by multiplying with a 0/1 mask: above the
diagonal the exponent is positive, and an overflow times 0 is NaN.

B and C take a leading group axis ``G`` that divides ``BH``; cell ``bh``
reads group ``bh // (BH // G)``.  The model's B/C are head-free
(ngroups = 1), so it passes one group per batch row and no per-head copy
is made; with ``G == BH`` this is the reference kernel's function.

Two kernels, chosen by shape (:func:`ssd_route`; a dispatch rule, not a
fallback: a failed launch raises).  The model's shapes (L = 64, D a
multiple of 64, S = 64 or 128) take ``ssd_chunk_wgmma_kernel``, 3xTF32
on ``wgmma`` fed by TMA, one block per (group, chunk, block of
:func:`heads_per_block` heads of the group), so C·Bᵀ and the B/C splits
are made once per (group, chunk) and shared by the block's heads; every
other shape takes the FFMA kernel ``ssd_chunk_kernel`` ("simt").
:data:`SSD_ROUTES` counts launches by route; ``route=`` forces one (for
the tests and the smoke, which time both at the serve shape).

:func:`ssd_intra_chunk_plain` is the same function in PyTorch.  The
wrapper uses it only for CPU tensors; for CUDA tensors it launches a
kernel or raises.  :data:`LAUNCHES` counts kernel launches.  What bounds
the kernels on the H100 is noted at the top of the CUDA source.
"""

from __future__ import annotations

import torch

from .build import check, cuda_stream, load_library, on_cpu

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use

LAUNCHES = {"ssd_chunk": 0}
SSD_ROUTES = {"wgmma": 0, "simt": 0}


def reset_launches() -> None:
    LAUNCHES["ssd_chunk"] = 0
    for route in SSD_ROUTES:
        SSD_ROUTES[route] = 0


def ssd_route(L: int, D: int, S: int) -> str:
    """The kernel a (chunk L, head dim D, state S) cell takes: ``wgmma``
    for L = 64, D a positive multiple of 64 and S = 64 or 128 (one 64-row
    wgmma tile of chunk, 64-wide head-dim tiles, at most two of state),
    else ``simt``."""
    if L == 64 and D > 0 and D % 64 == 0 and S in (64, 128):
        return "wgmma"
    return "simt"


def heads_per_block(heads: int, chunks: int, sms: int) -> int:
    """Heads of one B/C group a wgmma block takes, for ``chunks``
    (group, chunk) pairs of ``heads`` heads each: as few as keep the grid
    within one wave of ``sms`` blocks, so C·Bᵀ is made as few times as
    the wave allows (every head of a group in one block when the pairs
    alone fill a wave)."""
    blocks_per_pair = max(1, min(heads, sms // max(chunks, 1)))
    return -(-heads // blocks_per_pair)


def _check(x, dt, a, b, c) -> int:
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"x {tuple(x.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}: want (BH,C,L,D), (G,C,L,S)")
    BH, C, L, _ = x.shape
    if dt.shape != (BH, C, L) or a.shape != (BH, C, L):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)} != "
                         f"{(BH, C, L)}")
    G = b.shape[0]
    if b.shape[1:3] != (C, L) or G == 0 or BH % G:
        raise ValueError(f"b {tuple(b.shape)} does not match x "
                         f"{tuple(x.shape)}")
    for t in (x, dt, a, b, c):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_intra_chunk takes float32, got {t.dtype}")
    return BH // G


def ssd_intra_chunk_plain(x, dt, a, b, c):
    """Plain version of K5: the cell's three products in fp32."""
    hpg = _check(x, dt, a, b, c)
    L = x.shape[2]
    b = b.repeat_interleave(hpg, dim=0)
    c = c.repeat_interleave(hpg, dim=0)
    cum = torch.cumsum(a, dim=-1)  # (BH, C, L)
    diff = cum[..., :, None] - cum[..., None, :]
    lower = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    l_mat = torch.where(lower, torch.exp(diff), torch.zeros((), device=x.device))
    scores = (c @ b.transpose(-1, -2)) * l_mat
    xdt = x * dt[..., None]
    y = scores @ xdt
    decay_end = torch.exp(cum[..., -1:] - cum)
    st = (b * decay_end[..., None]).transpose(-1, -2) @ xdt
    return y, st


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (TMA and bulk copies
    need it; a fresh allocation is)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_intra_chunk(x, dt, a, b, c, *, route: str | None = None):
    """K5: x (BH, C, L, D), dt and a (BH, C, L), b and c (G, C, L, S), all
    fp32.  Returns (y_intra (BH, C, L, D), chunk_states (BH, C, S, D)),
    fp32.  ``route`` (``"wgmma"`` or ``"simt"``) overrides
    :func:`ssd_route`; ``"wgmma"`` on a shape it does not take raises."""
    hpg = _check(x, dt, a, b, c)
    BH, C, L, D = x.shape
    S = b.shape[-1]
    if route is None:
        route = ssd_route(L, D, S)
    elif route not in SSD_ROUTES:
        raise ValueError(f"route {route!r}: want one of {sorted(SSD_ROUTES)}")
    elif route == "wgmma" and ssd_route(L, D, S) != "wgmma":
        raise ValueError(f"the wgmma kernel takes L = 64, D % 64 == 0 and "
                         f"S in (64, 128), not L {L}, D {D}, S {S}")
    if on_cpu(x, dt, a, b, c):
        return ssd_intra_chunk_plain(x, dt, a, b, c)
    x, dt, a, b, c = (_aligned(t) for t in (x, dt, a, b, c))
    y = torch.empty((BH, C, L, D), dtype=torch.float32, device=x.device)
    st = torch.empty((BH, C, S, D), dtype=torch.float32, device=x.device)
    if BH * C == 0:
        return y, st
    lib = load_library("mamba2_ssd")
    ptrs = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), st.data_ptr())
    stream = cuda_stream(x.device)
    if route == "wgmma":
        G = b.shape[0]
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        rc = lib.repro_ssd_chunk_wgmma(
            *ptrs, BH, C, L, D, S, G, heads_per_block(hpg, G * C, sms), stream)
    else:
        smem = lib.repro_ssd_chunk_smem(L, D, S)
        if smem > SMEM_LIMIT:
            raise ValueError(f"chunk {L}, head dim {D}, state {S} need {smem} "
                             f"bytes of shared memory > {SMEM_LIMIT}")
        rc = lib.repro_ssd_chunk(*ptrs, BH * C, C, L, D, S, hpg, stream)
    check(lib, rc, f"ssd_intra_chunk ({route})")
    LAUNCHES["ssd_chunk"] += 1
    SSD_ROUTES[route] += 1
    return y, st
