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

Training (the reference differentiates its jnp chunked SSD; its Pallas
kernel has no backward): :func:`ssd_intra_chunk_bwd` routes by the same
shape rule.  The wgmma shapes take ``ssd_chunk_bwd_wgmma_kernel``
(3xTF32 ``wgmma``, the forward's blocks: one per (group, chunk,
:func:`heads_per_block` heads), B split once per block, gB and gC
summed over the block's heads in registers, one share a block, the
shares summed in block order); every other shape takes
``ssd_chunk_bwd_kernel`` (FFMA, one block per cell, each head's share of
gB and gC summed in head order).  No atomics.  :data:`SSD_BWD_ROUTES`
counts launches by route, ``route=`` forces one, and
:func:`bwd_workspace` is the shares' scratch each route allocates.
:class:`SSDIntraChunkFn` is the autograd function over the forward
(either route) and this backward; on CPU tensors it runs
:func:`ssd_intra_chunk_plain` and :func:`ssd_intra_chunk_bwd_plain` (the
explicit formulas).  Both plain
versions take the decay's ``exp`` only of selected entries, so strong
decays give finite gradients, and take float64 for ``gradcheck``.
"""

from __future__ import annotations

import math

import torch

from .build import check, cuda_stream, load_library, on_cpu

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use

LAUNCHES = {"ssd_chunk": 0, "ssd_chunk_bwd": 0}
SSD_ROUTES = {"wgmma": 0, "simt": 0}
SSD_BWD_ROUTES = {"wgmma": 0, "simt": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in (SSD_ROUTES, SSD_BWD_ROUTES):
        for route in routes:
            routes[route] = 0


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


def _pick_route(route: str | None, L: int, D: int, S: int) -> str:
    """``route``, or :func:`ssd_route`'s when None; a route outside
    ("wgmma", "simt"), or "wgmma" on a shape it does not take, raises."""
    if route is None:
        return ssd_route(L, D, S)
    if route not in SSD_ROUTES:
        raise ValueError(f"route {route!r}: want one of {sorted(SSD_ROUTES)}")
    if route == "wgmma" and ssd_route(L, D, S) != "wgmma":
        raise ValueError(f"the wgmma kernels take L = 64, D % 64 == 0 and "
                         f"S in (64, 128), not L {L}, D {D}, S {S}")
    return route


def bwd_workspace(route: str, BH: int, G: int, C: int, L: int, S: int,
                  hb: int = 1) -> dict:
    """The fp32 scratch the backward's ``route`` allocates, name -> shape:
    the shares of gB and gC that are summed into them.  ``simt``: one per
    head (BH, C, L, S), none with one head a group; ``wgmma``: one per
    block of ``hb`` heads (G·C, blocks a group, L, S), none with one block
    a group."""
    hpg = BH // G
    if route == "simt":
        shape = (BH, C, L, S) if hpg > 1 else None
    elif route == "wgmma":
        nhb = -(-hpg // hb)
        shape = (G * C, nhb, L, S) if nhb > 1 else None
    else:
        raise ValueError(f"route {route!r}: want one of {sorted(SSD_BWD_ROUTES)}")
    return {} if shape is None else {"gb_part": shape, "gc_part": shape}


def _check(x, dt, a, b, c, plain: bool = False) -> int:
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
    types = (torch.float32, torch.float64) if plain else (torch.float32,)
    if len({t.dtype for t in (x, dt, a, b, c)}) != 1 or x.dtype not in types:
        raise TypeError(f"ssd_intra_chunk takes float32, got "
                        f"{sorted({str(t.dtype) for t in (x, dt, a, b, c)})}")
    return BH // G


def _decay(a):
    """(lmat, w) of a cell, from cum, the in-chunk cumsum of the log
    decays: the decay matrix exp(cum_i − cum_j) on and below the diagonal
    and 0 above it (exp of a selected −inf, never a product with a mask:
    above the diagonal the exponent may overflow), and the end-state
    weights exp(cum_{L−1} − cum_j)."""
    L = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    lower = torch.ones(L, L, dtype=torch.bool, device=a.device).tril()
    l_mat = torch.exp(torch.where(lower, diff, -math.inf))
    return l_mat, torch.exp(cum[..., -1:] - cum)


def ssd_intra_chunk_plain(x, dt, a, b, c):
    """Plain version of K5: the cell's three products in fp32."""
    hpg = _check(x, dt, a, b, c, plain=True)
    b = b.repeat_interleave(hpg, dim=0)
    c = c.repeat_interleave(hpg, dim=0)
    l_mat, decay_end = _decay(a)
    scores = (c @ b.transpose(-1, -2)) * l_mat
    xdt = x * dt[..., None]
    y = scores @ xdt
    st = (b * decay_end[..., None]).transpose(-1, -2) @ xdt
    return y, st


def ssd_intra_chunk_bwd_plain(x, dt, a, b, c, gy, gst):
    """Plain version of K5's backward, the explicit formulas: with
    Xd = dt ⊙ X, M = (C Bᵀ) ⊙ Lmat and w the end-state weights,
    gXd = Mᵀ gy + w ⊙ (B gst), gM = gy Xdᵀ, G = gM ⊙ Lmat, gC = G B,
    gB = Gᵀ C + w ⊙ (Xd gstᵀ), gcum from gM ⊙ M (row minus column) and
    from w, ga its reverse cumsum, gdt = rowsum(gXd ⊙ X), gx = gXd ⊙ dt.
    gb and gc are summed over each group's heads.  Returns
    (gx, gdt, ga, gb, gc)."""
    hpg = _check(x, dt, a, b, c, plain=True)
    G, C, L, S = b.shape
    br = b.repeat_interleave(hpg, dim=0)
    cr = c.repeat_interleave(hpg, dim=0)
    l_mat, w = _decay(a)
    m = (cr @ br.transpose(-1, -2)) * l_mat
    xd = x * dt[..., None]
    bg = br @ gst  # (BH, C, L, D): B gst
    gxd = m.transpose(-1, -2) @ gy + w[..., None] * bg
    gm = gy @ xd.transpose(-1, -2)
    g = gm * l_mat
    gc = g @ br
    gb = g.transpose(-1, -2) @ cr + w[..., None] * (xd @ gst.transpose(-1, -2))
    gw = (xd * bg).sum(-1)
    q = gm * m
    end = torch.zeros_like(a)
    end[..., -1] = (gw * w).sum(-1)
    gcum = q.sum(-1) - q.sum(-2) - gw * w + end
    ga = torch.flip(torch.cumsum(torch.flip(gcum, (-1,)), -1), (-1,))
    gdt = (gxd * x).sum(-1)
    gx = gxd * dt[..., None]
    gb = gb.reshape(G, hpg, C, L, S).sum(1)
    gc = gc.reshape(G, hpg, C, L, S).sum(1)
    return gx, gdt, ga, gb, gc


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (TMA and bulk copies
    need it; a fresh allocation is)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_intra_chunk(x, dt, a, b, c, *, route: str | None = None):
    """K5: x (BH, C, L, D), dt and a (BH, C, L), b and c (G, C, L, S), all
    fp32.  Returns (y_intra (BH, C, L, D), chunk_states (BH, C, S, D)),
    fp32.  ``route`` (``"wgmma"`` or ``"simt"``) overrides
    :func:`ssd_route`; ``"wgmma"`` on a shape it does not take raises.
    On the CPU the plain version also takes fp64."""
    hpg = _check(x, dt, a, b, c, plain=on_cpu(x, dt, a, b, c))
    BH, C, L, D = x.shape
    S = b.shape[-1]
    route = _pick_route(route, L, D, S)
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


def ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst, *, route: str | None = None):
    """K5's backward: from the forward's inputs and the gradients of its
    outputs, gy (BH, C, L, D) and gst (BH, C, S, D), returns (gx, gdt,
    ga, gb, gc) shaped as (x, dt, a, b, c), fp32.  ``route`` as in
    :func:`ssd_intra_chunk`."""
    hpg = _check(x, dt, a, b, c, plain=on_cpu(x, dt, a, b, c))
    BH, C, L, D = x.shape
    G, S = b.shape[0], b.shape[-1]
    if gy.shape != x.shape or gst.shape != (BH, C, S, D):
        raise ValueError(f"gy {tuple(gy.shape)}, gst {tuple(gst.shape)} do "
                         f"not match x {tuple(x.shape)}, state size {S}")
    route = _pick_route(route, L, D, S)
    gy, gst = gy.to(x.dtype), gst.to(x.dtype)
    if on_cpu(x, dt, a, b, c, gy, gst):
        return ssd_intra_chunk_bwd_plain(x, dt, a, b, c, gy, gst)
    x, dt, a, b, c, gy, gst = (_aligned(t) for t in (x, dt, a, b, c, gy, gst))
    gx = torch.empty_like(x)
    gdt, ga = torch.empty_like(dt), torch.empty_like(a)
    gb, gc = torch.empty_like(b), torch.empty_like(c)
    if BH * C == 0:
        return gx, gdt, ga, gb.zero_(), gc.zero_()
    lib = load_library("mamba2_ssd")
    if route == "wgmma":
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        hb = heads_per_block(hpg, G * C, sms)
    else:
        hb = 1
        smem = lib.repro_ssd_chunk_bwd_smem(L, D, S)
        if smem > SMEM_LIMIT:
            raise ValueError(f"chunk {L}, head dim {D}, state {S}: the "
                             f"backward needs {smem} bytes of shared memory "
                             f"> {SMEM_LIMIT}")
    work = {name: torch.empty(shape, dtype=torch.float32, device=x.device)
            for name, shape in bwd_workspace(route, BH, G, C, L, S, hb).items()}
    gb_part, gc_part = work.get("gb_part", gb), work.get("gc_part", gc)
    ptrs = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), gy.data_ptr(), gst.data_ptr(), gx.data_ptr(),
            gdt.data_ptr(), ga.data_ptr())
    if route == "wgmma":
        rc = lib.repro_ssd_chunk_bwd_wgmma(
            *ptrs, gb.data_ptr(), gc.data_ptr(), gb_part.data_ptr(),
            gc_part.data_ptr(), BH, C, L, D, S, G, hb, cuda_stream(x.device))
    else:
        rc = lib.repro_ssd_chunk_bwd(
            *ptrs, gb_part.data_ptr(), gc_part.data_ptr(), gb.data_ptr(),
            gc.data_ptr(), BH * C, C, L, D, S, hpg, cuda_stream(x.device))
    check(lib, rc, f"ssd_intra_chunk_bwd ({route})")
    LAUNCHES["ssd_chunk_bwd"] += 1
    SSD_BWD_ROUTES[route] += 1
    return gx, gdt, ga, gb, gc


class SSDIntraChunkFn(torch.autograd.Function):
    """K5 under autograd: the forward kernel (``route`` as in
    :func:`ssd_intra_chunk`) and the backward kernels (routed by their
    rule; plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, route=None):
        y, st = ssd_intra_chunk(x, dt, a, b, c, route=route)
        ctx.save_for_backward(x, dt, a, b, c)
        return y, st

    @staticmethod
    def backward(ctx, gy, gst):
        return (*ssd_intra_chunk_bwd(*ctx.saved_tensors, gy, gst), None)
