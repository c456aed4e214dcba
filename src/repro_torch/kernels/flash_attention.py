"""Flash attention on Hopper (K4), forward and backward, with plain versions.

:func:`flash_attention` launches a hand-written CUDA kernel of
``csrc/flash_attention.cu``, which replaces the reference's Pallas kernel
``flash_attention`` (``_flash_kernel``, ``src/repro/kernels/
flash_attention.py``): causal or full softmax attention with an online
softmax, fp32 accumulation and ``q.dtype`` out, for bf16 or fp32 inputs.
The kernel is chosen by dtype: bf16 runs on the tensor cores (``wgmma``
fed by TMA; head dims a multiple of 8, for TMA's 16-byte row stride),
fp32 on the CUDA cores (FFMA), because fp32 on tensor cores would be
TF32.  The bf16 kernel differs from the reference's numerics in two
points, both from bf16 tensor cores: the scale multiplies the fp32
scores after the product, and the probabilities enter ``P @ V`` rounded
to bf16; it also takes the exponential as ``2^x`` of log2-domain scores
on the SFU (see the note in the CUDA source).

``window > 0`` adds the reference model's sliding window (its jnp
``blockwise_attention``; the reference's Pallas kernel has none): key
``kp`` is visible to query ``qp`` only if ``qp - window < kp``, a select
before ``exp`` like the causal mask, and both kernels skip the key tiles
wholly before a query block's first visible key.  Both backward routes
take the same window: a dK/dV block walks only the query tiles its
band reaches, a dQ block starts at the forward's first key tile.

GQA is an index, not a copy: ``k``/``v`` may carry fewer heads than ``q``
(``q.shape[0]`` a multiple of ``k.shape[0]``), and query head ``bh``
reads kv head ``bh // group``.  With as many kv heads as query heads this
is the reference kernel's function.  Like the reference kernel it takes
whole tiles only (``sq`` and ``sk`` multiples of 64) and raises on any
other shape, on every device; :func:`repro_torch.kernels.ops.attention`
keeps the reference's dispatch rule and sends ragged shapes to the
reference path.

:func:`flash_attention_plain` is the same function in PyTorch, the same
online softmax over key tiles with the same numerics.  The wrapper uses
it only for CPU tensors; for CUDA tensors it launches the kernel or
raises.  :data:`LAUNCHES` counts kernel launches, :data:`FWD_ROUTES`
the forward's by kernel, :data:`WINDOW_ROUTES` those with a window and
:data:`NONCAUSAL` those without the causal mask.  What bounds the kernel
on the H100 is noted at the top of the CUDA source.

Training (the reference differentiates its jnp attention; its Pallas
kernel has no backward): ``return_lse=True`` also returns each row's
logsumexp of the scaled scores (fp32, (bh, sq)), and
:func:`flash_attention_bwd` launches the backward kernels of the same
source, which recompute P from it: dV = Pᵀ dO, dS = P ⊙ (dO Vᵀ − D) with
D = rowsum(dO ⊙ O), dK = scale · dSᵀ Q, dQ = scale · dS K in a second
pass over the key tiles (no atomics, so the gradients are
deterministic).  Two routes, chosen by dtype (:func:`bwd_route`, a
dispatch rule as the forward's, never a fallback): bf16 takes ``mma``,
every product on the tensor cores (``mma.sync``), one block per (kv
head, 64 keys) walking its group's query heads in order, so dK and dV
stay in registers; fp32 takes ``simt``, the FFMA kernels, where each
query head writes an fp32 share of its kv head's dK and dV and a second
kernel sums a group's shares in head order.  ``route=`` forces one (the
smoke times both on bf16); :func:`bwd_workspace` is the fp32 scratch
each route allocates; :data:`BWD_ROUTES` counts launches by route,
:data:`BWD_WINDOW_ROUTES` and :data:`BWD_NONCAUSAL` the windowed and the
non-causal ones.
:class:`FlashAttentionFn` is the autograd function over the two; on CPU
tensors it runs :func:`flash_attention_plain` and
:func:`flash_attention_bwd_plain` (the explicit formulas, not autograd).
The plain versions also take float64, for ``gradcheck``.
"""

from __future__ import annotations

import math

import torch

from .build import check, cuda_stream, load_library, on_cpu

BQ = BK = 64  # the whole tiles taken; the fp32 kernel's tiles (FA_BQ, FA_BK)
MAX_HEAD_DIM = 128  # the kernel's register budget (FA_MAX_D)
NEG_INF = -1e30  # the reference kernel's mask value

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
# forward launches by kernel: "wgmma" (bf16), "simt" (fp32, FFMA); those
# with a window; those without the causal mask (an encoder's
# self-attention, a cross-attention)
FWD_ROUTES = {"wgmma": 0, "simt": 0}
WINDOW_ROUTES = {"wgmma": 0, "simt": 0}
NONCAUSAL = {"wgmma": 0, "simt": 0}
# backward launches by route; those with a window; those without the
# causal mask
BWD_ROUTES = {"mma": 0, "simt": 0}
BWD_WINDOW_ROUTES = {"mma": 0, "simt": 0}
BWD_NONCAUSAL = {"mma": 0, "simt": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in (FWD_ROUTES, WINDOW_ROUTES, NONCAUSAL, BWD_ROUTES,
                   BWD_WINDOW_ROUTES, BWD_NONCAUSAL):
        for route in routes:
            routes[route] = 0


def _check(q, k, v, plain: bool = False) -> int:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
            "want (bh, seq, d) each"
        )
    types = (torch.float32, torch.bfloat16) + ((torch.float64,) if plain else ())
    if q.dtype not in types or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"want bf16 or fp32 inputs of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[2] != k.shape[2] or q.shape[0] % k.shape[0]:
        raise ValueError(
            f"q {tuple(q.shape)} does not match k {tuple(k.shape)}"
        )
    return q.shape[0] // k.shape[0]


def _contiguous_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and on the 16-byte boundary a TMA tensor map needs."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _work(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: fp32, or float64 for float64."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
    return_lse: bool = False,
):
    """Plain version of K4: per query tile, an online softmax over key
    tiles from the first one the tile's window reaches (tile 0 without a
    window) up to the causal limit, in fp32, with the kernel's numerics.
    ``return_lse`` also returns the rows' logsumexp, (bh, sq) fp32."""
    group = _check(q, k, v, plain=True)
    bh, sq, d = q.shape
    sk = k.shape[1]
    sm_scale = 1.0 / math.sqrt(d)
    wt = _work(q)
    kf = k.to(wt).repeat_interleave(group, dim=0)
    vf = v.to(wt).repeat_interleave(group, dim=0)
    out = torch.empty_like(q)
    lse = q.new_empty((bh, sq), dtype=wt)
    for q0 in range(0, sq, BQ):
        qi = q[:, q0:q0 + BQ].to(wt) * sm_scale
        rows = qi.shape[1]
        n_kt = -(-sk // BK)
        if causal:
            n_kt = min(n_kt, -(-(q_offset + q0 + rows) // BK))
        t0 = _first_tile(q_offset + q0, window, BK, n_kt)
        acc = q.new_zeros((bh, rows, d), dtype=wt)
        m_i = q.new_full((bh, rows), NEG_INF, dtype=wt)
        l_i = q.new_zeros((bh, rows), dtype=wt)
        qpos = q_offset + q0 + torch.arange(rows, device=q.device)
        for t in range(t0, n_kt):
            k0 = t * BK
            kj, vj = kf[:, k0:k0 + BK], vf[:, k0:k0 + BK]
            s = qi @ kj.transpose(1, 2)
            if causal or window:
                kpos = k0 + torch.arange(kj.shape[1], device=q.device)
                s = torch.where(_visible(qpos, kpos, causal, window), s,
                                NEG_INF)
            m_new = torch.maximum(m_i, s.amax(dim=2))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_i - m_new)
            l_i = alpha * l_i + p.sum(dim=2)
            acc = acc * alpha[..., None] + p @ vj
            m_i = m_new
        out[:, q0:q0 + BQ] = (
            acc / torch.clamp(l_i, min=1e-30)[..., None]
        ).to(q.dtype)
        lse[:, q0:q0 + BQ] = m_i + torch.log(l_i)
    return (out, lse) if return_lse else out


def _first_tile(qpos0: int, window: int, tile: int, n_kt: int) -> int:
    """The first key tile a query block starting at position ``qpos0``
    visits: the one holding its first row's first visible key
    ``qpos0 - window + 1`` (0 without a window), and at most the last
    tile, as the reference's ``lo`` keeps at least one block."""
    if window <= 0:
        return 0
    return min(max(0, qpos0 - window + 1) // tile, n_kt - 1)


def _visible(qpos, kpos, causal: bool, window: int):
    """(rows, keys) bool: key ``kpos`` visible to query ``qpos``."""
    ok = (qpos[:, None] >= kpos[None, :] if causal
          else torch.ones(len(qpos), len(kpos), dtype=torch.bool,
                          device=qpos.device))
    if window > 0:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              q_offset: int = 0, window: int = 0):
    """Plain version of K4's backward, the explicit formulas (not
    autograd): P = exp(scale·QKᵀ − lse), the causal mask and the window
    a select before exp; dV = Pᵀ dO, dS = P ⊙ (dO Vᵀ − rowsum(dO ⊙ O)),
    dQ = scale·dS K, dK = scale·dSᵀ Q, then dK and dV summed over each kv
    head's ``group`` query heads.  Returns (dq, dk, dv) in q's type.
    Without a window all queries are one block; with one, each query
    tile takes the key tiles from its first visible key's
    (:func:`_first_tile`) to the causal limit, as the kernels do, so
    memory grows with the window, not with ``sk``."""
    group = _check(q, k, v, plain=True)
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    wt = _work(q)
    qf, of, gf = q.to(wt), o.to(wt), do.to(wt)
    kf = k.to(wt).repeat_interleave(group, dim=0)
    vf = v.to(wt).repeat_interleave(group, dim=0)
    dsum = (gf * of).sum(-1, keepdim=True)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    rows = BQ if window > 0 else sq
    for q0 in range(0, sq, rows):
        r1 = min(q0 + rows, sq)
        n_kt = -(-sk // BK)
        if causal:
            n_kt = min(n_kt, -(-(q_offset + r1) // BK))
        k0, k1 = _first_tile(q_offset + q0, window, BK, n_kt) * BK, n_kt * BK
        qi, gi = qf[:, q0:r1], gf[:, q0:r1]
        s = (qi @ kf[:, k0:k1].transpose(1, 2)) * scale - lse[:, q0:r1].to(
            wt)[..., None]
        if causal or window > 0:
            qpos = q_offset + torch.arange(q0, r1, device=q.device)
            kpos = torch.arange(k0, min(k1, sk), device=q.device)
            s = torch.where(_visible(qpos, kpos, causal, window), s,
                            -math.inf)
        p = torch.exp(s)
        dv[:, k0:k1] += p.transpose(1, 2) @ gi
        ds = p * (gi @ vf[:, k0:k1].transpose(1, 2) - dsum[:, q0:r1])
        dq[:, q0:r1] = (ds @ kf[:, k0:k1]) * scale
        dk[:, k0:k1] += (ds.transpose(1, 2) @ qi) * scale
    dk = dk.reshape(bh // group, group, sk, d).sum(1)
    dv = dv.reshape(bh // group, group, sk, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_tiles(q, k, v, q_offset: int, window: int = 0,
                 plain: bool = False) -> int:
    """The kernels' shape rules (forward and backward); returns the
    group.  ``plain`` (the CPU's plain versions) also takes fp64."""
    group = _check(q, k, v, plain)
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if q.shape[1] % BQ or k.shape[1] % BK or k.shape[1] == 0:
        raise ValueError(f"sq {q.shape[1]}, sk {k.shape[1]}: the kernel takes "
                         f"whole tiles of {BQ} only")
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[2]} > {MAX_HEAD_DIM}: the kernel "
                         "does not take it")
    if q.dtype == torch.bfloat16 and q.shape[2] % 8:
        raise ValueError(f"head dim {q.shape[2]}: the bf16 kernel takes "
                         "multiples of 8 (TMA's 16-byte row stride)")
    return group


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
    return_lse: bool = False,
):
    """K4: q (bh, sq, d); k, v (bh_kv, sk, d) with ``bh % bh_kv == 0``;
    scores scaled by 1/sqrt(d), the reference's default.
    Returns (bh, sq, d) in ``q.dtype``, and with ``return_lse`` also the
    rows' logsumexp (bh, sq) fp32.  ``q_offset`` is the absolute
    position of ``q[:, 0]`` (causal decode of a chunk where sq < sk);
    ``window > 0`` is the sliding window (0: none).  On the CPU the
    plain version also takes fp64."""
    group = _check_tiles(q, k, v, q_offset, window, plain=on_cpu(q, k, v))
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, window=window,
                                     return_lse=return_lse)
    bh, sq, d = q.shape
    sk = k.shape[1]
    q, k, v = (_contiguous_aligned(x) for x in (q, k, v))
    o = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel() == 0:
        return (o, lse) if return_lse else o
    lib = load_library("flash_attention")
    bf16 = q.dtype == torch.bfloat16
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if return_lse else None,
        int(bf16), bh, sq, sk, d, group, q_offset,
        1.0 / math.sqrt(d), int(causal), window, cuda_stream(q.device),
    )
    check(lib, rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    route = "wgmma" if bf16 else "simt"
    FWD_ROUTES[route] += 1
    if window:
        WINDOW_ROUTES[route] += 1
    if not causal:
        NONCAUSAL[route] += 1
    return (o, lse) if return_lse else o


def bwd_route(dtype: torch.dtype) -> str:
    """The backward a dtype takes: ``mma`` (tensor cores) for bf16,
    ``simt`` (FFMA) for fp32, as the forward routes (fp32 on the tensor
    cores would be TF32)."""
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "simt"
    raise TypeError(f"the backward kernels take bf16 or fp32, not {dtype}")


def bwd_workspace(route: str, bh: int, sq: int, sk: int, d: int) -> dict:
    """The fp32 scratch the backward's ``route`` allocates, name -> shape:
    the rows' D = rowsum(dO ⊙ O) on both; the ``simt`` route also each
    query head's share of its kv head's dK and dV."""
    if route not in BWD_ROUTES:
        raise ValueError(f"route {route!r}: want one of {sorted(BWD_ROUTES)}")
    out = {"dsum": (bh, sq)}
    if route == "simt":
        out["dk_part"] = out["dv_part"] = (bh, sk, d)
    return out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        q_offset: int = 0, window: int = 0,
                        route: str | None = None):
    """K4's backward: (dq, dk, dv) in q's type from the forward's inputs,
    its output ``o`` and row logsumexp ``lse`` (fp32 (bh, sq)) and the
    output's gradient ``do``.  The same shape rules as the forward.
    ``route`` (``"mma"`` or ``"simt"``) overrides :func:`bwd_route`;
    ``"mma"`` on fp32 raises.  ``window > 0`` is the forward's sliding
    window, on both routes.  On the CPU the plain version also takes
    fp64."""
    cpu = on_cpu(q, k, v, o, lse, do)
    group = _check_tiles(q, k, v, q_offset, window, plain=cpu)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if route is None:
        if not (cpu and q.dtype == torch.float64):
            route = bwd_route(q.dtype)
    elif route not in BWD_ROUTES:
        raise ValueError(f"route {route!r}: want one of {sorted(BWD_ROUTES)}")
    elif route == "mma" and q.dtype != torch.bfloat16:
        raise ValueError(f"the mma backward takes bf16, not {q.dtype}")
    if cpu:
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         q_offset=q_offset, window=window)
    bh, sq, d = q.shape
    sk = k.shape[1]
    q, k, v, o = (_contiguous_aligned(x) for x in (q, k, v, o))
    do = _contiguous_aligned(do.to(q.dtype))
    lse = _contiguous_aligned(lse.float())
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    work = {name: torch.empty(shape, dtype=torch.float32, device=q.device)
            for name, shape in bwd_workspace(route, bh, sq, sk, d).items()}
    lib = load_library("flash_attention")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), work["dsum"].data_ptr())
    shape = (bh, sq, sk, d, group, q_offset, 1.0 / math.sqrt(d), int(causal),
             window, cuda_stream(q.device))
    if route == "mma":
        rc = lib.repro_flash_attention_bwd_mma(*ptrs, *shape)
    else:
        rc = lib.repro_flash_attention_bwd(
            *ptrs, work["dk_part"].data_ptr(), work["dv_part"].data_ptr(),
            int(q.dtype == torch.bfloat16), *shape)
    check(lib, rc, f"flash_attention_bwd ({route})")
    LAUNCHES["flash_attention_bwd"] += 1
    BWD_ROUTES[route] += 1
    if window:
        BWD_WINDOW_ROUTES[route] += 1
    if not causal:
        BWD_NONCAUSAL[route] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """K4 under autograd: the forward kernel with its row logsumexp, the
    backward kernels for the gradients (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, q_offset: int = 0,
                window: int = 0):
        kw = dict(causal=causal, q_offset=q_offset, window=window)
        if not any(ctx.needs_input_grad[:3]):  # serving: no lse to write
            return flash_attention(q, k, v, **kw)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None
