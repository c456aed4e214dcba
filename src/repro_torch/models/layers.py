"""Neural building blocks of the served models, as functions on tensors.

Counterpart of the reference's ``models/layers.py`` for the dense and
SSM families.  Every bf16 cast sits where the reference has it: norms
return ``x.dtype``, SiLU runs in fp32 and casts back, the Mamba-2 mixer
casts ``xs`` and ``y`` back to the activation type.  Prefill attention
goes through :func:`repro_torch.kernels.ops.attention` (the flash kernel
on the card) and the chunked SSD through
:func:`repro_torch.kernels.ops.ssd_scan` (the SSD chunk kernel on the
card); the reference's models run jnp versions of the same functions,
which its Pallas kernels replace on a TPU.  Decode attention (one query)
and the one-token SSM step stay plain PyTorch, as they are jnp in the
reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops

F32 = torch.float32
SSD_CHUNK = 64  # the reference model's SSD chunk length


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# rotary embeddings
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=F32, device=device)
                  / head_dim)
    )


def apply_rope(
    x: torch.Tensor,  # (B, S, H, D)
    positions: torch.Tensor,  # (B, S) int
    theta: float = 1e4,
) -> torch.Tensor:
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)  # (D/2,)
    ang = positions[..., None].to(F32) * freqs  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Sk, Hkv, Dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
) -> torch.Tensor:
    """Prefill attention, ``q.dtype`` out.  The reference runs a jnp
    online softmax over key blocks here; the port calls the flash kernel
    through ``ops.attention`` (same function; its tiles are the kernel's
    own).  Sliding windows belong to the hybrid family, not ported."""
    if window:
        raise NotImplementedError(
            "windowed attention belongs to the hybrid family, which is not "
            "ported (ROADMAP.md, queue 1 item 11)"
        )
    return ops.attention(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, S, Hkv, Dh)
    v_cache: torch.Tensor,
    num_valid: int,  # number of valid cache slots
) -> torch.Tensor:
    """Single-token decode attention over a KV cache, slots at and past
    ``num_valid`` masked (plain PyTorch: one query row is bandwidth-bound
    and the reference runs it in jnp too)."""
    B, S, Hkv, Dh = k_cache.shape
    H = q.shape[2]
    group = H // Hkv
    sm_scale = 1.0 / math.sqrt(Dh)
    qf = q.float() * sm_scale  # (B, 1, H, D)
    kf = k_cache.float()
    qg = qf.reshape(B, 1, Hkv, group, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf).reshape(B, H, 1, S)
    valid = torch.arange(S, device=q.device) < num_valid
    s = torch.where(valid[None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    pg = p.reshape(B, Hkv, group, 1, S)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pg, v_cache.float())
    return o.reshape(B, 1, H, Dh).to(q.dtype)


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


# ----------------------------------------------------------------------
# Mamba-2 (SSD) block
# ----------------------------------------------------------------------
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv.  x: (B, S, C); w: (C, K).  With ``state``
    (B, K-1, C): decode mode, returns the new state.

    The K taps are shifted multiply-adds in fp32, not ``F.conv1d``: on the
    card cuDNN would run an fp32 convolution in TF32 by default, and the
    reference's ``conv_general_dilated`` is full fp32."""
    B, S, C = x.shape
    K = w.shape[1]
    if state is not None:
        xin = torch.cat([state.to(x.dtype), x], dim=1)  # (B, K-1+S, C)
    else:
        xin = F.pad(x, (0, 0, K - 1, 0))
    new_state = xin[:, -(K - 1):, :]
    xf, wf = xin.float(), w.float()
    out = xf[:, 0:S] * wf[:, 0]
    for t in range(1, K):
        out = out + xf[:, t:t + S] * wf[:, t]
    return out.to(x.dtype), new_state


def mamba2_mix(
    x: torch.Tensor,  # (B, S, D)
    p: dict,
    *,
    d_state: int,
    head_dim: int,
    expand: int,
    ssm_state=None,  # (B, nheads, d_state, head_dim) decode carry
    conv_state=None,  # ((B,K-1,d_inner), (B,K-1,2N)) decode carry
):
    """Mamba-2 mixer (SSD).  Returns (y, (ssm_state, conv_state)).  The
    head axis stays explicit and B/C are head-free (ngroups = 1)."""
    B, S, D = x.shape
    d_inner = expand * D
    nheads = d_inner // head_dim
    z = x @ p["w_z"]  # (B, S, d_inner)
    xs = x @ p["w_x"]  # (B, S, d_inner)
    bc = x @ p["w_bc"]  # (B, S, 2N)
    dt = x @ p["w_dt"]  # (B, S, H)

    cs_x = conv_state[0] if conv_state is not None else None
    cs_bc = conv_state[1] if conv_state is not None else None
    xs, new_cs_x = causal_conv1d(xs, p["conv_x"], cs_x)
    bc, new_cs_bc = causal_conv1d(bc, p["conv_bc"], cs_bc)
    xs = F.silu(xs.float()).to(x.dtype)
    bc = F.silu(bc.float())
    b_mat = bc[..., :d_state]  # (B, S, N) head-free
    c_mat = bc[..., d_state:]  # (B, S, N)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())  # (H,)
    log_decay = dt * a[None, None, :]  # (B, S, H)

    xh = xs.reshape(B, S, nheads, head_dim)
    if ssm_state is not None and S == 1:
        # decode: one recurrence step
        h = ssm_state.float()  # (B, H, N, Dh)
        decay = torch.exp(log_decay[:, 0])  # (B, H)
        xdt = xh[:, 0].float() * dt[:, 0][..., None]  # (B, H, Dh)
        h = decay[..., None, None] * h + torch.einsum(
            "bn,bhd->bhnd", b_mat[:, 0], xdt
        )
        y = torch.einsum("bn,bhnd->bhd", c_mat[:, 0], h)  # (B, H, Dh)
        y = y[:, None].reshape(B, 1, nheads, head_dim)
        new_state = h
    elif S % SSD_CHUNK == 0:
        y, new_state = _ssd_chunked(
            xh, dt, log_decay, b_mat, c_mat, SSD_CHUNK, ssm_state
        )
    else:
        y, new_state = _ssd_seq(xh, dt, log_decay, b_mat, c_mat, ssm_state)
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm"])
    out = y @ p["w_out"]
    return out, (new_state, (new_cs_x, new_cs_bc))


def _ssd_chunked(xh, dt, a, b, c, chunk: int, state0=None):
    """Chunked SSD with an explicit head axis through ``ops.ssd_scan``
    (the intra-chunk kernel on the card).

    xh: (B,S,H,Dh); dt/a: (B,S,H); b/c: (B,S,N) head-free, passed as one
    group per batch row (no per-head copy).
    Returns (y (B,S,H,Dh) f32, state (B,H,N,Dh) f32)."""
    B, T, H, Dh = xh.shape
    N = b.shape[-1]
    s0 = None if state0 is None else state0.reshape(B * H, N, Dh)
    # (B, S, H, ...) → (B·H, S, ...): row bh = b·H + h, so batch row b's
    # B/C group serves rows b·H … b·H + H - 1
    y, h = ops.ssd_scan(
        xh.transpose(1, 2).reshape(B * H, T, Dh),
        dt.transpose(1, 2).reshape(B * H, T),
        a.transpose(1, 2).reshape(B * H, T),
        b, c, chunk=chunk, state0=s0,
    )
    return (
        y.reshape(B, H, T, Dh).transpose(1, 2),
        h.reshape(B, H, N, Dh),
    )


def _ssd_seq(xh, dt, a, b, c, state0=None):
    """Sequential (exact) SSD with explicit head axis, for ragged lengths
    (plain PyTorch, the reference's ``_ssd_seq_jnp``)."""
    B, T, H, Dh = xh.shape
    N = b.shape[-1]
    h = (
        torch.zeros((B, H, N, Dh), dtype=F32, device=xh.device)
        if state0 is None else state0.float()
    )
    xf, dt, a, b, c = (t.float() for t in (xh, dt, a, b, c))
    ys = []
    for t in range(T):
        xdt = xf[:, t] * dt[:, t][..., None]  # (B, H, Dh)
        h = torch.exp(a[:, t])[..., None, None] * h + torch.einsum(
            "bn,bhd->bhnd", b[:, t], xdt
        )
        ys.append(torch.einsum("bn,bhnd->bhd", c[:, t], h))
    return torch.stack(ys, dim=1), h

