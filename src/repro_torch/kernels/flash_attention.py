"""Flash-attention forward on Hopper (K4), with its plain version.

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
raises.  :data:`LAUNCHES` counts kernel launches.  What bounds the kernel
on the H100 is noted at the top of the CUDA source.
"""

from __future__ import annotations

import math

import torch

from .build import check, cuda_stream, load_library, on_cpu

BQ = BK = 64  # the whole tiles taken; the fp32 kernel's tiles (FA_BQ, FA_BK)
MAX_HEAD_DIM = 128  # the kernel's register budget (FA_MAX_D)
NEG_INF = -1e30  # the reference kernel's mask value

LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _check(q, k, v) -> int:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
            "want (bh, seq, d) each"
        )
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
        q.dtype == k.dtype == v.dtype
    ):
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


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain version of K4: per query tile, an online softmax over key
    tiles up to the causal limit, in fp32, with the kernel's numerics."""
    group = _check(q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    sm_scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    out = torch.empty_like(q)
    for q0 in range(0, sq, BQ):
        qi = q[:, q0:q0 + BQ].float() * sm_scale
        rows = qi.shape[1]
        n_kt = -(-sk // BK)
        if causal:
            n_kt = min(n_kt, -(-(q_offset + q0 + rows) // BK))
        acc = q.new_zeros((bh, rows, d), dtype=torch.float32)
        m_i = q.new_full((bh, rows), NEG_INF, dtype=torch.float32)
        l_i = q.new_zeros((bh, rows), dtype=torch.float32)
        qpos = q_offset + q0 + torch.arange(rows, device=q.device)
        for t in range(n_kt):
            k0 = t * BK
            kj, vj = kf[:, k0:k0 + BK], vf[:, k0:k0 + BK]
            s = qi @ kj.transpose(1, 2)
            if causal:
                kpos = k0 + torch.arange(kj.shape[1], device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m_i, s.amax(dim=2))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_i - m_new)
            l_i = alpha * l_i + p.sum(dim=2)
            acc = acc * alpha[..., None] + p @ vj
            m_i = m_new
        out[:, q0:q0 + BQ] = (
            acc / torch.clamp(l_i, min=1e-30)[..., None]
        ).to(q.dtype)
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """K4: q (bh, sq, d); k, v (bh_kv, sk, d) with ``bh % bh_kv == 0``;
    scores scaled by 1/sqrt(d), the reference's default.
    Returns (bh, sq, d) in ``q.dtype``.  ``q_offset`` is the absolute
    position of ``q[:, 0]`` (causal decode of a chunk where sq < sk)."""
    group = _check(q, k, v)
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if q.shape[1] % BQ or k.shape[1] % BK or k.shape[1] == 0:
        raise ValueError(f"sq {q.shape[1]}, sk {k.shape[1]}: the kernel takes "
                         f"whole tiles of {BQ} only")
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[2]} > {MAX_HEAD_DIM}: the kernel "
                         "does not take it")
    if q.dtype == torch.bfloat16 and q.shape[2] % 8:
        raise ValueError(f"head dim {q.shape[2]}: the bf16 kernel takes "
                         "multiples of 8 (TMA's 16-byte row stride)")
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    bh, sq, d = q.shape
    sk = k.shape[1]
    q, k, v = (_contiguous_aligned(x) for x in (q, k, v))
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = load_library("flash_attention")
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), bh, sq, sk, d, group, q_offset,
        1.0 / math.sqrt(d), int(causal), cuda_stream(q.device),
    )
    check(lib, rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
