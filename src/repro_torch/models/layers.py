"""Neural building blocks of the served models, as functions on tensors.

Counterpart of the reference's ``models/layers.py`` for the dense, MoE,
M-RoPE/VLM, SSM and hybrid families.  Every bf16 cast sits where the
reference has it: norms return ``x.dtype``, SiLU runs in fp32 and casts back, the
MoE router runs in fp32 and its gates are cast to the activation type
before they multiply, the Mamba-2 mixer casts ``xs`` and ``y`` back to
the activation type.  Prefill attention
goes through :func:`repro_torch.kernels.ops.attention` (the flash kernel
on the card) and the chunked SSD through
:func:`repro_torch.kernels.ops.ssd_scan` (the SSD chunk kernel on the
card); the reference's models run jnp versions of the same functions,
which its Pallas kernels replace on a TPU.  Decode attention (one query)
and the one-token SSM step stay plain PyTorch, as they are jnp in the
reference; so do the MoE dispatch and its expert products (batched
library products: the reference runs them as plain ``einsum``s).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import sharding

F32 = torch.float32
SSD_CHUNK = 64  # the reference model's SSD chunk length


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the type the reference computes it in, fp32, or in fp64
    where it is fp64: on the CPU a model with fp64 weights runs fp64
    throughout (the plain versions of the kernels included), the fp64
    oracle that fp32 runs are held to."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             tp=None):
    """RMS norm over the last dimension, in fp32, or fp64 where either
    side is (a bf16 input meets fp64 weights in the fp64 oracle's first
    encoder or VLM layer).  With ``tp`` the last dimension of ``x`` and
    ``scale`` is this rank's share of a dimension split over "model":
    the mean of squares is the whole dimension's, its sum all-reduced
    forward and backward (:func:`~repro_torch.parallel.sharding.
    tp_sum`)."""
    xf = x.to(torch.promote_types(wide(x).dtype, scale.dtype))
    if tp is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        var = sharding.tp_sum(torch.sum(xf * xf, dim=-1, keepdim=True),
                              tp) / (x.shape[-1] * tp.size)
    out = xf * torch.rsqrt(var + eps) * wide(scale)
    return out.to(x.dtype)


def promoted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` in the type the reference's ``einsum`` promotes ``x`` and
    ``w`` to (bf16 embeds meet fp32 weights only in an fp32 model)."""
    return x.to(torch.promote_types(x.dtype, w.dtype))


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` in the type the two promote
    to."""
    B, S, D = x.shape
    return (promoted(x, w) @ w.reshape(D, -1)).reshape(B, S, *w.shape[1:])


# ----------------------------------------------------------------------
# rotary embeddings
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None,
               dtype=F32) -> torch.Tensor:
    """The rotary frequencies ``theta^(-2i/head_dim)``, fp32 (or fp64 for
    the fp64 oracle), computed on
    the host once per (head_dim, theta, device) and kept there: every
    device then rotates by the same fp32 angles.  A card's ``pow`` may
    land one ulp from the host's, and ``position · freq`` carries that
    ulp times the position (~3e-4 rad at position 4608, which the
    hybrid's hard attention turns into 5e-3 of its output on the H100)."""
    return _rope_freqs(head_dim, float(theta), torch.device(device or "cpu"),
                       dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float, device: torch.device, dtype):
    with torch.inference_mode(False):  # usable by autograd later
        freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=dtype)
                                 / head_dim))
        return freqs.to(device)


def apply_rope(
    x: torch.Tensor,  # (B, S, H, D)
    positions: torch.Tensor,  # (B, S) int
    theta: float = 1e4,
) -> torch.Tensor:
    D = x.shape[-1]
    xf = wide(x)
    freqs = rope_freqs(D, theta, x.device, xf.dtype)  # (D/2,)
    ang = positions[..., None].to(xf.dtype) * freqs  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_mrope(
    x: torch.Tensor,  # (B, S, H, D)
    positions: torch.Tensor,  # (3, B, S) int — temporal/height/width
    theta: float = 1e4,
    sections: tuple[int, int, int] = (2, 1, 1),  # D/2 split ratio t:h:w
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the D/2 frequency bands are split into
    three sections rotated by the temporal / height / width positions."""
    D = x.shape[-1]
    half = D // 2
    tot = sum(sections)
    bounds = [half * sum(sections[: i + 1]) // tot for i in range(3)]
    xf = wide(x)
    freqs = rope_freqs(D, theta, x.device, xf.dtype)  # (half,)
    parts = []
    lo = 0
    for i, hi in enumerate(bounds):
        parts.append(positions[i][..., None].to(xf.dtype) * freqs[lo:hi])
        lo = hi
    ang = torch.cat(parts, dim=-1)  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(xf, 2, dim=-1)
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
    """Prefill attention, ``q.dtype`` out, with the sliding ``window``
    where it is > 0 (the hybrid's).  The reference runs a jnp online
    softmax over key blocks here; the port calls the flash kernel through
    ``ops.attention`` (same function; its tiles are the kernel's own)."""
    return ops.attention(q, k, v, causal=causal, q_offset=q_offset,
                         window=window)


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


def cache_attend(cache: tuple, pos: int):
    """An ``attend`` for :func:`attention` in a decode step: this step's
    k/v written into the preallocated ``cache`` (k, v) at slot ``pos`` in
    place (the reference pads its cache and writes with
    ``dynamic_update_slice``, returning a new array), then one-query
    attention over the filled slots."""
    def attend(q, k, v):
        k_cache, v_cache = cache
        k_cache[:, pos:pos + q.shape[1]] = k
        v_cache[:, pos:pos + q.shape[1]] = v
        return decode_attention(q, k_cache, v_cache, pos + q.shape[1])
    return attend


def kv_heads_of(wk: torch.Tensor, wv: torch.Tensor, first: int, heads: int,
                num_heads: int, tp):
    """``wk``/``wv`` (D, KV, hd) replicated over "model", reduced to the
    kv heads that the q heads ``[first, first + heads)`` of ``num_heads``
    read (GQA: q head ``h`` reads kv head ``h // (num_heads / KV)``):
    their distinct heads where each serves the same count of this rank's
    q heads, as K4's GQA takes them, else one kv head per q head.  Both
    pass :func:`~repro_torch.parallel.sharding.tp_enter` first: each
    rank's gradient of them is partial."""
    group = num_heads // wk.shape[1]
    want = [h // group for h in range(first, first + heads)]
    distinct = sorted(set(want))
    if heads % len(distinct) == 0 and want == [
            distinct[i // (heads // len(distinct))] for i in range(heads)]:
        want = distinct
    idx = torch.tensor(want, device=wk.device)
    return (sharding.tp_enter(wk, tp).index_select(1, idx),
            sharding.tp_enter(wv, tp).index_select(1, idx))


def attention_kv(src: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 heads: int, num_heads: int, num_kv_heads: int, tp=None,
                 entered: bool = False):
    """Keys and values (B, Sk, kv heads, hd) of ``src`` (B, Sk, D) through
    ``wk``/``wv`` (D, KV, hd), each product reading ``src`` promoted to its
    weight's type, for the ``heads`` q heads of ``num_heads`` that this
    rank holds.  Where ``tp`` splits the q heads, the keys are the rank's
    kv heads where ``wk``'s are split too, else the ones its q heads read
    (:func:`kv_heads_of`), and ``src`` passes :func:`~repro_torch.
    parallel.sharding.tp_enter` unless it has (``entered``: the
    self-attention's input): once, or for each product where the
    promotion makes a copy of its own."""
    split = tp is not None and tp.split(heads, num_heads)
    if split:
        if not tp.split(wk.shape[1], num_kv_heads):
            wk, wv = kv_heads_of(wk, wv, tp.rank * heads, heads, num_heads,
                                 tp)
        if not entered and promoted(src, wk) is src:
            src, entered = sharding.tp_enter(src, tp), True
    reads = [promoted(src, w) for w in (wk, wv)]
    if split and not entered:
        reads = [sharding.tp_enter(t, tp) for t in reads]
    return project(reads[0], wk), project(reads[1], wv)


def attention(x: torch.Tensor, wq, wk, wv, wo, *, num_heads: int,
              num_kv_heads: int, memory: torch.Tensor | None = None,
              kv: tuple | None = None, positions=None, mrope_positions=None,
              rope_theta: float = 1e4, q_norm=None, k_norm=None,
              eps: float = 1e-6, causal: bool = True, window: int = 0,
              attend=None, out_dtype=None, tp=None):
    """One attention block of every family, from its normed input ``x``
    (B, S, D): returns its output projection (B, S, D), before the
    residual, and its (k, v).

    Queries come from ``x`` through ``wq`` (D, H, hd); keys and values
    from ``x`` (self-attention), from ``memory`` (B, Sk, D; the
    encoder-decoder's cross-attention, sq ≠ sk) or as given in ``kv``
    (this rank's, already projected: a cache).  Each product reads its
    input promoted to its weight's type, as the reference's ``einsum``s
    do (bf16 embeds meet wider weights only in an fp32 or fp64 model).
    Computed keys take the q/k norms and the rotary phase
    (``mrope_positions`` or ``positions``; neither for a
    cross-attention).  ``attend(q, k, v)`` replaces the prefill
    attention (:func:`blockwise_attention`, ``causal``, ``window``): a
    decode step's cache write and one-query attention.  The attention's
    output is rounded to ``out_dtype`` (default ``x``'s type) before the
    output projection.

    Where ``tp`` (the sharded step) splits the heads, ``wq`` (D, H/P, hd)
    and ``wo`` (H/P, hd, D) are this rank's, the block runs on them and
    its output is the ranks' sum (a row-parallel product,
    :func:`~repro_torch.parallel.sharding.tp_leave`); ``x`` and
    ``memory`` pass :func:`~repro_torch.parallel.sharding.tp_enter` (``x``
    once, or for each product where the promotion copies it), and so do
    the q/k norms, replicated and read inside the split region."""
    B, S, _ = x.shape
    out_dtype = out_dtype or x.dtype
    heads = wq.shape[1]
    split = tp is not None and tp.split(heads, num_heads)
    entered = False
    if split:
        if promoted(x, wq) is x:
            x, entered = sharding.tp_enter(x, tp), True
        if q_norm is not None:
            q_norm = sharding.tp_enter(q_norm, tp)
            k_norm = sharding.tp_enter(k_norm, tp)
    xq = promoted(x, wq)
    if split and not entered:
        xq = sharding.tp_enter(xq, tp)
    q = project(xq, wq)
    if kv is None:
        src = x if memory is None else memory
        k, v = attention_kv(src, wk, wv, heads, num_heads, num_kv_heads, tp,
                            entered=entered and memory is None)
        if q_norm is not None:
            q = rms_norm(q, q_norm, eps)
            k = rms_norm(k, k_norm, eps)
        if mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, rope_theta)
            k = apply_mrope(k, mrope_positions, rope_theta)
        elif positions is not None:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
    else:
        k, v = kv
    if attend is None:
        o = blockwise_attention(q, k, v, causal=causal, window=window)
    else:
        o = attend(q, k, v)
    o = promoted(o.to(out_dtype).reshape(B, S, -1), wo)
    y = o @ wo.reshape(-1, wo.shape[-1])
    if split:
        y = sharding.tp_leave(y, tp)
    return y, (k, v)


def embed_rows(w: torch.Tensor, ids: torch.Tensor, tp) -> torch.Tensor:
    """Vocabulary-parallel embedding lookup: ``w`` holds this rank's rows
    ``[r·V/P, (r+1)·V/P)`` of the table; the ids outside them are masked
    to zero rows, and the ranks' rows all-reduced over "model"."""
    n = w.shape[0]
    local = ids - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = w[torch.where(mine, local, torch.zeros_like(local))]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return sharding.tp_leave(rows, tp)


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(wide(g)).to(x.dtype) * u
    return h @ w_down


def ffn(x: torch.Tensor, w_gate, w_up, w_down, width: int,
        tp=None, leave: bool = True, entered: bool = False) -> torch.Tensor:
    """A SwiGLU of ``width`` hidden columns, or of this rank's share of
    them where ``tp`` splits ``w_gate``'s (column-parallel gate and up,
    row-parallel down, one all-reduce): every family's MLP.  ``x``
    passes :func:`~repro_torch.parallel.sharding.tp_enter` unless the
    caller entered it (``entered``: one entry shared with another split
    branch).  Without ``leave`` a split SwiGLU returns the rank's partial
    output, for the caller to sum with another branch's
    (:func:`tp_combine`)."""
    if not sharding.splits(tp, w_gate.shape[1], width):
        return swiglu(x, w_gate, w_up, w_down)
    y = swiglu(x if entered else sharding.tp_enter(x, tp), w_gate, w_up,
               w_down)
    return sharding.tp_leave(y, tp) if leave else y


def tp_combine(parts, tp) -> torch.Tensor:
    """The sum of a block's branches, ``(y, partial)`` pairs in order:
    the partial ones (a rank's share of a product split over "model")
    summed and all-reduced by one :func:`~repro_torch.parallel.sharding.
    tp_leave`, then the whole ones added (without a partial one, the
    branches' sum in order)."""
    partial = [y for y, part in parts if part]
    out = (sharding.tp_leave(sum(partial[1:], partial[0]), tp) if partial
           else None)
    for y, part in parts:
        if not part:
            out = y if out is None else out + y
    return out


# ----------------------------------------------------------------------
# Mixture of Experts (capacity routing)
# ----------------------------------------------------------------------
def moe_capacity(tokens: int, top_k: int, num_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """Slots per expert: ``capacity_factor · T · k / E`` rounded down,
    then up to a multiple of 8, at least 8 (the reference's rule)."""
    cap = int(capacity_factor * tokens * top_k / num_experts)
    return max(8, -(-cap // 8) * 8)


def moe_route(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, dispatch: str = "sort",
              group=None):
    """The routing of :func:`moe_layer` on ``x`` (B, S, D): ``(probs (T,
    E) fp32, gate (T, k) fp32 renormalised, ids (T, k), keep (T·k,) bool,
    dest (T·k,), cap)``.  Slot ``(t, r)`` of the flat ``(token, rank)``
    order goes to row ``dest = ids·cap + position-in-expert`` of the
    expert buffer, or to the trash row ``E·cap`` when its expert is full
    (``keep`` false).

    With ``group`` (the process group the batch is split over, its ranks
    holding the batch's rows in order, each the same count) the routing
    is the whole batch's: every rank's top-k ids are gathered, the
    capacity is that of the global token count and the positions run in
    global token order; this rank's slots are returned."""
    B, S, D = x.shape
    E = router_w.shape[1]
    T = B * S
    logits = wide(x.reshape(T, D)) @ wide(router_w)
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gate, ids = torch.topk(probs, top_k, dim=-1, sorted=True)  # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat_ids = ids.reshape(-1)  # (T·k,)
    mine = slice(None)
    if group is not None:
        ranks = dist.get_world_size(group)
        parts = [torch.empty(flat_ids.shape, dtype=torch.int32,
                             device=x.device) for _ in range(ranks)]
        dist.all_gather(parts, flat_ids.to(torch.int32), group=group)
        start = dist.get_rank(group) * flat_ids.numel()
        mine = slice(start, start + flat_ids.numel())
        flat_ids = torch.cat(parts).long()
        T = T * ranks
    cap = moe_capacity(T, top_k, E, capacity_factor)
    n = flat_ids.numel()
    if dispatch == "sort":
        sort_idx = torch.argsort(flat_ids, stable=True)
        sorted_ids = flat_ids[sort_idx]
        starts = torch.searchsorted(
            sorted_ids, torch.arange(E, device=x.device))  # (E,)
        pos_sorted = torch.arange(n, device=x.device) - starts[sorted_ids]
        # sort_idx is a permutation: each position written once
        mypos = torch.empty_like(pos_sorted).scatter_(0, sort_idx, pos_sorted)
    elif dispatch == "cumsum":  # GShard's one-hot cumsum
        onehot = (flat_ids[:, None] == torch.arange(E, device=x.device)
                  ).long()  # (T·k, E)
        pos_all = torch.cumsum(onehot, dim=0) - 1
        mypos = pos_all.gather(1, flat_ids[:, None])[:, 0]
    else:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    flat_ids, mypos = flat_ids[mine], mypos[mine]
    keep = mypos < cap
    dest = torch.where(keep, flat_ids * cap + mypos,
                       torch.full_like(flat_ids, E * cap))
    return probs, gate, ids, keep, dest, cap


def expert_ffn(h: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Every expert's SwiGLU on its rows: ``h`` (E, cap, D) through three
    batched products over the experts, SiLU in fp32 cast back (``E`` a
    rank's experts where the sharded step splits them)."""
    gates = torch.bmm(h, w_gate)
    ups = torch.bmm(h, w_up)
    act = F.silu(wide(gates)).to(h.dtype) * ups
    return torch.bmm(act, w_down)


def moe_layer(
    x: torch.Tensor,  # (B, S, D)
    router_w: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    dispatch: str = "sort",
    group=None,
    tp=None,
    rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k token-choice routing with per-expert capacity (tokens over
    capacity are dropped, Switch/GShard semantics): the reference's
    ``moe_layer``, dropping exactly the slots it drops.

    The router runs in fp32; the top-k gates are renormalised; each
    ``(token, rank)`` slot, in flat order, takes the next free row of its
    expert's ``cap`` rows (``dispatch`` "sort": stable argsort and
    searchsorted; "cumsum": one-hot cumsum; the same positions) or is
    dropped.  The expert FFN is three batched products over the experts;
    each slot's output is scaled by its gate, cast to the activation
    type, and the ``k`` slots of a token summed.

    Static shapes and no host synchronisation: ``cap`` comes from the
    token count, the buffer is written by ``index_copy`` (every kept slot
    has its own row; dropped ones all land on the trash row, cut off
    before the products, so no float is ever summed by atomics), and the
    Switch aux loss's counts are an integer ``scatter_add_`` (exact in
    any order; ``torch.bincount`` reads its maximum back to the host on
    the card).  Returns (y (B, S, D), aux_loss () fp32).

    With ``group`` the routing is the whole batch's (:func:`moe_route`),
    and so is the aux loss: the top-1 counts and the probability sums are
    all-reduced over the group.  Its value is the global one on every
    rank, its gradient the group's size times this rank's share of the
    global one, so that the mean of the ranks' gradients (the sharded
    train step's reduction) is the global gradient.

    Where ``tp`` (the sharded step) splits the experts over "model"
    (expert parallelism), ``w_gate``/``w_up``/``w_down`` hold this rank's
    ``E/P`` experts ``[r·E/P, (r+1)·E/P)``.  The routing and the aux loss
    are computed whole on every rank, outside the split region (the
    ranks of "model" hold the same rows), so the aux loss's gradient
    reaches the router once.  Only what the rank's products read enters
    the region (:func:`~repro_torch.parallel.sharding.tp_enter`): ``x``'s
    rows and the gates, whose gradients are then summed over the ranks
    (``rows``: ``x`` as the caller entered it already, one entry shared
    with another split branch that reads it).
    The rank's buffer holds its experts' ``(E/P)·cap`` rows; the slots
    of the other ranks' experts go to the trash row, as dropped slots
    do, and the rank's output is its own slots' sum: a partial output,
    for the caller to sum over the ranks with the shared experts' one
    (:func:`tp_combine`)."""
    B, S, D = x.shape
    E = router_w.shape[1]
    T = B * S
    probs, gate, ids, keep, dest, cap = moe_route(
        x, router_w, top_k, capacity_factor, dispatch, group=group)

    # load-balance aux loss (Switch): E · Σ_e f_e · p_e over the top-1 ids
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, ids[:, 0], torch.ones_like(ids[:, 0]))
    if group is None:
        f_e = counts.float() / T
        aux = E * torch.mean(f_e * torch.mean(probs, dim=0))
    else:
        ranks = dist.get_world_size(group)
        dist.all_reduce(counts, group=group)
        part = ranks * probs.sum(dim=0)
        total = probs.sum(dim=0).detach()
        dist.all_reduce(total, group=group)
        f_e = counts.float() / (T * ranks)
        p_e = (total + (part - part.detach())) / (T * ranks)
        aux = E * torch.mean(f_e * p_e)

    xf = x.reshape(T, D)
    n = w_gate.shape[0]  # the experts this rank runs
    split = sharding.splits(tp, n, E)
    if split:
        # this rank's experts' rows of the buffer: its slots keep their
        # positions, the others' go to the trash row
        first = tp.rank * n * cap
        keep = keep & (dest >= first) & (dest < first + n * cap)
        dest = torch.where(keep, dest - first, torch.full_like(dest, n * cap))
        xf = (sharding.tp_enter(xf, tp) if rows is None
              else rows.reshape(T, D))
        gate = sharding.tp_enter(gate, tp)
    xin = xf[:, None].expand(T, top_k, D).reshape(T * top_k, D)  # slot rows
    buf = torch.zeros((n * cap + 1, D), dtype=x.dtype, device=x.device)
    h = buf.index_copy(0, dest, xin)[: n * cap].reshape(n, cap, D)
    out = expert_ffn(h, w_gate, w_up, w_down).reshape(n * cap, D)
    out = torch.cat([out, out.new_zeros(1, D)], 0)
    scale = (keep * gate.reshape(-1))[:, None].to(x.dtype)
    y = (out[dest] * scale).reshape(T, top_k, D).sum(dim=1)
    return y.reshape(B, S, D), aux


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
    xf, wf = wide(xin), wide(w)
    out = xf[:, 0:S] * wf[:, 0]
    for t in range(1, K):
        out = out + xf[:, t:t + S] * wf[:, t]
    return out.to(x.dtype), new_state


# the parameters the sharded step's compute reads whole on every rank
# although their logical "tp" dimension splits them when stored: B and C's
# projection and convolution, which every head of the mixer reads
WHOLE_ALONG_MODEL = frozenset({"w_bc", "conv_bc"})


def mamba2_mix(
    x: torch.Tensor,  # (B, S, D)
    p: dict,
    *,
    d_state: int,
    head_dim: int,
    expand: int,
    ssm_state=None,  # (B, nheads, d_state, head_dim) decode carry
    conv_state=None,  # ((B,K-1,d_inner), (B,K-1,2N)) decode carry
    tp=None,
):
    """Mamba-2 mixer (SSD).  Returns (y, (ssm_state, conv_state)).  The
    head axis stays explicit and B/C are head-free (ngroups = 1).

    The widths are the weights': where ``tp`` (the sharded step) splits
    ``d_inner`` over "model", ``p`` holds this rank's ``d_inner / P``
    channels and ``nheads / P`` heads (``w_z``, ``w_x``, ``w_dt``,
    ``conv_x``, ``dt_bias``, ``a_log``, ``norm``, the rows of ``w_out``)
    and the mixer runs on them: ``x`` passes
    :func:`~repro_torch.parallel.sharding.tp_enter`, the gated norm's
    mean of squares is the whole ``d_inner``'s, and ``w_out``'s partial
    product is summed over the ranks (``tp_leave``).  ``w_bc``/``conv_bc``
    are whole on every rank (every head reads B and C) and pass
    ``tp_enter``: each rank's gradient of them is its heads' share."""
    B, S, D = x.shape
    d_inner = p["w_x"].shape[1]
    nheads = p["w_dt"].shape[1]
    w_bc, conv_bc = p["w_bc"], p["conv_bc"]
    split = tp is not None and tp.split(d_inner, expand * D)
    if split:
        if not tp.split(nheads, expand * D // head_dim):
            raise ValueError(f"d_inner {expand * D} splits over {tp.size} "
                             f"ranks but its {expand * D // head_dim} heads "
                             "do not")
        x = sharding.tp_enter(x, tp)
        w_bc, conv_bc = sharding.tp_enter(w_bc, tp), sharding.tp_enter(
            conv_bc, tp)
    z = x @ p["w_z"]  # (B, S, d_inner)
    xs = x @ p["w_x"]  # (B, S, d_inner)
    bc = x @ w_bc  # (B, S, 2N)
    dt = x @ p["w_dt"]  # (B, S, H)

    cs_x = conv_state[0] if conv_state is not None else None
    cs_bc = conv_state[1] if conv_state is not None else None
    xs, new_cs_x = causal_conv1d(xs, p["conv_x"], cs_x)
    bc, new_cs_bc = causal_conv1d(bc, conv_bc, cs_bc)
    xs = F.silu(wide(xs)).to(x.dtype)
    bc = F.silu(wide(bc))
    b_mat = bc[..., :d_state]  # (B, S, N) head-free
    c_mat = bc[..., d_state:]  # (B, S, N)
    dt = F.softplus(wide(dt) + wide(p["dt_bias"]))
    a = -torch.exp(wide(p["a_log"]))  # (H,)
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
    y = rms_norm(y * F.silu(wide(z)).to(x.dtype), p["norm"],
                 tp=tp if split else None)
    out = y @ p["w_out"]
    if split:
        out = sharding.tp_leave(out, tp)
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
        torch.zeros((B, H, N, Dh), dtype=wide(xh).dtype, device=xh.device)
        if state0 is None else wide(state0)
    )
    xf, dt, a, b, c = (wide(t) for t in (xh, dt, a, b, c))
    ys = []
    for t in range(T):
        xdt = xf[:, t] * dt[:, t][..., None]  # (B, H, Dh)
        h = torch.exp(a[:, t])[..., None, None] * h + torch.einsum(
            "bn,bhd->bhnd", b[:, t], xdt
        )
        ys.append(torch.einsum("bn,bhnd->bhd", c[:, t], h))
    return torch.stack(ys, dim=1), h

