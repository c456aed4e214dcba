"""Analytic FLOPs/bytes model per (arch × shape) cell.

The reference's model, term for term: standard MFU accounting (6ND plus
the attention's quadratic terms for training; 2ND plus cache reads for
inference).  The port has no compiled module whose cost analysis could
stand beside it, so the dry run's roofline (:mod:`.analysis`) takes its
compute and memory terms from this model alone.
"""

from __future__ import annotations

from ..configs.base import ArchConfig, ShapeCell


def _attn_flops_per_layer(cfg: ArchConfig, S: int, B: int, causal=True,
                          window: int = 0) -> float:
    """QK^T + PV flops for one layer over the whole batch."""
    hd = cfg.resolved_head_dim
    H = cfg.num_heads
    eff = min(window, S) if window else S
    ctx = eff / 2 if causal and not window else eff  # triangular average
    return 2.0 * 2.0 * B * H * S * ctx * hd


def forward_flops(cfg: ArchConfig, B: int, S: int) -> float:
    """Forward-pass FLOPs (matmul 2·MNK accounting), whole batch."""
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    T = B * S
    total = 0.0
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * D
        proj = 2.0 * T * D * (2 * d_inner + 2 * cfg.ssm_state +
                              d_inner // cfg.ssm_head_dim)
        ssd = 2.0 * T * d_inner * cfg.ssm_state * 2  # B/C contractions
        chunkq = 2.0 * T * 64 * d_inner  # intra-chunk quadratic (L=64)
        out = 2.0 * T * d_inner * D
        total += cfg.num_layers * (proj + ssd + chunkq + out)
    elif cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * D
        proj = 2.0 * T * D * (2 * d_inner + 2 * cfg.ssm_state +
                              d_inner // cfg.ssm_head_dim)
        ssd = 2.0 * T * d_inner * cfg.ssm_state * 2
        chunkq = 2.0 * T * 64 * d_inner
        outp = 2.0 * T * d_inner * D
        total += cfg.num_layers * (proj + ssd + chunkq + outp)
        n_attn = cfg.num_layers // cfg.attn_every
        qkvo = 2.0 * T * D * (cfg.num_heads + 2 * cfg.num_kv_heads +
                              cfg.num_heads) * hd
        mlp = 3 * 2.0 * T * D * cfg.d_ff
        total += n_attn * (
            qkvo + mlp + _attn_flops_per_layer(cfg, S, B, window=cfg.window)
        )
    else:
        n_dense = cfg.first_k_dense if cfg.num_experts else cfg.num_layers
        n_moe = cfg.num_layers - n_dense if cfg.num_experts else 0
        qkvo = 2.0 * T * D * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) * hd
        attn = _attn_flops_per_layer(cfg, S, B)
        total += cfg.num_layers * (qkvo + attn)
        total += n_dense * 3 * 2.0 * T * D * cfg.d_ff
        if n_moe:
            Fm = cfg.moe_d_ff or cfg.d_ff
            per_tok = (cfg.experts_per_token +
                       cfg.num_shared_experts) * 3 * 2.0 * D * Fm
            router = 2.0 * D * cfg.num_experts
            total += n_moe * T * (per_tok + router)
        if cfg.family == "encdec":
            # encoder layers + decoder cross-attention
            enc = cfg.encoder_layers * (
                qkvo + _attn_flops_per_layer(cfg, S, B, causal=False)
                + 3 * 2.0 * T * D * cfg.d_ff
            )
            cross = cfg.num_layers * (
                qkvo + _attn_flops_per_layer(cfg, S, B, causal=False)
            )
            total += enc + cross
    # lm head
    total += 2.0 * T * D * cfg.vocab_size
    return total


def decode_flops(cfg: ArchConfig, B: int, ctx: int) -> float:
    """One-token decode FLOPs with a ctx-long cache."""
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    total = 0.0
    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm_expand * D
        per_layer = 2.0 * B * D * (2 * d_inner + 2 * cfg.ssm_state +
                                   d_inner // cfg.ssm_head_dim)
        per_layer += 2.0 * B * d_inner * cfg.ssm_state * 2
        per_layer += 2.0 * B * d_inner * D
        total += cfg.num_layers * per_layer
        if cfg.family == "hybrid":
            n_attn = cfg.num_layers // cfg.attn_every
            eff = min(cfg.window, ctx) if cfg.window else ctx
            qkvo = 2.0 * B * D * 2 * (cfg.num_heads + cfg.num_kv_heads) * hd
            attn = 2.0 * 2.0 * B * cfg.num_heads * eff * hd
            mlp = 3 * 2.0 * B * D * cfg.d_ff
            total += n_attn * (qkvo + attn + mlp)
    else:
        qkvo = 2.0 * B * D * 2 * (cfg.num_heads + cfg.num_kv_heads) * hd
        attn = 2.0 * 2.0 * B * cfg.num_heads * ctx * hd
        n_dense = cfg.first_k_dense if cfg.num_experts else cfg.num_layers
        n_moe = cfg.num_layers - n_dense if cfg.num_experts else 0
        total += cfg.num_layers * (qkvo + attn)
        total += n_dense * 3 * 2.0 * B * D * cfg.d_ff
        if n_moe:
            Fm = cfg.moe_d_ff or cfg.d_ff
            total += n_moe * B * (
                (cfg.experts_per_token + cfg.num_shared_experts)
                * 3 * 2.0 * D * Fm
                + 2.0 * D * cfg.num_experts
            )
        if cfg.family == "encdec":
            total += cfg.num_layers * (
                qkvo + 2.0 * 2.0 * B * cfg.num_heads * ctx * hd
            )
    total += 2.0 * B * D * cfg.vocab_size
    return total


def cell_flops(cfg: ArchConfig, shape: ShapeCell) -> float:
    """Analytic total FLOPs for the cell's step (global, all devices)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 3.0 * forward_flops(cfg, B, S)  # fwd + 2x bwd
    if shape.kind == "prefill":
        return forward_flops(cfg, B, S)
    return decode_flops(cfg, B, S)


def cell_hbm_bytes(cfg: ArchConfig, shape: ShapeCell, n_params: int) -> float:
    """Analytic minimum HBM traffic (global): parameters read (bf16) per
    step + KV/state cache traffic for decode."""
    B, S = shape.global_batch, shape.seq_len
    param_bytes = 2.0 * n_params
    if shape.kind == "train":
        # fwd + bwd read params, write grads + opt state update (fp32 m,v)
        return 3 * param_bytes + 2 * 4.0 * n_params
    if shape.kind == "prefill":
        act = 2.0 * B * S * cfg.d_model * max(cfg.num_layers // 4, 1)
        return param_bytes + act
    # decode: whole cache read once + params
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * cfg.d_model
        nheads = d_inner // cfg.ssm_head_dim
        cache = 4.0 * cfg.num_layers * B * nheads * cfg.ssm_state * cfg.ssm_head_dim
    elif cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        nheads = d_inner // cfg.ssm_head_dim
        cache = 4.0 * cfg.num_layers * B * nheads * cfg.ssm_state * cfg.ssm_head_dim
        eff = min(cfg.window, S) if cfg.window else S
        cache += 2.0 * 2 * (cfg.num_layers // cfg.attn_every) * B * eff \
            * cfg.num_kv_heads * hd
    else:
        cache = 2.0 * 2 * cfg.num_layers * B * S * cfg.num_kv_heads * hd
        if cfg.family == "encdec":
            cache *= 2  # self + cross
    return param_bytes + cache
