"""Architecture configuration schema (the LM serving side).

Counterpart of the reference's ``configs/base.py``: one ``<arch>.py`` per
served architecture defines ``CONFIG`` with the published
hyperparameters, and :func:`smoke_shrink` derives a reduced config of the
same family for CPU tests.  The reference's input-shape cells
(``SHAPES``, ``ShapeCell``) come with the sharding layer (ROADMAP.md,
queue 1 item 11.6).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 500000.0
    mrope: bool = False
    embed_inputs: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0
    window: int = 0
    # enc-dec
    encoder_layers: int = 0
    sub_quadratic: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"


def smoke_shrink(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (the reference's
    rule, field for field)."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, 4 * cfg.num_kv_heads // max(cfg.num_heads, 1)),
        d_ff=128,
        vocab_size=512,
        head_dim=16,
    )
    if cfg.family in ("moe",):
        kw.update(
            num_experts=4,
            experts_per_token=min(2, cfg.experts_per_token),
            num_shared_experts=cfg.num_shared_experts,
            moe_d_ff=64,
            first_k_dense=min(1, cfg.first_k_dense),
        )
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, num_layers=4)
    if cfg.family == "hybrid":
        kw.update(attn_every=2, window=64)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2)
    return dataclasses.replace(cfg, **kw)
