"""Architecture configuration schema and input-shape cells.

Counterpart of the reference's ``configs/base.py``: one ``<arch>.py`` per
architecture defines ``CONFIG`` with the published hyperparameters, and
:func:`smoke_shrink` derives a reduced config of the same family for CPU
tests.  The input-shape cells (:data:`SHAPES`) are the dry run's matrix
(``repro_torch.launch.dryrun``); a full config too large for one card
(llama3-405b) is only ever built abstractly, as meta tensors.
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
    # production sharding recipe (parallel.sharding.RECIPES), per arch:
    # a small model is not sharded over hundreds of devices
    sharding_recipe: str = "default"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Whether the dry run takes ``cfg`` at ``shape``, and the reason
    when it does not (the reference's skip rule)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k context is quadratic"
    return True, ""


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
