"""Architecture registry of the LM side: ``get_config(name)``.

Registered: the dense configs (qwen3-4b, llama3.2-3b, deepseek-7b), the
MoE configs (deepseek-moe-16b, llama4-scout-17b-a16e), the M-RoPE/VLM
backbone qwen2-vl-72b, the SSM mamba2-130m, the hybrid zamba2-7b and
the encoder-decoder seamless-m4t-medium.  The reference's one other
architecture, llama3-405b, needs the sharding layer (ROADMAP.md, queue 1
item 11.6).
"""

from __future__ import annotations

from . import (
    deepseek_7b,
    deepseek_moe_16b,
    llama3_2_3b,
    llama4_scout_17b_a16e,
    mamba2_130m,
    qwen2_vl_72b,
    qwen3_4b,
    seamless_m4t_medium,
    zamba2_7b,
)
from .base import ArchConfig, smoke_shrink

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen3_4b,
        mamba2_130m,
        llama3_2_3b,
        deepseek_7b,
        deepseek_moe_16b,
        llama4_scout_17b_a16e,
        qwen2_vl_72b,
        zamba2_7b,
        seamless_m4t_medium,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not ported (have {sorted(ARCHS)}); "
            "llama3-405b waits for the sharding layer, ROADMAP.md queue 1 "
            "item 11.6"
        )
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "get_config", "smoke_shrink"]
