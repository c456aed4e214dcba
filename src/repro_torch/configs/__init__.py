"""Architecture registry of the LM side: ``get_config(name)``, ``ARCHS``
and the dry run's cells (:func:`all_cells`).

Registered, in the reference's order: llama3-405b (built only
abstractly, by the dry run), the dense configs (llama3.2-3b, qwen3-4b,
deepseek-7b), the hybrid zamba2-7b, the encoder-decoder
seamless-m4t-medium, the MoE configs (deepseek-moe-16b,
llama4-scout-17b-a16e), the M-RoPE/VLM backbone qwen2-vl-72b and the SSM
mamba2-130m.
"""

from __future__ import annotations

from . import (
    deepseek_7b,
    deepseek_moe_16b,
    llama3_2_3b,
    llama3_405b,
    llama4_scout_17b_a16e,
    mamba2_130m,
    qwen2_vl_72b,
    qwen3_4b,
    seamless_m4t_medium,
    zamba2_7b,
)
from .base import SHAPES, ArchConfig, ShapeCell, cell_applicable, smoke_shrink

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        llama3_405b,
        llama3_2_3b,
        qwen3_4b,
        deepseek_7b,
        zamba2_7b,
        seamless_m4t_medium,
        deepseek_moe_16b,
        llama4_scout_17b_a16e,
        qwen2_vl_72b,
        mamba2_130m,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells() -> list[tuple[str, str, bool, str]]:
    """Every (arch, shape) cell with its applicability and skip reason."""
    out = []
    for aname, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            ok, why = cell_applicable(cfg, shape)
            out.append((aname, sname, ok, why))
    return out


__all__ = [
    "ARCHS",
    "SHAPES",
    "ArchConfig",
    "ShapeCell",
    "all_cells",
    "cell_applicable",
    "get_config",
    "smoke_shrink",
]
