"""Architecture registry of the LM serving side: ``get_config(name)``.

Only the two served models are registered; the reference's other
architectures (MoE, M-RoPE/VLM, the hybrid, the encoder-decoder) wait in
ROADMAP.md, queue 1 item 11.
"""

from __future__ import annotations

from . import mamba2_130m, qwen3_4b
from .base import ArchConfig, smoke_shrink

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen3_4b, mamba2_130m)
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not ported (have {sorted(ARCHS)}); the "
            "others wait in ROADMAP.md, queue 1 item 11"
        )
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "get_config", "smoke_shrink"]
