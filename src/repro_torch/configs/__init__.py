"""Architecture registry of the LM side: ``get_config(name)``.

Registered: the two served models (qwen3-4b, mamba2-130m) and
llama3.2-3b, the reference training launcher's default (a dense config,
served and trained by the same model code).  The reference's other
architectures (MoE, M-RoPE/VLM, the hybrid, the encoder-decoder and the
other dense configs) wait in ROADMAP.md, queue 1 item 11.
"""

from __future__ import annotations

from . import llama3_2_3b, mamba2_130m, qwen3_4b
from .base import ArchConfig, smoke_shrink

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen3_4b, mamba2_130m, llama3_2_3b)
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not ported (have {sorted(ARCHS)}); the "
            "others wait in ROADMAP.md, queue 1 item 11"
        )
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "get_config", "smoke_shrink"]
