"""The served LM architectures: ``build_model``.

Every family of the reference is ported: the dense family (with M-RoPE
and embedded inputs for the VLM backbone) and the MoE family
(:class:`DecoderLM`), the SSM family (:class:`MambaLM`), the hybrid
(:class:`ZambaLM`) and the encoder-decoder (:class:`EncDecLM`).
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.executor import resolve_device
from ..tree import tree_map
from . import encdec, hybrid, lm, ssm_model
from .encdec import EncDecLM
from .hybrid import ZambaLM
from .lm import DecoderLM
from .ssm_model import MambaLM


def build_model(cfg: ArchConfig, params: dict | None = None, *,
                seed: int = 0, device="cuda"):
    """The model of ``cfg`` on ``device`` (default the card; raises
    without one).  Without ``params`` its weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device; ``params``
    (a nested dict of tensors, see
    :func:`repro_torch.interop.lm_params_from_numpy`) are moved there."""
    dev = resolve_device(device)
    if params is not None:
        params = _to(params, dev)
        gen = None
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family in ("dense", "moe"):
        return DecoderLM(cfg, params, generator=gen)
    if cfg.family == "ssm":
        return MambaLM(cfg, params, generator=gen)
    if cfg.family == "hybrid":
        return ZambaLM(cfg, params, generator=gen)
    if cfg.family == "encdec":
        return EncDecLM(cfg, params, generator=gen)
    raise ValueError(f"unknown family {cfg.family!r}")


def param_defs(cfg: ArchConfig) -> dict:
    """The parameter declarations of ``cfg``'s model (no weights)."""
    if cfg.family in ("dense", "moe"):
        return lm.param_defs(cfg)
    if cfg.family == "ssm":
        return ssm_model.param_defs(cfg)
    if cfg.family == "hybrid":
        return hybrid.param_defs(cfg)
    if cfg.family == "encdec":
        return encdec.param_defs(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


def cache_spec(cfg: ArchConfig, batch_size: int, max_len: int,
               enc_len: int = 0) -> dict:
    """(shape, dtype, logical axes) of each cache buffer of ``cfg``'s
    model at ``batch_size`` x ``max_len`` (no model built; the
    encoder-decoder's memory ``enc_len`` long, default ``max_len``)."""
    if cfg.family in ("dense", "moe"):
        return lm.cache_spec(cfg, batch_size, max_len)
    if cfg.family == "ssm":
        return ssm_model.cache_spec(cfg, batch_size, max_len)
    if cfg.family == "hybrid":
        return hybrid.cache_spec(cfg, batch_size, max_len)
    if cfg.family == "encdec":
        return encdec.cache_spec(cfg, batch_size, max_len, enc_len)
    raise ValueError(f"unknown family {cfg.family!r}")


def _to(params, device):
    return tree_map(lambda t: t.to(device), params)


__all__ = ["build_model", "cache_spec", "param_defs", "DecoderLM", "EncDecLM",
           "MambaLM", "ZambaLM"]
