"""Meta-tensor stand-ins and logical axes for every model input.

The port's twin of the reference's ``repro.launch.specs``:
``input_specs(arch, shape)`` returns, per the cell's kind,

  train:   {"batch": {...}}                          → train_step(state, batch)
  prefill: {"batch": {...}}                          → prefill(batch)
  decode:  {"cache": {...}, "tokens": …, "pos": …}   → decode_step(...)

(with ``"mrope_positions"`` for an M-RoPE model's decode) as tensors on
the ``meta`` device, plus a parallel tree of logical-axes tuples
(resolved against a mesh by ``parallel.sharding``).  No model is built
and nothing is allocated.
"""

from __future__ import annotations

import torch

from ..configs import SHAPES, ArchConfig, ShapeCell, get_config
from ..models import cache_spec


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _cache(spec):
    """A cache spec's tree of (shape, dtype, logical) buffers as meta
    tensors and logical axes, the "layer" axis unsharded."""
    if isinstance(spec, dict):
        pairs = {k: _cache(v) for k, v in spec.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: log for k, (_, log) in pairs.items()})
    shape, dtype, log = spec
    return (_meta(shape, dtype),
            tuple(None if a == "layer" else a for a in log))


def input_specs(arch: str | ArchConfig, shape: str | ShapeCell):
    """``(abstract inputs, logical axes)`` of ``arch`` (a registered name,
    or a config) at the cell ``shape`` (a name of
    :data:`~repro_torch.configs.SHAPES`, or a
    :class:`~repro_torch.configs.ShapeCell`)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = sh.global_batch, sh.seq_len

    if sh.kind in ("train", "prefill"):
        batch: dict = {}
        logical: dict = {}
        if cfg.is_encdec or cfg.embed_inputs:
            batch["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
            logical["embeds"] = ("dp", None, None)
        if cfg.is_encdec or not cfg.embed_inputs:
            batch["tokens"] = _meta((B, S))
            logical["tokens"] = ("dp", None)
        if cfg.mrope:
            batch["positions"] = _meta((3, B, S))
            logical["positions"] = (None, "dp", None)
        if sh.kind == "train":
            batch["labels"] = _meta((B, S))
            logical["labels"] = ("dp", None)
        return {"batch": batch}, {"batch": logical}

    # decode: the cache (its "layer" axis never sharded) and one token
    cache, cache_log = _cache(cache_spec(cfg, B, S))
    out = {"cache": cache, "tokens": _meta((B, 1)), "pos": _meta(())}
    log = {"cache": cache_log, "tokens": ("dp", None), "pos": ()}
    if cfg.mrope:
        out["mrope_positions"] = _meta((3, B, 1))
        log["mrope_positions"] = (None, "dp", None)
    return out, log
