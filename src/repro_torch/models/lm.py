"""Dense decoder-only LM (GQA, optional qk-norm): serving and training.

Counterpart of the reference's ``DecoderLM`` (``models/lm.py``) for
``family == "dense"``: prefill, ``decode_step``, ``cache_spec`` and
``init_cache``, and for training ``hidden_states`` and ``loss``.  The
reference stacks the layers' parameters on a leading axis for
``lax.scan``; here each layer is a module of its own and the stack is a
Python loop, each layer under ``torch.utils.checkpoint`` when training
(the reference's ``jax.checkpoint``: the same values, other memory).
MoE layers and M-RoPE are not ported and raise.

Serving conventions (as in the reference):
  prefill:  tokens (B, S) → (cache, last-position logits (B, V) fp32)
  decode:   (cache, tokens (B, 1), pos) → (logits (B, V) fp32, cache)
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import layers as L
from .params import ParamDef, TrainableLM, param_modules


def _attn_defs(cfg: ArchConfig) -> dict:
    D, H, KV, hd = (
        cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
    )
    d = {
        "wq": ParamDef((D, H, hd)),
        "wk": ParamDef((D, KV, hd)),
        "wv": ParamDef((D, KV, hd)),
        "wo": ParamDef((H, hd, D)),
        "ln_attn": ParamDef((D,), init="ones"),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((hd,), init="ones")
        d["k_norm"] = ParamDef((hd,), init="ones")
    return d


def _mlp_defs(cfg: ArchConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((D, F)),
        "w_up": ParamDef((D, F)),
        "w_down": ParamDef((F, D)),
        "ln_mlp": ParamDef((D,), init="ones"),
    }


def param_defs(cfg: ArchConfig) -> dict:
    """``{"embed", "final_norm", ["head"], "layers": [per-layer dict]}``
    of :class:`ParamDef` (the reference's declarations, unstacked)."""
    D, V = cfg.d_model, cfg.vocab_size
    defs: dict = {
        "embed": ParamDef((V, D), scale=0.02),
        "final_norm": ParamDef((D,), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((D, V), scale=0.02)
    defs["layers"] = [
        {**_attn_defs(cfg), **_mlp_defs(cfg)} for _ in range(cfg.num_layers)
    ]
    return defs


class DecoderLM(TrainableLM):
    """Dense decoder-only transformer.  ``params`` is the nested dict
    ``{"embed", "final_norm", ["head"], "layers": [per-layer dict]}`` (see
    :func:`repro_torch.interop.lm_params_from_numpy`); without it the
    weights are drawn from ``generator``."""

    def __init__(self, cfg: ArchConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: MoE is not ported (ROADMAP.md, "
                "queue 1 item 11)"
            )
        if cfg.mrope or cfg.embed_inputs:
            raise NotImplementedError(
                "M-RoPE / embedded inputs (VLM) are not ported (ROADMAP.md, "
                "queue 1 item 11)"
            )
        self.cfg = cfg
        self.top, self.layers = param_modules(param_defs(cfg), params,
                                              generator)

    def head_weights(self, top: dict) -> torch.Tensor:
        return top["embed"].T if self.cfg.tie_embeddings else top["head"]

    # ------------------------------------------------------------ blocks
    def _attention(self, p, h, positions, cache=None, pos=None):
        """One attention block.  Prefill (``cache is None``) returns the
        layer's (k, v); decode writes this token's k/v into the
        preallocated ``cache`` at slot ``pos`` in place."""
        cfg = self.cfg
        B, S, D = h.shape
        hd = cfg.resolved_head_dim
        x = L.rms_norm(h, p["ln_attn"], cfg.norm_eps)
        q = (x @ p["wq"].reshape(D, -1)).reshape(B, S, cfg.num_heads, hd)
        k = (x @ p["wk"].reshape(D, -1)).reshape(B, S, cfg.num_kv_heads, hd)
        v = (x @ p["wv"].reshape(D, -1)).reshape(B, S, cfg.num_kv_heads, hd)
        if cfg.qk_norm:
            q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        if cache is None:
            o = L.blockwise_attention(q, k, v, causal=True, window=cfg.window)
            kv = (k, v)
        else:
            k_cache, v_cache = cache
            # the reference pads its cache and writes with
            # dynamic_update_slice, returning a new array; here the cache
            # was allocated once at max_len and slot ``pos`` is written in
            # place
            k_cache[:, pos:pos + S] = k
            v_cache[:, pos:pos + S] = v
            o = L.decode_attention(q, k_cache, v_cache, pos + S)
            kv = None
        out = o.to(h.dtype).reshape(B, S, -1) @ p["wo"].reshape(-1, D)
        return h + out, kv

    def _mlp(self, p, h):
        x = L.rms_norm(h, p["ln_mlp"], self.cfg.norm_eps)
        return h + L.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])

    # ------------------------------------------------------------ train
    def _block(self, p, h, positions):
        h, _ = self._attention(p, h, positions)
        return self._mlp(p, h)

    def hidden_states(self, batch: dict):
        """Final-layer hidden states (B, S, D), normed, and the MoE aux
        loss (0: no MoE layers)."""
        top = self.top.tensors()
        tokens = self._tokens(batch["tokens"])
        h = top["embed"][tokens]
        B, S = tokens.shape
        positions = torch.arange(S, device=h.device).expand(B, S)
        for layer in self.layers:
            h = checkpoint(self._block, layer.tensors(), h, positions,
                           use_reentrant=False)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return L.rms_norm(h, top["final_norm"], self.cfg.norm_eps), aux

    # ------------------------------------------------------------- serve
    def cache_spec(self, batch_size: int, max_len: int) -> dict:
        """(shape, dtype) of each cache buffer; the KV cache is bf16."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {"dense": {"k": (shape, torch.bfloat16),
                          "v": (shape, torch.bfloat16)}}

    def init_cache(self, batch_size: int, max_len: int, dtype=None) -> dict:
        """Zeroed cache on the model's device (``dtype`` overrides the
        spec's bf16: the prefill of an fp32 model keeps fp32 k/v, as the
        reference's prefill returns its activations' type)."""
        device = self.top.embed.device
        return {
            grp: {
                name: torch.zeros(shape, dtype=dtype or dt, device=device)
                for name, (shape, dt) in bufs.items()
            }
            for grp, bufs in self.cache_spec(batch_size, max_len).items()
        }

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None):
        """Run the prompt: returns (cache with ``max_len`` slots, the
        first ``S`` filled, and last-position logits (B, V) fp32)."""
        cfg = self.cfg
        top = self.top.tensors()
        h = top["embed"][tokens]
        B, S = tokens.shape
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} < prompt length {S}")
        positions = torch.arange(S, device=h.device).expand(B, S)
        cache = self.init_cache(B, max_len, dtype=h.dtype)
        ck, cv = cache["dense"]["k"], cache["dense"]["v"]
        for i, layer in enumerate(self.layers):
            p = layer.tensors()
            h, (k, v) = self._attention(p, h, positions)
            ck[i, :, :S] = k
            cv[i, :, :S] = v
            h = self._mlp(p, h)
        h = L.rms_norm(h, top["final_norm"], cfg.norm_eps)
        logits = h[:, -1] @ self.head_weights(top)
        return cache, logits.float()

    @torch.inference_mode()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """tokens (B, 1) at position ``pos`` → (logits (B, V) fp32, cache),
        the cache updated in place."""
        cfg = self.cfg
        top = self.top.tensors()
        h = top["embed"][tokens]
        B = tokens.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.long, device=h.device)
        ck, cv = cache["dense"]["k"], cache["dense"]["v"]
        for i, layer in enumerate(self.layers):
            p = layer.tensors()
            h, _ = self._attention(p, h, positions, cache=(ck[i], cv[i]),
                                   pos=pos)
            h = self._mlp(p, h)
        h = L.rms_norm(h, top["final_norm"], cfg.norm_eps)
        logits = h[:, 0] @ self.head_weights(top)
        return logits.float(), cache
