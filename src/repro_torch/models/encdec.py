"""Encoder-decoder backbone (seamless-m4t-medium): serving and training.

Counterpart of the reference's ``EncDecLM`` (``models/encdec.py``).  The
audio frontend is a stub, as there: the encoder takes precomputed frame
embeddings (B, S_enc, D), cast to bf16 whatever the model's type, and
runs bidirectional (non-causal) self-attention layers, then
``enc_norm``.  Each decoder layer runs causal self-attention (RoPE on q
and k), cross-attention to the encoder's memory (no RoPE; its keys and
values projected from the memory by the layer's ``xk``/``xv``), then a
SwiGLU MLP.  Prefill and training attention go through
:func:`repro_torch.models.layers.blockwise_attention`, so K4 on the card
(``causal=False`` for the encoder and the cross-attention, whose queries
and keys come from sequences of different lengths); decode's two
attentions are the one-query ``decode_attention``, the cross-attention's
over every one of the ``enc_len`` memory slots.

The reference stacks each side's layers for ``lax.scan`` (``enc_layers``,
``dec_layers``); here the parameters are ``{"embed", "enc_norm",
"final_norm", "head", "enc_layers": [dict per encoder layer], "layers":
[dict per decoder layer]}`` and each stack is a Python loop, each layer
under ``torch.utils.checkpoint`` when training.  The cache keys are the
reference's: ``self_k``/``self_v`` (decoder layers, B, max_len, kv heads,
head dim) and ``cross_k``/``cross_v`` (decoder layers, B, enc_len, ...),
bf16 by default.  The prefill keeps k/v in the activations' type, as
:class:`~repro_torch.models.lm.DecoderLM`'s does: an fp32 model decodes
from an fp32 cache (the reference rounds its prefill caches to bf16, and
its decode cannot take an fp32 model; ROADMAP.md, "Divergences kept as
found").

Serving conventions:
  prefill:  tokens (B, S), embeds (B, S_enc, D) → (cache, last-position
            logits (B, V) fp32)
  decode:   (cache, tokens (B, 1), pos) → (logits (B, V) fp32, cache)
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import layers as L
from .lm import _mlp_defs
from .params import ParamDef, TrainableLM, param_modules


def _block_defs(cfg: ArchConfig, cross: bool) -> dict:
    """One layer's declarations (a row of the reference's
    ``_block_defs``): attention and MLP, and for a decoder layer the
    cross-attention's ``xq/xk/xv/xo/ln_x``."""
    D, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    d = {
        "wq": ParamDef((D, H, hd), logical=("fsdp", "tp", None)),
        "wk": ParamDef((D, KV, hd), logical=("fsdp", "tp", None)),
        "wv": ParamDef((D, KV, hd), logical=("fsdp", "tp", None)),
        "wo": ParamDef((H, hd, D), logical=("tp", None, "fsdp")),
        "ln_attn": ParamDef((D,), init="ones", logical=(None,)),
        **_mlp_defs(cfg),
    }
    if cross:
        d.update({
            "xq": ParamDef((D, H, hd), logical=("fsdp", "tp", None)),
            "xk": ParamDef((D, KV, hd), logical=("fsdp", "tp", None)),
            "xv": ParamDef((D, KV, hd), logical=("fsdp", "tp", None)),
            "xo": ParamDef((H, hd, D), logical=("tp", None, "fsdp")),
            "ln_x": ParamDef((D,), init="ones", logical=(None,)),
        })
    return d


def param_defs(cfg: ArchConfig) -> dict:
    """``{"embed", "enc_norm", "final_norm", "head", "enc_layers": [...],
    "layers": [...]}`` of :class:`ParamDef` (the reference's
    declarations, its ``enc_layers`` and ``dec_layers`` rows unstacked)."""
    D, V = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamDef((V, D), scale=0.02, logical=("tp", "fsdp")),
        "enc_norm": ParamDef((D,), init="ones", logical=(None,)),
        "final_norm": ParamDef((D,), init="ones", logical=(None,)),
        "head": ParamDef((D, V), scale=0.02, logical=("fsdp", "tp")),
        "enc_layers": [_block_defs(cfg, cross=False)
                       for _ in range(cfg.encoder_layers)],
        "layers": [_block_defs(cfg, cross=True)
                   for _ in range(cfg.num_layers)],
    }


def cache_spec(cfg: ArchConfig, batch_size: int, max_len: int,
               enc_len: int = 0) -> dict:
    """(shape, dtype, logical axes) of each cache buffer, the reference's
    keys: the decoder's self-attention k/v over ``max_len`` slots and the
    cross-attention's over ``enc_len`` (default ``max_len``), bf16."""
    enc_len = enc_len or max_len

    def kv(s):
        return ((cfg.num_layers, batch_size, s, cfg.num_kv_heads,
                 cfg.resolved_head_dim), torch.bfloat16,
                ("layer", "dp", "sp", None, None))

    return {"self_k": kv(max_len), "self_v": kv(max_len),
            "cross_k": kv(enc_len), "cross_v": kv(enc_len)}


class EncDecLM(TrainableLM):
    """Encoder-decoder transformer.  ``params`` is ``{"embed",
    "enc_norm", "final_norm", "head", "enc_layers": [...], "layers":
    [...]}``; without it the weights are drawn from ``generator``."""

    def __init__(self, cfg: ArchConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM serves family 'encdec', not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.top, stacks = param_modules(param_defs(cfg), params, generator)
        self.enc_layers = stacks["enc_layers"]
        self.layers = stacks["layers"]

    def head_weights(self, top: dict) -> torch.Tensor:
        return top["head"]

    # ------------------------------------------------------------ blocks
    def _attend(self, p, x, *, names=("wq", "wk", "wv", "wo"), **kw):
        """:func:`~repro_torch.models.layers.attention` of the normed
        ``x`` through the weights ``names`` of ``p`` (the self-attention's
        or the cross-attention's ``xq``/``xk``/``xv``/``xo``)."""
        cfg = self.cfg
        return L.attention(x, *(p[n] for n in names),
                           num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads,
                           rope_theta=cfg.rope_theta, eps=cfg.norm_eps, **kw)

    def _self_attn(self, p, h, positions, causal: bool, cache=None,
                   pos=None, tp=None):
        """Self-attention with RoPE.  Prefill (``cache is None``) returns
        the layer's (k, v); decode writes this token's k/v into the
        preallocated ``cache`` at slot ``pos`` in place.  With ``tp`` (the
        sharded step) on this rank's heads where it splits them."""
        attend = None if cache is None else L.cache_attend(cache, pos)
        x = L.rms_norm(h, p["ln_attn"], self.cfg.norm_eps)
        y, kv = self._attend(p, x, positions=positions, causal=causal,
                             attend=attend, tp=tp)
        return h + y, (kv if cache is None else None)

    def _cross_attn(self, p, h, mem_k, mem_v, attend=None, tp=None):
        """Cross-attention to the memory's keys and values (this rank's
        where ``tp`` splits the heads: :meth:`_mem_kv`), non-causal,
        without RoPE; ``attend`` replaces the prefill attention (decode's
        one query over every memory slot)."""
        x = L.rms_norm(h, p["ln_x"], self.cfg.norm_eps)
        y, _ = self._attend(p, x, names=("xq", "xk", "xv", "xo"),
                            kv=(mem_k, mem_v), causal=False, attend=attend,
                            tp=tp)
        return h + y

    def _mem_kv(self, p, mem, tp=None):
        """The memory's keys and values for one decoder layer, on the kv
        heads of this rank's q heads where ``tp`` splits them: the memory
        then passes ``tp_enter`` (it feeds every decoder layer, and each
        layer's ranks hold partial gradients of it)."""
        cfg = self.cfg
        return L.attention_kv(mem, p["xk"], p["xv"], p["xq"].shape[1],
                              cfg.num_heads, cfg.num_kv_heads, tp)

    def _mlp(self, p, h, tp=None):
        x = L.rms_norm(h, p["ln_mlp"], self.cfg.norm_eps)
        return h + L.ffn(x, p["w_gate"], p["w_up"], p["w_down"],
                         self.cfg.d_ff, tp)

    def _enc_block(self, p, h, positions):
        # each block gathers its layer first (the sharded step), inside
        # the checkpoint when training, and computes on its "model" shard
        # where the step splits the products
        tp = self._tp
        p = self._gathered(p)
        h, _ = self._self_attn(p, h, positions, causal=False, tp=tp)
        return self._mlp(p, h, tp)

    def _dec_block(self, p, h, positions, mem):
        tp = self._tp
        p = self._gathered(p)
        h, _ = self._self_attn(p, h, positions, causal=True, tp=tp)
        h = self._cross_attn(p, h, *self._mem_kv(p, mem, tp), tp=tp)
        return self._mlp(p, h, tp)

    @staticmethod
    def _positions(h: torch.Tensor) -> torch.Tensor:
        B, S = h.shape[:2]
        return torch.arange(S, device=h.device).expand(B, S)

    def encode(self, embeds, checkpointed: bool = False) -> torch.Tensor:
        """The encoder's memory (B, S_enc, D), normed, from frame
        embeddings (numpy or a tensor) cast to bf16 whatever the model's
        type (the reference's stub frontend); each layer under
        ``torch.utils.checkpoint`` when ``checkpointed``."""
        top = self.top.tensors()
        h = torch.as_tensor(embeds, device=top["embed"].device).to(
            torch.bfloat16)
        positions = self._positions(h)
        for layer in self.enc_layers:
            if checkpointed:
                h = checkpoint(self._enc_block, layer.tensors(), h, positions,
                               use_reentrant=False)
            else:
                h = self._enc_block(layer.tensors(), h, positions)
        return L.rms_norm(h, self._gathered(top["enc_norm"]),
                          self.cfg.norm_eps)

    # ------------------------------------------------------------ train
    def hidden_states(self, batch: dict, group=None):
        """Final decoder hidden states (B, S, D), normed, and aux 0.
        ``batch`` holds ``embeds`` (B, S_enc, D) for the encoder and
        ``tokens`` (B, S) for the decoder; every layer of both stacks runs
        under ``torch.utils.checkpoint``.  ``group`` (the
        batch's process group) is unused: nothing is routed."""
        top = self.top.tensors()
        mem = self.encode(batch["embeds"], checkpointed=True)
        h = self._token_rows(top["embed"], self._tokens(batch["tokens"]))
        positions = self._positions(h)
        for layer in self.layers:
            h = checkpoint(self._dec_block, layer.tensors(), h, positions,
                           mem, use_reentrant=False)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return L.rms_norm(h, self._gathered(top["final_norm"]),
                          self.cfg.norm_eps), aux

    # ------------------------------------------------------------- serve
    def cache_spec(self, batch_size: int, max_len: int,
                   enc_len: int = 0) -> dict:
        """(shape, dtype) of each cache buffer (:func:`cache_spec`)."""
        return {name: leaf[:2] for name, leaf in
                cache_spec(self.cfg, batch_size, max_len, enc_len).items()}

    def init_cache(self, batch_size: int, max_len: int, enc_len: int = 0,
                   dtype=None) -> dict:
        """Zeroed cache on the model's device (``dtype`` overrides the
        spec's bf16)."""
        device = self.top.embed.device
        return {name: torch.zeros(shape, dtype=dtype or dt, device=device)
                for name, (shape, dt) in self.cache_spec(
                    batch_size, max_len, enc_len).items()}

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None, *,
                embeds=None):
        """Encode ``embeds`` (B, S_enc, D), then run the decoder prompt
        ``tokens`` (B, S): returns (cache with ``max_len`` self-attention
        slots, the first ``S`` filled, and the memory's k/v for every
        decoder layer; last-position logits (B, V) fp32)."""
        if embeds is None:
            raise ValueError("the encoder-decoder's prefill takes embeds")
        cfg = self.cfg
        top = self.top.tensors()
        mem = self.encode(embeds)
        h = top["embed"][tokens]
        B, S = tokens.shape
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} < prompt length {S}")
        positions = self._positions(h)
        # k/v in the activations' type, as the projections return them
        cache = self.init_cache(B, max_len, mem.shape[1], dtype=h.dtype)
        for i, layer in enumerate(self.layers):
            p = layer.tensors()
            h, (k, v) = self._self_attn(p, h, positions, causal=True)
            cache["self_k"][i, :, :S] = k
            cache["self_v"][i, :, :S] = v
            mk, mv = self._mem_kv(p, mem)
            cache["cross_k"][i] = mk
            cache["cross_v"][i] = mv
            h = self._mlp(p, self._cross_attn(p, h, mk, mv))
        h = L.rms_norm(h, top["final_norm"], cfg.norm_eps)
        return cache, (h[:, -1] @ top["head"]).float()

    @torch.inference_mode()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """tokens (B, 1) at position ``pos`` → (logits (B, V) fp32,
        cache), the self-attention cache updated in place; the
        cross-attention reads all of the memory's slots."""
        cfg = self.cfg
        top = self.top.tensors()
        h = top["embed"][tokens]
        positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.long,
                               device=h.device)
        enc_len = cache["cross_k"].shape[2]
        for i, layer in enumerate(self.layers):
            p = layer.tensors()
            h, _ = self._self_attn(p, h, positions, causal=True, pos=pos,
                                   cache=(cache["self_k"][i],
                                          cache["self_v"][i]))
            h = self._cross_attn(
                p, h, cache["cross_k"][i], cache["cross_v"][i],
                attend=lambda q, k, v: L.decode_attention(q, k, v, enc_len))
            h = self._mlp(p, h)
        h = L.rms_norm(h, top["final_norm"], cfg.norm_eps)
        return (h[:, 0] @ top["head"]).float(), cache
