"""Decoder-only LM (dense / MoE / VLM): serving and training.

Counterpart of the reference's ``DecoderLM`` (``models/lm.py``):
prefill, ``decode_step``, ``cache_spec`` and ``init_cache``, and for
training ``hidden_states`` and ``loss``.  The reference stacks the
layers' parameters on a leading axis for ``lax.scan`` (``dense_layers``,
then ``moe_layers`` for an MoE model); here each layer is a module of
its own in one flat list, the first ``first_k_dense`` holding a SwiGLU
MLP and the rest the router, the routed experts and any shared experts,
and the stack is a Python loop, each layer under
``torch.utils.checkpoint`` when training (the reference's
``jax.checkpoint``: the same values, other memory).  The KV cache keeps
the reference's groups, ``"dense"`` and ``"moe"``.

Serving conventions (as in the reference):
  prefill:  tokens (B, S) | embeds (B, S, D) [+ positions (3, B, S) for
            M-RoPE] → (cache, last-position logits (B, V) fp32)
  decode:   (cache, tokens (B, 1), pos [, mrope positions (3, B, 1)])
            → (logits (B, V) fp32, cache)
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..parallel import sharding
from . import layers as L
from .params import ParamDef, TrainableLM, param_modules


def _attn_defs(cfg: ArchConfig) -> dict:
    D, H, KV, hd = (
        cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
    )
    d = {
        "wq": ParamDef((D, H, hd), logical=("fsdp", "tp", None)),
        "wk": ParamDef((D, KV, hd), logical=("fsdp", "tp", None)),
        "wv": ParamDef((D, KV, hd), logical=("fsdp", "tp", None)),
        "wo": ParamDef((H, hd, D), logical=("tp", None, "fsdp")),
        "ln_attn": ParamDef((D,), init="ones", logical=(None,)),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((hd,), init="ones", logical=(None,))
        d["k_norm"] = ParamDef((hd,), init="ones", logical=(None,))
    return d


def _mlp_defs(cfg: ArchConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((D, F), logical=("fsdp", "tp")),
        "w_up": ParamDef((D, F), logical=("fsdp", "tp")),
        "w_down": ParamDef((F, D), logical=("tp", "fsdp")),
        "ln_mlp": ParamDef((D,), init="ones", logical=(None,)),
    }


def _moe_defs(cfg: ArchConfig) -> dict:
    D, E, Fm = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    d = {
        "router": ParamDef((D, E), scale=0.02, logical=("fsdp", None)),
        "e_gate": ParamDef((E, D, Fm), logical=("ep", "fsdp", None)),
        "e_up": ParamDef((E, D, Fm), logical=("ep", "fsdp", None)),
        "e_down": ParamDef((E, Fm, D), logical=("ep", None, "fsdp")),
        "ln_mlp": ParamDef((D,), init="ones", logical=(None,)),
    }
    if cfg.num_shared_experts:
        Fs = Fm * cfg.num_shared_experts
        d["s_gate"] = ParamDef((D, Fs), logical=("fsdp", "tp"))
        d["s_up"] = ParamDef((D, Fs), logical=("fsdp", "tp"))
        d["s_down"] = ParamDef((Fs, D), logical=("tp", "fsdp"))
    return d


def num_dense_layers(cfg: ArchConfig) -> int:
    """Layers with a dense MLP, the first of the stack: ``first_k_dense``
    for an MoE model, every layer otherwise."""
    return cfg.first_k_dense if cfg.num_experts else cfg.num_layers


def param_defs(cfg: ArchConfig) -> dict:
    """``{"embed", "final_norm", ["head"], "layers": [per-layer dict]}``
    of :class:`ParamDef` (the reference's declarations, unstacked: its
    ``dense_layers`` rows, then its ``moe_layers`` rows)."""
    D, V = cfg.d_model, cfg.vocab_size
    defs: dict = {
        "embed": ParamDef((V, D), scale=0.02, logical=("tp", "fsdp")),
        "final_norm": ParamDef((D,), init="ones", logical=(None,)),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((D, V), scale=0.02, logical=("fsdp", "tp"))
    n_dense = num_dense_layers(cfg)
    defs["layers"] = [
        {**_attn_defs(cfg),
         **(_mlp_defs(cfg) if i < n_dense else _moe_defs(cfg))}
        for i in range(cfg.num_layers)
    ]
    return defs


def cache_spec(cfg: ArchConfig, batch_size: int, max_len: int) -> dict:
    """(shape, dtype, logical axes) of each KV cache buffer, grouped as
    the reference's: ``"dense"`` (the dense-MLP layers) and ``"moe"``
    (the rest), bf16, ``max_len`` slots (no registered config of this
    family has a window; the reference takes ``min(window, max_len)``)."""
    n_dense = num_dense_layers(cfg)

    def kv(n):
        shape = (n, batch_size, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        leaf = (shape, torch.bfloat16, ("layer", "dp", "sp", None, None))
        return {"k": leaf, "v": leaf}

    spec = {}
    if n_dense:
        spec["dense"] = kv(n_dense)
    if cfg.num_layers > n_dense:
        spec["moe"] = kv(cfg.num_layers - n_dense)
    return spec


class DecoderLM(TrainableLM):
    """Dense / MoE / VLM decoder-only transformer.  ``params`` is the
    nested dict ``{"embed", "final_norm", ["head"], "layers": [per-layer
    dict]}`` (see :func:`repro_torch.interop.lm_params_from_numpy`);
    without it the weights are drawn from ``generator``."""

    def __init__(self, cfg: ArchConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"DecoderLM serves families 'dense' and 'moe', not "
                f"{cfg.family!r}")
        self.cfg = cfg
        self.n_dense = num_dense_layers(cfg)
        self.top, stacks = param_modules(param_defs(cfg), params,
                                         generator)
        self.layers = stacks["layers"]

    def head_weights(self, top: dict) -> torch.Tensor:
        return top["embed"].T if self.cfg.tie_embeddings else top["head"]

    # ------------------------------------------------------------ blocks
    def _attention(self, p, h, positions, cache=None, pos=None,
                   mrope_positions=None, tp=None):
        """One attention block.  Prefill (``cache is None``) returns the
        layer's (k, v); decode writes this token's k/v into the
        preallocated ``cache`` at slot ``pos`` in place.  With ``tp``
        (the sharded step) the heads may be this rank's share
        (:meth:`_attend`)."""
        y, kv = self._attend(p, h, positions, cache, pos, mrope_positions,
                             tp)
        return h + y, kv

    def _attend(self, p, h, positions, cache=None, pos=None,
                mrope_positions=None, tp=None):
        """The attention block's output projection (before the residual)
        and its (k, v) (``None`` in decode): :func:`~repro_torch.models.
        layers.attention`, on this rank's heads where ``tp`` splits
        ``wq``/``wo``."""
        cfg = self.cfg
        attend = None if cache is None else L.cache_attend(cache, pos)
        # q, k and v read one copy of the input in the weights' type (an
        # fp32 VLM's bf16 embeds promoted once), the output rounded to the
        # residual's
        x = L.promoted(L.rms_norm(h, p["ln_attn"], cfg.norm_eps), p["wq"])
        y, kv = L.attention(
            x, p["wq"], p["wk"], p["wv"], p["wo"], num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, positions=positions,
            mrope_positions=mrope_positions if cfg.mrope else None,
            rope_theta=cfg.rope_theta, q_norm=p.get("q_norm"),
            k_norm=p.get("k_norm"), eps=cfg.norm_eps, window=cfg.window,
            attend=attend, out_dtype=h.dtype, tp=tp)
        return y, (kv if cache is None else None)

    def _mlp(self, p, h, moe: bool, group=None, tp=None):
        """The MLP block with its residual: (h, aux) (:meth:`_mlp_out`)."""
        y, aux = self._mlp_out(p, h, moe, group, tp)
        return h + y, aux

    def _mlp_out(self, p, h, moe: bool, group=None, tp=None):
        """The MLP block's output before the residual: SwiGLU, or the
        routed experts plus the shared ones, routed over the batch's
        process ``group`` where one is given (:func:`~repro_torch.models.
        layers.moe_layer`), and the MoE aux loss (0 for a dense layer).
        With ``tp`` (the sharded step) the SwiGLUs (the dense one, the
        shared experts) may run on the rank's columns (:func:`~repro_torch.
        models.layers.ffn`) and the routed experts on the rank's experts,
        the routing whole on every rank; where both split, the input
        enters the region once for both, and their partial outputs are
        summed over the ranks by one all-reduce (:func:`~repro_torch.
        models.layers.tp_combine`)."""
        cfg = self.cfg
        x = L.rms_norm(h, p["ln_mlp"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if not moe:
            return L.ffn(x, p["w_gate"], p["w_up"], p["w_down"], cfg.d_ff,
                         tp), aux
        width = (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts
        routed = sharding.splits(tp, p["e_gate"].shape[0], cfg.num_experts)
        shared = bool(width) and sharding.splits(tp, p["s_gate"].shape[1],
                                                 width)
        # where both branches split, x enters the region once for both
        rows = sharding.tp_enter(x, tp) if routed and shared else None
        y, aux = L.moe_layer(
            x, p["router"], p["e_gate"], p["e_up"], p["e_down"],
            top_k=cfg.experts_per_token, group=group, tp=tp, rows=rows,
        )
        parts = [(y, routed)]
        if width:
            parts.append((L.ffn(x if rows is None else rows, p["s_gate"],
                                p["s_up"], p["s_down"], width, tp,
                                leave=False, entered=rows is not None),
                          shared))
        return L.tp_combine(parts, tp), aux

    def _embed(self, top: dict, tokens, embeds):
        """The first hidden states: ``embeds`` cast to bf16 whatever the
        model's type (the reference's stub frontend), else the embedding
        rows of ``tokens`` (:meth:`_token_rows`)."""
        if embeds is not None:
            return torch.as_tensor(embeds, device=top["embed"].device).to(
                torch.bfloat16)
        return self._token_rows(top["embed"], tokens)

    # ------------------------------------------------------------ train
    def _block(self, p, h, positions, moe, mrope_positions, group=None):
        """One layer in training: its blocks gathered here, inside the
        checkpoint, so that the recomputation gathers them again and
        nothing whole outlives the layer."""
        p = self._gathered(p)
        h, _ = self._attention(p, h, positions,
                               mrope_positions=mrope_positions, tp=self._tp)
        return self._mlp(p, h, moe, group, self._tp)

    def hidden_states(self, batch: dict, group=None):
        """Final-layer hidden states (B, S, D), normed, and the MoE aux
        loss summed over the MoE layers (0 without them).  ``batch``
        holds ``tokens`` (B, S) or ``embeds`` (B, S, D), and for M-RoPE
        ``positions`` (3, B, S); ``group`` is the process group the batch
        is split over, if any, which the MoE layers route over."""
        top = self.top.tensors()
        embeds = batch.get("embeds")
        tokens = None if embeds is not None else self._tokens(batch["tokens"])
        h = self._embed(top, tokens, embeds)
        B, S = h.shape[:2]
        positions = torch.arange(S, device=h.device).expand(B, S)
        mrope_positions = self._positions(batch.get("positions"))
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, layer in enumerate(self.layers):
            h, a = checkpoint(self._block, layer.tensors(), h, positions,
                              i >= self.n_dense, mrope_positions, group,
                              use_reentrant=False)
            aux = aux + a
        return L.rms_norm(h, self._gathered(top["final_norm"]),
                          self.cfg.norm_eps), aux

    def _positions(self, positions):
        """M-RoPE positions as a long tensor on the model's device (None
        unless the model uses M-RoPE and they were given)."""
        if not self.cfg.mrope or positions is None:
            return None
        return torch.as_tensor(positions, device=self.top.embed.device).long()

    # ------------------------------------------------------------- serve
    def cache_spec(self, batch_size: int, max_len: int) -> dict:
        """(shape, dtype) of each cache buffer (:func:`cache_spec`)."""
        return {grp: {name: leaf[:2] for name, leaf in bufs.items()}
                for grp, bufs in cache_spec(self.cfg, batch_size,
                                            max_len).items()}

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

    def _slot(self, cache: dict, i: int):
        """Layer ``i``'s (k, v) buffers in ``cache``."""
        grp, j = ("dense", i) if i < self.n_dense else ("moe", i - self.n_dense)
        return cache[grp]["k"][j], cache[grp]["v"][j]

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor | None, max_len: int | None = None,
                *, embeds: torch.Tensor | None = None,
                positions: torch.Tensor | None = None):
        """Run the prompt, ``tokens`` (B, S) or ``embeds`` (B, S, D),
        with M-RoPE ``positions`` (3, B, S) where the model uses them:
        returns (cache with ``max_len`` slots, the first ``S`` filled,
        and last-position logits (B, V) fp32)."""
        cfg = self.cfg
        top = self.top.tensors()
        h = self._embed(top, tokens, embeds)
        B, S = h.shape[:2]
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} < prompt length {S}")
        pos = torch.arange(S, device=h.device).expand(B, S)
        mrope_positions = self._positions(positions)
        # k/v take the type of the projections' product, as the
        # reference's prefill returns them
        cache = self.init_cache(B, max_len, dtype=torch.promote_types(
            h.dtype, top["embed"].dtype))
        for i, layer in enumerate(self.layers):
            p = layer.tensors()
            h, (k, v) = self._attention(p, h, pos,
                                        mrope_positions=mrope_positions)
            ck, cv = self._slot(cache, i)
            ck[:, :S] = k
            cv[:, :S] = v
            h, _ = self._mlp(p, h, i >= self.n_dense)
        h = L.rms_norm(h, top["final_norm"], cfg.norm_eps)
        logits = L.promoted(h[:, -1], top["embed"]) @ self.head_weights(top)
        return cache, logits.float()

    @torch.inference_mode()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int,
                    mrope_positions: torch.Tensor | None = None):
        """tokens (B, 1) at position ``pos`` (and M-RoPE positions (3, B,
        1) where the model uses them) → (logits (B, V) fp32, cache), the
        cache updated in place."""
        cfg = self.cfg
        top = self.top.tensors()
        h = top["embed"][tokens]
        B = tokens.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.long, device=h.device)
        mrope_positions = self._positions(mrope_positions)
        for i, layer in enumerate(self.layers):
            p = layer.tensors()
            h, _ = self._attention(p, h, positions, cache=self._slot(cache, i),
                                   pos=pos, mrope_positions=mrope_positions)
            h, _ = self._mlp(p, h, i >= self.n_dense)
        h = L.rms_norm(h, top["final_norm"], cfg.norm_eps)
        logits = h[:, 0] @ self.head_weights(top)
        return logits.float(), cache
