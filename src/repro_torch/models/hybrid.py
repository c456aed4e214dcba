"""Zamba2-style hybrid: a Mamba-2 backbone and one *shared* attention block.

Counterpart of the reference's ``ZambaLM`` (``models/hybrid.py``): the
backbone is ``num_layers`` Mamba-2 layers (:func:`repro_torch.models.
ssm_model.mamba_block`, the SSM family's own), and after every
``attn_every`` of them one shared transformer block (attention with a
sliding window of ``cfg.window`` keys, then a SwiGLU MLP; one weight set,
zamba's signature trick) is applied, each application with its own KV
cache.  Layer ``g·attn_every + i`` is row ``i`` of group ``g`` in the
reference's doubly stacked ``groups``; the ``tail`` layers after the last
group have no shared block after them.  For zamba2-7b (81 layers,
``attn_every`` 6): 13 groups of 6 mamba layers and the shared block,
then 3 tail layers.  Here the parameters are ``{"embed", "final_norm",
"head", "shared": {...}, "layers": [dict per mamba layer]}`` and the
stack is a Python loop (the reference scans its stacked groups).

The KV cache of each application is a ring of ``eff = min(window,
max_len)`` slots: position ``p`` lives in slot ``p % eff``, so decode at
``pos`` overwrites the oldest key, and attends to ``min(pos + 1, eff)``
slots (slot order does not matter to the softmax; keys carry their RoPE
phase from write time).  The prefill lays its last ``eff`` keys out by
the same rule.  The reference lays them out as ``k[:, -eff:]``, which is
the same layout when ``S <= eff`` or ``S % eff == 0``, and evicts the
wrong key in decode for any other prompt length; the port keeps the
correct eviction (ROADMAP.md, "Divergences kept as found").

Cache keys and types are the reference's: ``ssm`` fp32, ``conv_x`` and
``conv_bc`` bf16, stacked (groups, attn_every, ...); ``attn_k`` and
``attn_v`` (groups, B, eff, kv heads, head dim), bf16 by default
(:meth:`ZambaLM.init_cache`'s ``dtype`` overrides it); ``tail_*`` for the
tail layers.  The prefill keeps k/v in the activations' type, as
:class:`~repro_torch.models.lm.DecoderLM`'s does: an fp32 model decodes
from an fp32 cache (the reference rounds its prefill cache to bf16, and
its decode cannot take an fp32 model).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import layers as L
from .lm import _attn_defs, _mlp_defs
from .params import ParamDef, TrainableLM, param_modules
from .ssm_model import mamba_block, mamba_defs

_STATE = ("ssm", "conv_x", "conv_bc")


def param_defs(cfg: ArchConfig) -> dict:
    """``{"embed", "final_norm", "head", "shared", "layers": [per-layer
    dict]}`` of :class:`ParamDef` (the reference's declarations, its
    ``groups`` and ``tail`` rows unstacked in layer order)."""
    D, V = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamDef((V, D), scale=0.02, logical=("tp", "fsdp")),
        "final_norm": ParamDef((D,), init="ones", logical=(None,)),
        "head": ParamDef((D, V), scale=0.02, logical=("fsdp", "tp")),
        "shared": {**_attn_defs(cfg), **_mlp_defs(cfg)},
        "layers": [mamba_defs(cfg) for _ in range(cfg.num_layers)],
    }


def cache_spec(cfg: ArchConfig, batch_size: int, max_len: int) -> dict:
    """(shape, dtype, logical axes) of each cache buffer, the reference's
    keys and types; the rings hold ``min(window, max_len)`` slots."""
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    K, N = cfg.ssm_conv, cfg.ssm_state
    n_groups = cfg.num_layers // cfg.attn_every
    n_tail = cfg.num_layers - n_groups * cfg.attn_every
    eff = min(cfg.window, max_len) if cfg.window else max_len
    kv = ((n_groups, batch_size, eff, cfg.num_kv_heads,
           cfg.resolved_head_dim), torch.bfloat16,
          ("layer", "dp", "sp", None, None))
    spec = {}
    for pre, lead, axes in (("", (n_groups, cfg.attn_every), ("layer", None)),
                            ("tail_", (n_tail,), ("layer",))):
        if lead[0] == 0:
            continue
        spec[pre + "ssm"] = (lead + (batch_size, nheads, N, cfg.ssm_head_dim),
                             torch.float32, axes + ("dp", "tp", None, None))
        spec[pre + "conv_x"] = (lead + (batch_size, K - 1, d_inner),
                                torch.bfloat16, axes + ("dp", None, "tp"))
        spec[pre + "conv_bc"] = (lead + (batch_size, K - 1, 2 * N),
                                 torch.bfloat16, axes + ("dp", None, "tp"))
        if not pre:
            spec["attn_k"] = spec["attn_v"] = kv
    return spec


class ZambaLM(TrainableLM):
    """Zamba2 hybrid LM.  ``params`` is ``{"embed", "final_norm", "head",
    "shared": {...}, "layers": [per-layer dict]}``; without it the weights
    are drawn from ``generator``."""

    def __init__(self, cfg: ArchConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"ZambaLM serves family 'hybrid', not "
                             f"{cfg.family!r}")
        if cfg.attn_every <= 0:
            raise ValueError(f"attn_every {cfg.attn_every}: want > 0")
        self.cfg = cfg
        self.n_groups = cfg.num_layers // cfg.attn_every
        self.n_tail = cfg.num_layers - self.n_groups * cfg.attn_every
        self.top, stacks = param_modules(param_defs(cfg), params,
                                         generator)
        self.layers = stacks["layers"]

    def head_weights(self, top: dict) -> torch.Tensor:
        return top["head"]

    def _group_after(self, j: int) -> int | None:
        """The group whose shared block follows mamba layer ``j`` (None
        inside a group and in the tail)."""
        ae = self.cfg.attn_every
        if j < self.n_groups * ae and j % ae == ae - 1:
            return j // ae
        return None

    # ------------------------------------------------------------ blocks
    def _shared_attn(self, sp, h, positions, cache=None, pos=None, tp=None):
        """The shared block: windowed attention, then the MLP.  Prefill
        (``cache is None``) returns this application's (k, v); decode
        writes this token's k/v into ring slot ``pos % eff`` of
        ``cache`` in place.  With ``tp`` (the sharded step) both run on
        this rank's heads and FFN columns where it splits them."""
        cfg = self.cfg
        attend = None
        if cache is not None:
            def attend(q, k, v):
                k_ring, v_ring = cache
                eff = k_ring.shape[1]
                k_ring[:, pos % eff] = k[:, 0]
                v_ring[:, pos % eff] = v[:, 0]
                return L.decode_attention(q, k_ring, v_ring,
                                          min(pos + 1, eff))
        y, kv = self._attend(sp, h, positions, attend, tp)
        h = h + y
        x = L.rms_norm(h, sp["ln_mlp"], cfg.norm_eps)
        h = h + L.ffn(x, sp["w_gate"], sp["w_up"], sp["w_down"], cfg.d_ff,
                      tp)
        return h, (kv if cache is None else None)

    def _attend(self, sp, h, positions, attend=None, tp=None):
        """The shared block's windowed attention (before the residual)
        and its (k, v): :func:`~repro_torch.models.layers.attention`,
        on this rank's heads where ``tp`` splits them."""
        cfg = self.cfg
        return L.attention(
            L.rms_norm(h, sp["ln_attn"], cfg.norm_eps), sp["wq"], sp["wk"],
            sp["wv"], sp["wo"], num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, positions=positions,
            rope_theta=cfg.rope_theta, window=cfg.window, attend=attend,
            tp=tp)

    def _mamba(self, p, h):
        """Mamba layer ``p`` in training: its blocks gathered here (the
        sharded step), so that under a checkpoint nothing whole outlives
        it, the mixer on this rank's heads where the step splits them."""
        return mamba_block(self.cfg, self._gathered(p), h, tp=self._tp)[0]

    def _shared(self, p, h, positions):
        """One application of the shared block in training, gathered as
        :meth:`_mamba` gathers a layer."""
        return self._shared_attn(self._gathered(p), h, positions,
                                 tp=self._tp)[0]

    # ------------------------------------------------------------ train
    def blocks(self, positions: torch.Tensor) -> list:
        """The residual stream's blocks in order, as ``(kind, fn,
        params)`` with ``h = fn(params, h)``: each mamba layer
        (``"mamba"``, :meth:`_mamba`), and the shared block (``"shared"``,
        :meth:`_shared` at ``positions`` (B, S)) after each group's last
        layer.  Each ``fn`` gathers its blocks first and computes on this
        rank's "model" shard where the sharded step splits the products
        (the mixer's heads, the shared block's heads and FFN columns)."""
        shared = self.top.tensors()["shared"]
        out = []
        for j, layer in enumerate(self.layers):
            out.append(("mamba", self._mamba, layer.tensors()))
            if self._group_after(j) is not None:
                out.append(("shared", lambda p, h: self._shared(
                    p, h, positions), shared))
        return out

    def hidden_states(self, batch: dict, group=None):
        """Final-layer hidden states (B, S, D), normed, and aux 0; each of
        :meth:`blocks` under ``torch.utils.checkpoint`` (the mamba layers
        through K5's forward and backward, the shared block's windowed
        attention through K4's).  ``group`` (the
        batch's process group) is unused: nothing is routed."""
        top = self.top.tensors()
        h = self._token_rows(top["embed"], self._tokens(batch["tokens"]))
        B, S = h.shape[:2]
        positions = torch.arange(S, device=h.device).expand(B, S)
        for _, fn, p in self.blocks(positions):
            h = checkpoint(fn, p, h, use_reentrant=False)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return L.rms_norm(h, self._gathered(top["final_norm"]),
                          self.cfg.norm_eps), aux

    # ------------------------------------------------------------- serve
    def cache_spec(self, batch_size: int, max_len: int) -> dict:
        """(shape, dtype) of each cache buffer (:func:`cache_spec`)."""
        return {name: leaf[:2] for name, leaf in
                cache_spec(self.cfg, batch_size, max_len).items()}

    def init_cache(self, batch_size: int, max_len: int, dtype=None) -> dict:
        """Zeroed cache on the model's device; ``dtype`` overrides the
        KV rings' bf16 (the SSM state stays fp32, the conv carries
        bf16)."""
        device = self.top.embed.device
        return {
            name: torch.zeros(shape, device=device,
                              dtype=dtype if dtype and name.startswith("attn")
                              else dt)
            for name, (shape, dt) in self.cache_spec(batch_size,
                                                     max_len).items()
        }

    def _state(self, cache: dict, j: int) -> list:
        """Mamba layer ``j``'s (ssm, conv_x, conv_bc) buffers in
        ``cache`` (views: row ``j % attn_every`` of group ``j //
        attn_every``, or a tail row)."""
        ae = self.cfg.attn_every
        if j < self.n_groups * ae:
            pre, idx = "", divmod(j, ae)
        else:
            pre, idx = "tail_", (j - self.n_groups * ae,)
        return [cache[pre + name][idx] for name in _STATE]

    @staticmethod
    def _store(state: list, s2, c2) -> None:
        for buf, new in zip(state, (s2, *c2)):
            buf.copy_(new)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None):
        """Run the prompt: returns (cache, last-position logits (B, V)
        fp32).  Each ring holds the prompt's last ``eff`` keys and
        values at slots ``position % eff``."""
        cfg = self.cfg
        top = self.top.tensors()
        h = top["embed"][tokens]
        B, S = tokens.shape
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} < prompt length {S}")
        cache = self.init_cache(B, max_len, dtype=h.dtype)
        eff = cache["attn_k"].shape[2] if "attn_k" in cache else S
        kept = min(S, eff)  # the keys the rings keep: the last ``kept``
        slots = torch.arange(S - kept, S, device=h.device) % eff
        positions = torch.arange(S, device=h.device).expand(B, S)
        for j, layer in enumerate(self.layers):
            h, s2, c2 = mamba_block(cfg, layer.tensors(), h)
            self._store(self._state(cache, j), s2, c2)
            g = self._group_after(j)
            if g is not None:
                h, (k, v) = self._shared_attn(top["shared"], h, positions)
                cache["attn_k"][g].index_copy_(1, slots, k[:, S - kept:])
                cache["attn_v"][g].index_copy_(1, slots, v[:, S - kept:])
        h = L.rms_norm(h, top["final_norm"], cfg.norm_eps)
        return cache, (h[:, -1] @ top["head"]).float()

    @torch.inference_mode()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """tokens (B, 1) at position ``pos`` → (logits (B, V) fp32,
        cache), the state carries and KV rings updated in place."""
        cfg = self.cfg
        top = self.top.tensors()
        h = top["embed"][tokens]
        positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.long,
                               device=h.device)
        for j, layer in enumerate(self.layers):
            state = self._state(cache, j)
            h, s2, c2 = mamba_block(cfg, layer.tensors(), h,
                                    ssm_state=state[0],
                                    conv_state=(state[1], state[2]))
            self._store(state, s2, c2)
            g = self._group_after(j)
            if g is not None:
                h, _ = self._shared_attn(
                    top["shared"], h, positions, pos=pos,
                    cache=(cache["attn_k"][g], cache["attn_v"][g]))
        h = L.rms_norm(h, top["final_norm"], cfg.norm_eps)
        return (h[:, 0] @ top["head"]).float(), cache
