"""Mamba-2 (SSD) language model — attention-free, O(1)-state decode.

Counterpart of the reference's ``MambaLM`` (``models/ssm_model.py``):
serving (prefill and ``decode_step`` with the SSM state and the two conv
carries) and training (``hidden_states``, ``loss``; each layer under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).  One
module per layer (the reference scans stacked parameters).  The conv carries are stored in bf16, as the reference
stores them, whatever the activation type.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import layers as L
from .params import ParamDef, TrainableLM, param_modules


def mamba_defs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    d_inner = cfg.ssm_expand * D
    nheads = d_inner // cfg.ssm_head_dim
    N2 = 2 * cfg.ssm_state
    return {
        "w_z": ParamDef((D, d_inner), logical=("fsdp", "tp")),
        "w_x": ParamDef((D, d_inner), logical=("fsdp", "tp")),
        "w_bc": ParamDef((D, N2), logical=("fsdp", "tp")),
        "w_dt": ParamDef((D, nheads), logical=("fsdp", "tp")),
        "conv_x": ParamDef((d_inner, cfg.ssm_conv), scale=0.5,
                           logical=("tp", None)),
        "conv_bc": ParamDef((N2, cfg.ssm_conv), scale=0.5,
                            logical=("tp", None)),
        "dt_bias": ParamDef((nheads,), init="zeros", logical=("tp",)),
        "a_log": ParamDef((nheads,), init="zeros", logical=("tp",)),
        "norm": ParamDef((d_inner,), init="ones", logical=("tp",)),
        "w_out": ParamDef((d_inner, D), logical=("tp", "fsdp")),
        "ln": ParamDef((D,), init="ones", logical=(None,)),
    }


def mamba_block(cfg: ArchConfig, p: dict, h: torch.Tensor, ssm_state=None,
                conv_state=None, tp=None):
    """One Mamba-2 layer on the residual stream ``h``: pre-norm, the
    mixer, the residual add (the reference's ``_mix``, which its hybrid's
    ``_mamba`` repeats).  Returns (h, ssm_state, (conv_x, conv_bc)).
    With ``tp`` (the sharded step) the mixer runs on this rank's heads
    where ``p`` holds them (:func:`~repro_torch.models.layers.
    mamba2_mix`)."""
    x = L.rms_norm(h, p["ln"], cfg.norm_eps)
    y, (s2, c2) = L.mamba2_mix(
        x, p, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
        expand=cfg.ssm_expand, ssm_state=ssm_state, conv_state=conv_state,
        tp=tp,
    )
    return h + y, s2, c2


def param_defs(cfg: ArchConfig) -> dict:
    """``{"embed", "final_norm", ["head"], "layers": [per-layer dict]}``
    of :class:`ParamDef` (the reference's declarations, unstacked)."""
    defs: dict = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), scale=0.02,
                          logical=("tp", "fsdp")),
        "final_norm": ParamDef((cfg.d_model,), init="ones",
                               logical=(None,)),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size), scale=0.02,
                                logical=("fsdp", "tp"))
    defs["layers"] = [mamba_defs(cfg) for _ in range(cfg.num_layers)]
    return defs


def cache_spec(cfg: ArchConfig, batch_size: int, max_len: int) -> dict:
    """(shape, dtype, logical axes) of each state buffer: the SSM state
    fp32, the conv carries bf16 (independent of ``max_len``: the state is
    O(1) in the sequence)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    n, K = cfg.num_layers, cfg.ssm_conv
    return {
        "ssm": ((n, batch_size, nheads, cfg.ssm_state, cfg.ssm_head_dim),
                torch.float32, ("layer", "dp", "tp", None, None)),
        "conv_x": ((n, batch_size, K - 1, d_inner), torch.bfloat16,
                   ("layer", "dp", None, "tp")),
        "conv_bc": ((n, batch_size, K - 1, 2 * cfg.ssm_state),
                    torch.bfloat16, ("layer", "dp", None, "tp")),
    }


class MambaLM(TrainableLM):
    """Mamba-2 LM.  ``params`` is ``{"embed", "final_norm", ["head"],
    "layers": [per-layer dict]}``; without it the weights are drawn from
    ``generator``."""

    def __init__(self, cfg: ArchConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"MambaLM serves family 'ssm', not {cfg.family!r}")
        self.cfg = cfg
        self.top, stacks = param_modules(param_defs(cfg), params,
                                         generator)
        self.layers = stacks["layers"]

    def head_weights(self, top: dict) -> torch.Tensor:
        return top["embed"].T if self.cfg.tie_embeddings else top["head"]

    # ------------------------------------------------------------ train
    def _block(self, p, h):
        # the layer's blocks gathered inside the checkpoint (the sharded
        # step), the mixer on this rank's heads where it splits them
        return mamba_block(self.cfg, self._gathered(p), h, tp=self._tp)[0]

    def hidden_states(self, batch: dict, group=None):
        """Final-layer hidden states (B, S, D), normed, and aux 0.
        ``group`` (the batch's process group) is unused: nothing is
        routed."""
        top = self.top.tensors()
        h = self._token_rows(top["embed"], self._tokens(batch["tokens"]))
        for layer in self.layers:
            h = checkpoint(self._block, layer.tensors(), h,
                           use_reentrant=False)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return L.rms_norm(h, self._gathered(top["final_norm"]),
                          self.cfg.norm_eps), aux

    # ------------------------------------------------------------- serve
    def cache_spec(self, batch_size: int, max_len: int) -> dict:
        """(shape, dtype) of each state buffer (:func:`cache_spec`)."""
        return {name: leaf[:2] for name, leaf in
                cache_spec(self.cfg, batch_size, max_len).items()}

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        device = self.top.embed.device
        return {
            name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in self.cache_spec(batch_size, max_len).items()
        }

    def _store(self, cache, i, s2, c2) -> None:
        cache["ssm"][i] = s2
        cache["conv_x"][i] = c2[0].to(torch.bfloat16)
        cache["conv_bc"][i] = c2[1].to(torch.bfloat16)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None):
        """Run the prompt: returns (state cache, last-position logits
        (B, V) fp32)."""
        top = self.top.tensors()
        h = top["embed"][tokens]
        cache = self.init_cache(tokens.shape[0], max_len or tokens.shape[1])
        for i, layer in enumerate(self.layers):
            h, s2, c2 = mamba_block(self.cfg, layer.tensors(), h)
            self._store(cache, i, s2, c2)
        h = L.rms_norm(h, top["final_norm"], self.cfg.norm_eps)
        logits = h[:, -1] @ self.head_weights(top)
        return cache, logits.float()

    @torch.inference_mode()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """tokens (B, 1) → (logits (B, V) fp32, cache), the state carries
        updated in place (``pos`` is unused: the state has no slots)."""
        top = self.top.tensors()
        h = top["embed"][tokens]
        for i, layer in enumerate(self.layers):
            h, s2, c2 = mamba_block(
                self.cfg, layer.tensors(), h, ssm_state=cache["ssm"][i],
                conv_state=(cache["conv_x"][i], cache["conv_bc"][i]),
            )
            self._store(cache, i, s2, c2)
        h = L.rms_norm(h, top["final_norm"], self.cfg.norm_eps)
        logits = h[:, 0] @ self.head_weights(top)
        return logits.float(), cache
