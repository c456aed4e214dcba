"""Train and serve step builders.

Counterpart of the reference's ``train/train_step.py``:
``make_train_step(model, opt_cfg)`` returns ``(state, batch) -> (state,
metrics)``: the model's loss, ``loss.backward()`` (the attention and SSD
kernels' backward passes on the card), then the AdamW update.  The
reference's step is a pure function of its state; here the state's
``params`` are the model's own parameters (:meth:`param_tree`), which the
step updates in place, so ``state`` and ``model`` must belong together
(:func:`init_state` makes them so).

``abstract_state`` and ``state_logical`` give the training state's meta
tensors and logical axes from a config (or a model's), allocating
nothing: the dry run's state (``repro_torch.launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import tree
from ..configs.base import ArchConfig
from ..models import param_defs
from ..models.params import abstract_params, param_specs
from . import optimizer as opt


@dataclasses.dataclass
class TrainState:
    params: Any  # the model's parameter tree (its own tensors)
    opt: Any  # optimizer state: {"m", "v", "count"}
    step: torch.Tensor  # 0-d int32


def init_state(model, opt_cfg: opt.OptimizerConfig) -> TrainState:
    """The training state of ``model`` (made trainable): its parameters,
    zero moments, step 0."""
    params = model.train_mode(True).param_tree()
    return TrainState(params, opt.init(opt_cfg, params),
                      torch.zeros((), dtype=torch.int32,
                                  device=model.top.embed.device))


def _defs(model_or_cfg) -> dict:
    cfg = (model_or_cfg if isinstance(model_or_cfg, ArchConfig)
           else model_or_cfg.cfg)
    return param_defs(cfg)


def abstract_state(model_or_cfg, opt_cfg: opt.OptimizerConfig) -> TrainState:
    """:func:`init_state`'s state for a config (or a model's config) as
    meta tensors of the declared shapes and dtypes."""
    defs = _defs(model_or_cfg)
    return TrainState(abstract_params(defs),
                      opt.opt_state_abstract(defs, opt_cfg),
                      torch.empty((), dtype=torch.int32, device="meta"))


def state_logical(model_or_cfg, opt_cfg: opt.OptimizerConfig) -> TrainState:
    """The logical axes of :func:`abstract_state`'s leaves."""
    defs = _defs(model_or_cfg)
    return TrainState(param_specs(defs), opt.opt_state_logical(defs, opt_cfg),
                      ())


@torch.no_grad()
def load_state(state: TrainState, saved: TrainState) -> TrainState:
    """``state`` with ``saved``'s values (a checkpoint restored into
    ``state``'s structure on its device): the parameters copied into the
    model's own tensors, the optimizer state and step taken as they
    are."""
    for p, s in zip(tree.leaves(state.params),
                    tree.leaves(saved.params)):
        p.copy_(s)
    return TrainState(state.params, saved.opt, saved.step)


def make_train_step(model, opt_cfg: opt.OptimizerConfig) -> Callable:
    """``(state, batch) -> (state, metrics)``, metrics ``{"loss", "xent",
    "aux", "grad_norm", "lr"}`` as 0-d tensors on the device."""

    def train_step(state: TrainState, batch: dict):
        leaves = tree.leaves(state.params)
        for p in leaves:
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = tree.tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            state.params)
        params, opt_state, opt_metrics = opt.update(
            opt_cfg, grads, state.opt, state.params)
        del grads
        for p in leaves:
            p.grad = None
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}
        return TrainState(params, opt_state, state.step + 1), out

    return train_step


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def make_prefill_step(model) -> Callable:
    """``batch -> (cache, last-position logits)`` (the model holds its
    parameters; the reference's step takes them first)."""

    def prefill_step(batch: dict, max_len: int | None = None):
        extra = {k: batch[k] for k in ("embeds", "positions") if k in batch}
        tokens = batch.get("tokens")
        return model.prefill(None if tokens is None else model._tokens(tokens),
                             max_len, **extra)

    return prefill_step


def make_decode_step(model) -> Callable:
    """``(cache, tokens, pos[, mrope_positions]) -> (logits, cache)``."""

    def decode_step(cache, tokens, pos: int, mrope_positions=None):
        if mrope_positions is None:
            return model.decode_step(cache, model._tokens(tokens), pos)
        return model.decode_step(cache, model._tokens(tokens), pos,
                                 mrope_positions)

    return decode_step
