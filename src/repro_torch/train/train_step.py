"""Train and serve step builders.

Counterpart of the reference's ``train/train_step.py``:
``make_train_step(model, opt_cfg)`` returns ``(state, batch) -> (state,
metrics)``: the model's loss, ``loss.backward()`` (the attention and SSD
kernels' backward passes on the card), then the AdamW update.  The
reference's step is a pure function of its state; here the state's
``params`` are the model's own parameters (:meth:`param_tree`), which the
step updates in place, so ``state`` and ``model`` must belong together
(:func:`init_state` makes them so).

``abstract_state`` and ``state_logical`` (the sharded jit and dry-run's
abstract trees) come with the sharding layer, ROADMAP.md queue 1 item
11.6.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import tree
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
