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

Over several processes (the reference's one ``jax.jit`` with
``in_shardings``/``out_shardings`` from the logical specs) a
:class:`TrainLayout` places the state on a live mesh
(``launch.mesh.make_host_mesh``): each rank keeps its blocks of the
parameters and moments under their resolved specs
(``parallel.sharding.Placement``) and a step

  * gathers the blocks into the model's own tensors,
  * runs the forward and ``loss.backward()`` on this rank's rows of the
    global batch (the MoE layers route over the batch's process group),
  * reduces each gradient to the mean over the batch axes, cut to this
    rank's block (a rank's loss is a mean over its tokens, so the mean of
    the ranks' gradients is the gradient of the global batch's mean), and
  * updates its blocks, the clipping norm and the int8 scales those of
    the whole tensors.

Ranks along "model" hold the same batch rows under the default recipe
("dp" resolves to ("pod", "data")): their gradients are equal and are
not summed.  "model" splits only the storage of the weights and moments
here: each is gathered whole for the compute (no Megatron-style product
split over "model", and the whole model is gathered before the forward,
not layer by layer).  On a mesh of one rank every block is the model's
own tensor and the step is :func:`make_train_step`'s plain step, bit for
bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from .. import tree
from ..configs.base import ArchConfig
from ..models import param_defs
from ..models.params import abstract_params, param_specs
from ..parallel.sharding import (
    Placement,
    axes_group,
    batch_axes,
    describe,
    flat_specs,
    resolve_spec,
)
from . import optimizer as opt


@dataclasses.dataclass
class TrainState:
    params: Any  # the model's parameter tree (its own tensors)
    opt: Any  # optimizer state: {"m", "v", "count"}
    step: torch.Tensor  # 0-d int32


def init_state(model, opt_cfg: opt.OptimizerConfig,
               layout: TrainLayout | None = None) -> TrainState:
    """The training state of ``model`` (made trainable): its parameters,
    zero moments, step 0.  With ``layout``, this rank's blocks of them
    (on one rank, the model's own tensors)."""
    params = model.train_mode(True).param_tree()
    if layout is not None:
        params = tree.tree_map(lambda p, pl: pl.block(p), params,
                               layout.places.params)
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


class TrainLayout:
    """A training state's and a batch's layout on a live mesh (a
    ``torch.distributed`` ``DeviceMesh`` spanning the run, axes among
    "pod", "data", "model"): a :class:`~repro_torch.parallel.sharding.
    Placement` for every leaf of the state under ``recipe``'s resolved
    specs (``places``, a :class:`TrainState` of them), the batch's mesh
    axes (``batch_axes``, the logical "dp") and their process group
    (``group``, ``None`` where the batch is not split)."""

    def __init__(self, model_or_cfg, opt_cfg: opt.OptimizerConfig, mesh,
                 recipe: str = "default"):
        self.mesh = mesh
        self.recipe = recipe
        template = abstract_state(model_or_cfg, opt_cfg)
        specs = flat_specs(template, state_logical(model_or_cfg, opt_cfg),
                           describe(mesh), recipe)
        self.places = tree.unflatten(template, {
            path: Placement(mesh, spec) for path, _, spec in specs})
        self.batch_axes = batch_axes(mesh, recipe)
        self.group = axes_group(mesh, self.batch_axes)

    def rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch (numpy arrays or tensors),
        as tensors: each input's batch dimension (``positions``' second,
        M-RoPE's (3, B, S)) split over :attr:`batch_axes`, as the
        reference's launcher shards its batch."""
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            logical = ((None, "dp", None) if k == "positions"
                       else ("dp",) + (None,) * (v.dim() - 1))
            spec = resolve_spec(logical, describe(self.mesh), tuple(v.shape),
                                self.recipe)
            want = resolve_spec(logical, describe(self.mesh), None,
                                self.recipe)
            if spec != want:
                raise ValueError(f"{k} {tuple(v.shape)} does not split over "
                                 f"{self.batch_axes}")
            out[k] = Placement(self.mesh, spec).block(v)
        return out

    def gather(self, state: TrainState) -> TrainState:
        """The whole state from every rank's blocks (a checkpoint's: the
        same tensors on every rank; on one rank, ``state``'s own)."""
        return tree.tree_map(lambda x, pl: pl.gather(x), state, self.places)

    def param_places(self, params) -> list:
        """The placements of ``params``' leaves, in its walk order."""
        places = dict(tree.flatten(self.places.params))
        return [places[path] for path, _ in tree.flatten(params)]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a metric over the batch's ranks."""
        if self.group is None:
            return x
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x / dist.get_world_size(self.group)


@torch.no_grad()
def load_state(state: TrainState, saved: TrainState,
               layout: TrainLayout | None = None) -> TrainState:
    """``state`` with ``saved``'s values (a checkpoint restored into
    ``state``'s structure on its device): the parameters copied into the
    model's own tensors, the optimizer state and step taken as they are.
    With ``layout``, ``saved`` is the whole state (:meth:`TrainLayout.
    gather`'s) and ``state`` this rank's blocks: each parameter block
    takes its block of the saved tensor, and so does each moment."""
    places = (layout.param_places(state.params) if layout is not None
              else [None] * len(tree.leaves(state.params)))
    for p, s, pl in zip(tree.leaves(state.params), tree.leaves(saved.params),
                        places):
        p.copy_(s if pl is None else pl.block(s))
    if layout is not None:
        saved = TrainState(saved.params, tree.tree_map(
            lambda x, pl: pl.block(x), saved.opt, layout.places.opt),
            saved.step)
    return TrainState(state.params, saved.opt, saved.step)


def make_train_step(model, opt_cfg: opt.OptimizerConfig,
                    layout: TrainLayout | None = None) -> Callable:
    """``(state, batch) -> (state, metrics)``, metrics ``{"loss", "xent",
    "aux", "grad_norm", "lr"}`` as 0-d tensors on the device.  With
    ``layout`` the step is the sharded one (module docstring): ``state``
    holds this rank's blocks (:func:`init_state` with the same layout),
    ``batch`` this rank's rows (:meth:`TrainLayout.rows`), and the
    metrics are the global batch's."""
    group = None if layout is None else layout.group

    def train_step(state: TrainState, batch: dict):
        leaves = tree.leaves(state.params)
        places = None
        if layout is not None:
            # the model's own tensors, and the placements, in the order
            # of the state's blocks
            own = dict(tree.flatten(model.param_tree()))
            leaves = [own[path] for path, _ in tree.flatten(state.params)]
            places = layout.param_places(state.params)
            with torch.no_grad():
                for p, pl, b in zip(leaves, places,
                                    tree.leaves(state.params)):
                    full = pl.gather(b)
                    if full is not p:
                        p.copy_(full)
        for p in leaves:
            p.grad = None
        loss, metrics = model.loss(batch, group)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        if layout is not None:
            grads = [pl.reduce(g, layout.batch_axes)
                     for pl, g in zip(places, grads)]
        grads = tree.with_leaves(state.params, grads)
        params, opt_state, opt_metrics = opt.update(
            opt_cfg, grads, state.opt, state.params, places)
        del grads
        for p in leaves:
            p.grad = None
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}}
        if layout is not None:
            out = {k: layout.mean(v) for k, v in out.items()}
        out.update(opt_metrics)
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
