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
``in_shardings``/``out_shardings`` from the logical specs, under its
``default`` recipe "FSDP + TP (MaxText-style)") a :class:`TrainLayout`
places the state on a live mesh (``launch.mesh.make_host_mesh``): the
model holds this rank's blocks of the parameters as its own tensors, and
the optimizer its blocks of the moments, under their resolved specs
(``parallel.sharding.Placement``).  A step

  * runs the forward and ``loss.backward()`` on this rank's rows of the
    global batch (the MoE layers route over the batch's process group),
    each layer gathering its blocks over the FSDP axes ("data") inside
    its checkpointed block, so that the recomputation gathers them again
    and no layer's whole weights outlive it (``sharding.
    gather_for_compute``; its backward is this rank's block of the sum
    over "data");
  * wherever the recipe resolves "tp" to a "model" axis of size > 1,
    computes every product split over it on the rank's shard, as XLA's
    partitioner computes the reference's, in every family: the heads of
    ``wq``/``wo`` (``wk``/``wv`` too where their kv heads divide "model",
    else the kv heads its q heads read) in every attention block (the
    encoder-decoder's encoder, decoder and cross-attention, whose memory
    passes ``tp_enter`` in each decoder layer; the hybrid's shared
    block at each application), the FFN columns of every SwiGLU and of
    the shared experts, the Mamba-2 mixer's ``d_inner`` channels and
    heads (its gated norm's mean of squares all-reduced, ``sharding.
    tp_sum``; ``w_bc``/``conv_bc`` gathered whole, as every head reads B
    and C), the vocabulary of the embedding and the head, with
    Megatron's conjugate all-reduces (``sharding.tp_enter``,
    ``tp_leave``) and a vocabulary-parallel loss; and wherever it
    resolves "ep" to that axis, the routed experts, each rank holding and
    running its ``E/P`` of them (expert parallelism: the ranks of
    "model" hold the same rows and route them alike, so no dispatch
    crosses ranks; a rank runs its experts' slots, and one all-reduce
    sums the routed and shared experts' partial outputs).  Only
    ``layers.WHOLE_ALONG_MODEL`` is gathered whole along "model"
    (:attr:`TrainLayout.compute_axes` states which axes do what);
  * sums each gradient over the ranks that hold other batch rows once
    (the gather's backward did it over "data"; ``Placement.reduce``
    over the batch axes left) and takes the mean (a rank's loss is a
    mean over its tokens, so the mean of the ranks' gradients is the
    gradient of the global batch's mean); a tensor replicated over
    "model" but read inside a split region gets its whole gradient
    through ``tp_enter``, and each product split over "model" gives its
    block's own; and
  * updates its blocks, the clipping norm and the int8 scales those of
    the whole tensors.

On a mesh of one rank every block is the model's own tensor, every
gather and conjugate the identity, and the step is
:func:`make_train_step`'s plain step, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from .. import tree
from ..configs.base import ArchConfig
from ..launch.mesh import MeshShape
from ..models import param_defs
from ..models.layers import WHOLE_ALONG_MODEL
from ..models.params import abstract_params, param_specs
from ..parallel.sharding import (
    Placement,
    ShardedCompute,
    TensorParallel,
    axes_group,
    batch_axes,
    describe,
    flat_specs,
    is_logical,
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
    zero moments, step 0.  With ``layout``, the model is placed on it
    first (``TrainableLM.place``): its parameters become this rank's
    blocks (on one rank, its tensors as they were)."""
    model.train_mode(True)
    if layout is not None:
        model.place(layout)
    params = model.param_tree()
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


# the logical axes whose dimensions the compute keeps split over "model":
# tensor parallelism's and expert parallelism's
MODEL_SPLIT = ("tp", "ep")


def splits_model(mesh, recipe: str) -> bool:
    """Whether the sharded step splits its products over "model" on
    ``mesh`` (a live mesh or a description) under ``recipe``: where the
    recipe resolves the logical "tp" or "ep" to "model" and that axis is
    larger than 1, whatever the family."""
    if not isinstance(mesh, MeshShape):
        mesh = describe(mesh)
    return mesh.shape.get("model", 1) > 1 and any(
        resolve_spec((ax,), mesh, None, recipe)[0] == "model"
        for ax in MODEL_SPLIT)


def tp_dims(path: str, logical: tuple) -> tuple[int, ...]:
    """The dimensions of the parameter at ``path`` (its leaf name last)
    that the compute keeps split where the step splits the products: its
    logical "tp" ones (heads, FFN columns, channels, vocabulary) and
    "ep" ones (the routed experts), none for :data:`~repro_torch.models.
    layers.WHOLE_ALONG_MODEL`.  The one rule for the step's placements,
    the dry run's collective count and ``parallel.tp_local``."""
    if path.rsplit("/", 1)[-1] in WHOLE_ALONG_MODEL:
        return ()
    return tuple(d for d, ax in enumerate(logical) if ax in MODEL_SPLIT)


class TrainLayout:
    """A training state's and a batch's layout on a live mesh (a
    ``torch.distributed`` ``DeviceMesh`` spanning the run, axes among
    "pod", "data", "model"): a :class:`~repro_torch.parallel.sharding.
    Placement` for every leaf of the state under ``recipe``'s resolved
    specs (``places``, a :class:`TrainState` of them), the batch's mesh
    axes (``batch_axes``, the logical "dp") and their process group
    (``group``, ``None`` where the batch is not split), and what the
    compute splits (:attr:`compute_axes`, :meth:`compute`)."""

    def __init__(self, model_or_cfg, opt_cfg: opt.OptimizerConfig, mesh,
                 recipe: str = "default"):
        self.mesh = mesh
        self.recipe = recipe
        cfg = (model_or_cfg if isinstance(model_or_cfg, ArchConfig)
               else model_or_cfg.cfg)
        self.batch_axes = batch_axes(mesh, recipe)
        sizes = describe(mesh).shape
        self.tp = splits_model(mesh, recipe)
        template = abstract_state(model_or_cfg, opt_cfg)
        logical = state_logical(model_or_cfg, opt_cfg)
        specs = flat_specs(template, logical, describe(mesh), recipe)
        logical = dict(tree.flatten(logical, is_logical))
        places = {}
        for path, _, spec in specs:
            # a parameter's "tp" and "ep" dimensions stay split in the
            # compute
            keep = tp_dims(path, logical[path]) if (
                self.tp and path.startswith("params/")) else ()
            places[path] = Placement(mesh, spec, keep, self.batch_axes)
        self.places = tree.unflatten(template, places)
        self.group = axes_group(mesh, self.batch_axes)
        gathered = {a for path, pl in places.items()
                    if path.startswith("params/")
                    for _, axes in pl.gathered for a in axes}
        # the axes the routed experts' dimension stays split over
        experts = {a for path, pl in places.items()
                   if path.startswith("params/") and path.endswith("e_gate")
                   for d, axes in pl.splits if d == 0 for a in axes}
        # the mesh axes of size > 1 by their role in the compute
        self.compute_axes = {
            "batch": tuple(a for a in self.batch_axes if sizes[a] > 1),
            "gathered": tuple(a for a in describe(mesh).axis_names
                              if a in gathered),
            "split": ("model",) if self.tp else (),
            "experts": tuple(a for a in describe(mesh).axis_names
                             if a in experts and self.tp),
        }
        self.family = cfg.family

    def describe_compute(self) -> str:
        """One line: which mesh axes split the batch, which the step
        gathers each layer over, and which split the products (the routed
        experts among them where "ep" splits them)."""
        ax = self.compute_axes
        what = {"ssm": "mixer heads, vocabulary",
                "hybrid": "mixer heads, shared block heads and FFN "
                          "columns, vocabulary",
                "encdec": "encoder, decoder and cross-attention heads, "
                          "FFN columns, vocabulary"}.get(
                              self.family, "heads, FFN columns, "
                              + ("routed experts, " if ax["experts"]
                                 else "") + "vocabulary")
        split = (f"products split over {ax['split']} ({what})"
                 if ax["split"] else "every product whole on each rank")
        return (f"{self.family} under {self.recipe!r}: batch over "
                f"{ax['batch'] or '()'}, layers gathered over "
                f"{ax['gathered'] or '()'}, {split}")

    def compute(self, model) -> ShardedCompute:
        """The compute of ``model`` placed on this layout: each of its
        parameters' placement, and the rank's place along "model" where
        the products split over it."""
        params = model.param_tree()
        places = {id(p): pl for p, pl in zip(tree.leaves(params),
                                             self.param_places(params))}
        tp = None
        if self.tp:
            tp = TensorParallel(self.mesh.get_local_rank("model"),
                                describe(self.mesh).shape["model"],
                                self.mesh.get_group("model"))
        return ShardedCompute(places, tp)

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

    if layout is not None and model.layout is not layout:
        raise ValueError("place the model on the layout first (init_state "
                         "with the same layout)")

    def train_step(state: TrainState, batch: dict):
        # the model's own tensors (this rank's blocks under a layout)
        leaves = tree.leaves(state.params)
        places = None if layout is None else layout.param_places(
            state.params)
        for p in leaves:
            p.grad = None
        loss, metrics = model.loss(batch, group)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        if layout is not None:
            grads = [pl.reduce(g, layout.batch_axes, of_block=True)
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
