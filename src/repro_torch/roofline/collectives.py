"""The sharded step's own collectives, counted from the resolved specs.

The reference's roofline reads a compiled module's collectives out of
its HLO text (:func:`.analysis.collective_bytes`: each collective's
result-shape bytes).  The port's sharded step (``train.train_step``) is
eager, and its collectives follow from the parameters' resolved specs
and the batch's rows alone, so they are counted here per rank, in the
same unit (each ``all_gather``'s gathered result, each ``all_reduce``'s
tensor), by kind:

  * FSDP: each parameter's block all-gathered over the dimensions the
    compute does not keep split (one gather per split axis, the fastest
    first, as ``Placement.gather``), at its layer's forward and again in
    the checkpoint's recomputation (the embedding and the head once, for
    the lookup and the loss); the gather's backward all-reduces the
    gathered gradient once over each batch axis among its axes;
  * the gradient sums left: each parameter's block over the batch axes
    its gather did not sum (a replicated norm over "data", say);
  * TP (``DecoderLM``, its products split over "model"): the attention's
    row-parallel all-reduce at the forward and in the recomputation, the
    MLP's at the forward only (the recomputation stops at the block's
    last saved tensor, the down projection's input, before it); backward,
    the column-parallel inputs' all-reduce per region, and that of each
    replicated tensor read inside one (``wk``/``wv`` where the kv heads
    do not divide "model", the q/k norms);
  * the vocabulary: the embedding lookup's all-reduce, and per sequence
    chunk of the loss the row maximum, the sum of exponentials and the
    gold logit (fp32), plus the head input's backward all-reduce;
  * the MoE routing over the batch's ranks (each MoE layer's top-k ids
    gathered, its counts and probability sums all-reduced, at the
    forward and in the recomputation), the clipping norm's per-leaf
    sums, the int8 moments' scales and the three metrics' means.

A serving cell (prefill, decode) counts the same compute's forward alone:
each layer gathered once, the row-parallel and vocabulary all-reduces,
and the last position's logits all-gathered over the vocabulary where
the head is split (the port serves no sharded model: this is what the
sharded step's forward would move on the cell's tokens).
"""

from __future__ import annotations

import math

import torch

from .. import tree
from ..models import param_defs
from ..models.params import is_def
from ..parallel.sharding import resolve_spec, spec_axes
from ..train.train_step import TP_FAMILIES


class _Param:
    """One parameter's collectives under its resolved spec."""

    def __init__(self, d, mesh, recipe, tp: bool, batch: tuple, itemsize):
        sizes = mesh.shape
        self.spec = resolve_spec(d.logical, mesh, d.shape, recipe)
        keep = {i for i, ax in enumerate(d.logical) if ax == "tp"} if tp \
            else set()
        splits = [(i, tuple(a for a in spec_axes(e) if sizes[a] > 1))
                  for i, e in enumerate(self.spec)]
        splits = [(i, axes) for i, axes in splits if axes]
        self.split_axes = [a for _, axes in splits for a in axes]
        split_of = dict(splits)
        shape = [dim // math.prod(sizes[a] for a in split_of.get(i, ()))
                 for i, dim in enumerate(d.shape)]
        self.block = math.prod(shape) * itemsize
        # Placement.gather: one all-gather per axis, the fastest first
        self.gathers = []
        for i, axes in splits:
            if i in keep:
                continue
            for a in reversed(axes):
                shape[i] *= sizes[a]
                self.gathers.append(math.prod(shape) * itemsize)
        self.gathered = math.prod(shape) * itemsize
        self.summed = [a for i, axes in splits if i not in keep
                       for a in axes if a in batch]
        self.reduced = [a for a in batch if a not in self.summed]

    def model_split(self, dim: int) -> bool:
        return "model" in spec_axes(self.spec[dim])


class _Count:
    def __init__(self):
        self.bytes = {"all-gather": 0, "all-reduce": 0}

    def ag(self, n: int, times: int = 1) -> None:
        self.bytes["all-gather"] += times * n

    def ar(self, n: int, times: int = 1) -> None:
        self.bytes["all-reduce"] += times * n

    def gather(self, p: _Param, train: bool, layer: bool = True) -> None:
        """One application's gathers of ``p``: forward (and when training
        the backward's sums, and in a checkpointed ``layer`` the
        recomputation's gathers)."""
        if not p.gathers:
            return
        self.ag(sum(p.gathers), 2 if train and layer else 1)
        if train:
            self.ar(p.gathered, len(p.summed))


def step_collectives(cfg, mesh, recipe: str, batch: int, seq: int,
                     kind: str = "train", moment_dtype: str = "float32",
                     dtype: torch.dtype | None = None) -> dict[str, int]:
    """Bytes per rank of each collective kind of one sharded step of
    ``cfg`` (its declared parameter types, or ``dtype``) on the mesh
    description ``mesh`` under ``recipe``, at ``batch`` global rows of
    ``seq`` tokens (module docstring).  ``kind`` "train" is the step,
    "prefill"/"decode" its forward alone (decode: one token a row)."""
    sizes = mesh.shape
    train = kind == "train"
    S = 1 if kind == "decode" else seq
    batch_axes = tuple(a for a in spec_axes(resolve_spec(
        ("dp",), mesh, (batch,), recipe)[0]) if sizes[a] > 1)
    n_batch = math.prod(sizes[a] for a in batch_axes)
    rows = batch // n_batch
    tp = (cfg.family in TP_FAMILIES and sizes.get("model", 1) > 1
          and resolve_spec(("tp",), mesh, None, recipe)[0] == "model")
    defs = param_defs(cfg)
    item = dtype.itemsize if dtype else None

    def place(d):
        return _Param(d, mesh, recipe, tp, batch_axes, item or d.dtype.itemsize)

    places = tree.tree_map(place, defs, is_leaf=is_def)
    act = (item or 2) * rows * S * cfg.d_model  # the residual stream's rows
    c = _Count()
    top = {k: v for k, v in places.items()
           if k not in ("layers", "enc_layers", "shared")}
    tokens = not cfg.embed_inputs or cfg.is_encdec

    # the embedding lookup, vocabulary-parallel where its rows split
    if tokens:
        c.gather(top["embed"], train, layer=False)
        if tp and top["embed"].model_split(0):
            c.ar(act)

    # the layers, each gathered inside its checkpointed block
    for layer in places.get("enc_layers", []):
        for p in tree.leaves(layer):
            c.gather(p, train)
    n_dense = (cfg.first_k_dense if cfg.num_experts else cfg.num_layers)
    for i, layer in enumerate(places["layers"]):
        for p in layer.values():
            c.gather(p, train)
        if not tp:
            continue
        if layer["wq"].model_split(1):
            c.ar(act, 2 if train else 1)  # the row-parallel wo
            if train:
                c.ar(act)  # the column-parallel input
                if not layer["wk"].model_split(1):
                    c.ar(layer["wk"].gathered + layer["wv"].gathered)
                if cfg.qk_norm:
                    c.ar(layer["q_norm"].gathered + layer["k_norm"].gathered)
        ffn = "w_gate" if i < n_dense else "s_gate"
        if ffn in layer and layer[ffn].model_split(1):
            c.ar(act, 2 if train else 1)  # forward, and its input backward
    if "shared" in places:
        for _ in range(cfg.num_layers // cfg.attn_every):
            for p in tree.leaves(places["shared"]):
                c.gather(p, train)

    # the MoE routing over the batch's ranks (forward and recomputation)
    n_moe = cfg.num_layers - n_dense if cfg.num_experts else 0
    if train and n_moe and n_batch > 1:
        ids = rows * S * cfg.experts_per_token * 4 * n_batch
        c.ag(ids, 2 * n_moe)
        c.ar(cfg.num_experts * (8 + 4), 2 * n_moe)

    # the head: gathered, vocabulary-parallel where its rows split
    head = top["embed"] if cfg.tie_embeddings else top["head"]
    c.gather(head, train, layer=False)
    vocab_split = tp and head.model_split(0 if cfg.tie_embeddings else 1)
    if train:
        if vocab_split:
            c.ar(act)  # the hidden states' backward
            c.ar(3 * rows * S * 4)  # max, sum of exponentials, gold
    elif vocab_split:
        c.ag(rows * cfg.vocab_size * 4)  # the last position's logits
    if not train:
        return c.bytes

    # the gradients' sums left, the clipping norm, int8 scales, metrics
    leaves = tree.leaves(places)
    for p in leaves:
        c.ar(p.block, len(p.reduced))
    if math.prod(sizes.values()) > 1:
        c.ar(4 * len(leaves))
    if moment_dtype == "int8":
        c.ar(4 * 2 * sum(len(p.split_axes) for p in leaves))
    if n_batch > 1:
        c.ar(4, 3)
    return c.bytes
