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
  * TP (the products split over "model", in every family): each
    attention block's row-parallel all-reduce at the forward and in the
    recomputation, each SwiGLU's, each MoE layer's (one for the routed
    and shared experts' partial outputs) and each Mamba-2 mixer's at the
    forward only (the recomputation stops at the block's last saved
    tensor, the down or out projection's input, before it); backward, the
    column-parallel inputs' all-reduce per region (the cross-attention's
    memory too, in each decoder layer; an MoE layer's input once for its
    routed and shared experts, and the gates where "ep" splits the
    experts over "model"), and that of each replicated tensor read
    inside one (``wk``/``wv`` where the kv heads do not divide "model",
    the q/k norms, the mixer's ``w_bc``/``conv_bc``); the mixer's gated
    norm's fp32 sum of squares per token, forward, in the recomputation
    and backward; the shared block of the hybrid at each of its
    applications;
  * the vocabulary: the embedding lookup's all-reduce, and per sequence
    chunk of the loss the row maximum, the sum of exponentials and the
    gold logit (fp32, or fp64 in an fp64 step), plus the head input's
    backward all-reduce;
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
from ..train.train_step import splits_model, tp_dims


class _Param:
    """One parameter's collectives under its resolved spec."""

    def __init__(self, d, mesh, recipe, keep: tuple, batch: tuple,
                 itemsize):
        sizes = mesh.shape
        self.spec = resolve_spec(d.logical, mesh, d.shape, recipe)
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
    tp = splits_model(mesh, recipe)
    defs = param_defs(cfg)
    item = dtype.itemsize if dtype else None
    places = tree.unflatten(defs, {
        path: _Param(d, mesh, recipe, tp_dims(path, d.logical) if tp else (),
                     batch_axes, item or d.dtype.itemsize)
        for path, d in tree.flatten(defs, is_def)}, is_def)
    act = (item or 2) * rows * S * cfg.d_model  # the residual stream's rows
    # a statistic's, a loss's or a norm's scalars: fp32, fp64 in an fp64
    # step
    wide = 8 if item == 8 else 4
    c = _Count()
    top = {k: v for k, v in places.items()
           if k not in ("layers", "enc_layers", "shared")}
    tokens = not cfg.embed_inputs or cfg.is_encdec

    def attention(p, q="wq", k="wk", v="wv", norms=False, memory=0,
                  reads=1):
        """One attention block's: its row-parallel all-reduce (rerun in
        the recomputation: a later block of its layer saves tensors);
        backward its inputs' (``memory`` the bytes of a cross-attention's
        memory; ``reads`` copies of its input where each product promotes
        its own) and the replicated tensors' it reads."""
        if not p[q].model_split(1):
            return
        c.ar(act, 2 if train else 1)
        if train:
            c.ar(reads * act + memory)
            if not p[k].model_split(1):
                c.ar(p[k].gathered + p[v].gathered)
            if norms:
                c.ar(p["q_norm"].gathered + p["k_norm"].gathered)

    def ffn(p):
        """A SwiGLU's: forward once, and its input backward."""
        if p["w_gate"].model_split(1):
            c.ar(act, 2 if train else 1)

    def moe(p):
        """An MoE layer's MLP: one all-reduce of the routed and shared
        experts' partial outputs (forward once); backward its input's,
        entered once for both branches, and the routed experts' gates'
        (a token's ``k`` gates, fp32 or fp64 as the router)."""
        routed = p["e_gate"].model_split(0)
        shared = "s_gate" in p and p["s_gate"].model_split(1)
        if routed or shared:
            c.ar(act, 2 if train else 1)
        if train and routed:
            c.ar(rows * S * cfg.experts_per_token * wide)

    def mixer(p):
        """A Mamba-2 mixer's: the norm's statistic (forward, again in the
        recomputation, backward), the out projection's all-reduce, and
        backward its input's and ``w_bc``/``conv_bc``'s."""
        if not p["w_x"].model_split(1):
            return
        c.ar(wide * rows * S, 3 if train else 1)  # a token's sum of squares
        c.ar(act, 2 if train else 1)
        if train:
            c.ar(p["w_bc"].gathered + p["conv_bc"].gathered)

    # the embedding lookup, vocabulary-parallel where its rows split
    if tokens:
        c.gather(top["embed"], train, layer=False)
        if tp and top["embed"].model_split(0):
            c.ar(act)

    # the layers, each gathered inside its checkpointed block (the
    # encoder runs only where the memory is not cached)
    for i, layer in enumerate(places.get("enc_layers", [])
                              if kind != "decode" else []):
        for p in tree.leaves(layer):
            c.gather(p, train)
        if tp:
            # the first layer reads the bf16 embeds: q, k and v each
            # promote a copy of their own to wider weights
            attention(layer, reads=3 if i == 0 and (item or 2) > 2 else 1)
            ffn(layer)
    n_dense = (cfg.first_k_dense if cfg.num_experts else cfg.num_layers)
    memory = (item or 2) * rows * seq * cfg.d_model  # frames = tokens
    for i, layer in enumerate(places["layers"]):
        for p in layer.values():
            c.gather(p, train)
        if not tp:
            continue
        if cfg.family in ("ssm", "hybrid"):
            mixer(layer)
            continue
        attention(layer, norms=cfg.qk_norm)
        if cfg.is_encdec:
            attention(layer, "xq", "xk", "xv", memory=memory)
        if i < n_dense:
            ffn(layer)
        else:
            moe(layer)
    if "shared" in places:
        for _ in range(cfg.num_layers // cfg.attn_every):
            for p in tree.leaves(places["shared"]):
                c.gather(p, train)
            if tp:
                attention(places["shared"])
                ffn(places["shared"])

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
            c.ar(3 * rows * S * wide)  # max, sum of exponentials, gold
    elif vocab_split:
        c.ag(rows * cfg.vocab_size * 4)  # the last position's logits
    if not train:
        return c.bytes

    # the gradients' sums left, the clipping norm, int8 scales, metrics
    leaves = tree.leaves(places)
    for p in leaves:
        c.ar(p.block, len(p.reduced))
    if math.prod(sizes.values()) > 1:
        c.ar(wide * len(leaves))
    if moment_dtype == "int8":
        c.ar(4 * 2 * sum(len(p.split_axes) for p in leaves))
    if n_batch > 1:
        # the loss, the cross-entropy and the aux loss (fp32 zeros without
        # experts)
        c.ar(2 * wide + (wide if cfg.num_experts else 4))
    return c.bytes
