"""Parameter declarations, their random initialisation and their
abstract (meta-device) form.

Counterpart of the reference's ``ParamDef``/``init_params``/
``abstract_params``/``param_specs`` (``src/repro/parallel/sharding.py``):
a declaration keeps the shape, the ``normal``/``zeros``/``ones`` rule, the
default scale ``1/sqrt(fan_in)`` (fan-in the second-to-last axis), the
bf16 default and the logical axis of each dimension (``"fsdp"``,
``"tp"``, ``"ep"`` or ``None``), which :mod:`repro_torch.parallel.sharding`
resolves against a mesh.  A per-layer declaration of the port carries the
reference's logical tuple without its leading stacking axes (always
``None`` there).

Random values come from a :class:`torch.Generator` on the target device,
so a model of billions of parameters is drawn on the card, not copied
from the host.  Same seed, same weights on one device; the reference's
``jax.random`` draws other numbers, so tests carry its weights across
with :func:`repro_torch.interop.lm_params_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..tree import leaves as tree_leaves
from ..tree import tree_map


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # stddev; default 1/sqrt(fan_in)
    dtype: torch.dtype = torch.bfloat16
    logical: tuple = ()  # logical axis per dimension (or None)

    def initializer(self, generator: torch.Generator) -> torch.Tensor:
        device = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init != "normal":
            raise ValueError(f"unknown init {self.init!r}")
        scale = self.scale
        if scale is None:
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w.mul_(scale)).to(self.dtype)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def abstract_params(defs):
    """``defs`` with each declaration replaced by a meta tensor of its
    shape and dtype: the dry run's parameters (nothing allocated)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs, is_leaf=is_def)


def param_specs(defs):
    """``defs`` with each declaration replaced by its logical axes."""
    return tree_map(lambda d: d.logical, defs, is_leaf=is_def)


def init_params(defs, generator: torch.Generator):
    """Draw every :class:`ParamDef` of the nested dict/list ``defs`` (in
    the order the structure lists them) on the generator's device."""
    if isinstance(defs, ParamDef):
        return defs.initializer(generator)
    if isinstance(defs, dict):
        return {k: init_params(v, generator) for k, v in defs.items()}
    return [init_params(v, generator) for v in defs]


def count_params(defs) -> int:
    if isinstance(defs, ParamDef):
        return math.prod(defs.shape)
    vals = defs.values() if isinstance(defs, dict) else defs
    return sum(count_params(v) for v in vals)


class Params(nn.Module):
    """A set of named tensors (one layer, or the model's top level),
    readable as a dict through :meth:`tensors`; frozen until the model's
    ``train_mode(True)``.  A dict among them (the hybrid's ``shared``
    block) is a :class:`Params` of its own, read as a nested dict."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, dict):
                self.add_module(name, Params(t))
            else:
                self.register_parameter(name,
                                        nn.Parameter(t, requires_grad=False))

    def tensors(self) -> dict:
        out = dict(self.named_parameters(recurse=False))
        out.update((name, m.tensors()) for name, m in self.named_children())
        return out


def _check(defs, params, where: str) -> None:
    if set(defs) != set(params):
        raise ValueError(f"{where}: parameters {sorted(params)} != "
                         f"{sorted(defs)}")
    for k, d in defs.items():
        if isinstance(d, dict):
            _check(d, params[k], f"{where}.{k}")
        elif tuple(params[k].shape) != d.shape:
            raise ValueError(f"{where}.{k}: shape {tuple(params[k].shape)} "
                             f"!= {d.shape}")


# the layer stacks a parameter tree may hold, in tree order: the
# encoder-decoder's encoder layers, then every family's ``layers``
STACKS = ("enc_layers", "layers")


def param_modules(defs: dict, params: dict | None,
                  generator: torch.Generator | None):
    """``(top, stacks)`` modules holding a model's weights: ``top`` a
    :class:`Params` of the tree's other entries, ``stacks`` a
    :class:`~torch.nn.ModuleList` per layer stack of :data:`STACKS` in
    ``defs`` (``{..., "layers": [per-layer dict]}``), the weights
    ``params`` checked against the declarations ``defs`` or, without
    them, drawn from ``generator``."""
    if params is None:
        if generator is None:
            raise ValueError("pass params or a generator to draw them")
        params = init_params(defs, generator)
    names = [k for k in STACKS if k in defs]
    top_defs = {k: v for k, v in defs.items() if k not in names}
    top = {k: v for k, v in params.items() if k not in names}
    _check(top_defs, top, "top")
    stacks = {}
    for name in names:
        if len(params[name]) != len(defs[name]):
            raise ValueError(f"{len(params[name])} {name}, config has "
                             f"{len(defs[name])}")
        for i, (d, lp) in enumerate(zip(defs[name], params[name])):
            _check(d, lp, f"{name}[{i}]")
        stacks[name] = nn.ModuleList(Params(lp) for lp in params[name])
    return Params(top), stacks


class TrainableLM(nn.Module):
    """What the models share for training: a model holds its weights in
    ``top`` (a :class:`Params`) and ``layers`` (a list of them; the
    encoder-decoder also ``enc_layers``), and defines
    ``hidden_states(batch, group=None) -> (h, aux)`` and
    ``head_weights(top)``.

    Placed on a sharded step's layout (:meth:`place`), the model holds
    this rank's blocks as its parameters and computes on them through
    ``sharded`` (a :class:`~repro_torch.parallel.sharding.ShardedCompute`):
    each layer's blocks gathered inside its checkpointed block, the
    products a family splits over "model" on the rank's shard."""

    sharded = None  # the sharded step's compute, once placed
    layout = None

    def place(self, layout) -> None:
        """Hold this rank's blocks of every parameter under ``layout``
        (a ``train.train_step.TrainLayout``; on one rank the blocks are
        the tensors themselves, and nothing changes) and compute on
        them.  A model is placed once."""
        if self.layout is layout:
            return
        if self.layout is not None:
            raise ValueError("the model is placed on another layout")
        with torch.no_grad():
            for p, place in zip(tree_leaves(self.param_tree()),
                                layout.param_places(self.param_tree())):
                data = p.data
                block = place.block(data)
                if block is not data:
                    p.data = block
        self.layout = layout
        self.sharded = layout.compute(self)

    def _gathered(self, x):
        """A parameter (or a dict of them) as the compute reads it: the
        blocks gathered for the sharded step (:meth:`place`), else
        ``x``."""
        return x if self.sharded is None else self.sharded.gather(x)

    @property
    def _tp(self):
        """The rank's place along "model" where the products are split
        over it (the sharded step), else ``None``."""
        return None if self.sharded is None else self.sharded.tp

    def _token_rows(self, embed: torch.Tensor, tokens) -> torch.Tensor:
        """The rows of ``embed`` (V, D) for ``tokens``, gathered for the
        sharded step, and vocabulary-parallel where it splits the table's
        rows over "model" (:func:`~repro_torch.models.layers.
        embed_rows`)."""
        from .layers import embed_rows

        w = self._gathered(embed)
        tp = self._tp
        if tp is not None and tp.split(w.shape[0], self.cfg.vocab_size):
            return embed_rows(w, tokens, tp)
        return w[tokens]

    def train_mode(self, flag: bool = True):
        """Make every parameter trainable (``requires_grad``), or frozen
        again for serving.  Returns the model."""
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    def param_tree(self) -> dict:
        """``{"embed", "final_norm", ["head"], ["shared"], ["enc_norm",
        "enc_layers": [dict per encoder layer]], "layers": [dict per
        layer]}`` of the model's own parameters (not copies): the training
        state's ``params``."""
        tree = self.top.tensors()
        for name in STACKS:
            if hasattr(self, name):
                tree[name] = [lp.tensors() for lp in getattr(self, name)]
        return tree

    def _tokens(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.top.embed.device).long()

    def loss(self, batch: dict, group=None):
        """``(loss, {"xent", "aux"})`` on ``batch`` (``tokens`` and
        ``labels``, (B, S), numpy or tensors): the final hidden states
        through the chunked cross-entropy against the head (vocabulary-
        parallel where the sharded step splits the head over "model"), plus
        ``0.01 · aux`` (0 for the dense and SSM families).  ``group`` is
        the process group the global batch is split over, where this
        batch is one rank's rows: the MoE layers route over it."""
        from .losses import chunked_cross_entropy

        h, aux = self.hidden_states(batch, group)
        top = self.top.tensors()
        name = "head" if "head" in top else "embed"  # tied to the embedding
        head = self.head_weights({name: self._gathered(top[name])})
        tp = self._tp
        if tp is not None and not tp.split(head.shape[1],
                                           self.cfg.vocab_size):
            tp = None
        xent = chunked_cross_entropy(h, head, self._tokens(batch["labels"]),
                                     tp=tp)
        return xent + 0.01 * aux, {"xent": xent, "aux": aux}
