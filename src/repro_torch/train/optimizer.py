"""AdamW with warmup+cosine schedule, decoupled weight decay, global-norm
clipping, and optional int8-quantized moments (8-bit-Adam style).

Counterpart of the reference's ``train/optimizer.py``: ``init`` and
``update`` over nested dicts (and lists) of tensors, fp32 moments (or
int8 with a per-tensor absmax scale), decay only for tensors of two or
more dimensions, clipping by the global norm summed in fp32, and the
update arithmetic in fp32 with the parameters stored back in their own
type (bf16) — the reference's operations, in its order.

Unlike the reference's pure functions, :func:`update` writes the new
parameters, and the fp32 moments, into the tensors it was given (under
``torch.no_grad()``) and returns them: a training state of billions of
parameters is not copied each step.  The int8 moments are new tensors
each step, as the reference's.  A tensor of the port is one layer's
(the reference stacks a family's layers into one tensor), so an int8
moment's scale is per layer tensor.

:func:`opt_state_abstract` and :func:`opt_state_logical` give the state's
meta tensors and logical axes from the parameter declarations, for the
dry run: nothing is allocated.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..models.params import is_def
from ..tree import leaves, tree_map, with_leaves

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # float32 | int8


def schedule(cfg: OptimizerConfig, step, dtype=F32) -> torch.Tensor:
    """Learning rate at ``step`` (int or integer tensor), in ``dtype``
    (fp32): linear warmup, then cosine down to ``min_lr_ratio``."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step.to(dtype) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps).to(dtype)
        / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * frac


def _decayable(leaf: torch.Tensor) -> bool:
    return leaf.dim() >= 2


def _work(x: torch.Tensor) -> torch.dtype:
    """The update's arithmetic type for a tensor: fp32, or fp64 for fp64
    (the CPU's fp64 oracle runs its steps in fp64 throughout)."""
    return torch.promote_types(F32, x.dtype)


def is_moment(x) -> bool:
    """An int8 moment, ``(q, scale)``: one leaf of a moment tree."""
    return isinstance(x, tuple) and len(x) == 2


# --------------------------------------------------------------------
# int8 moment quantization (per-tensor absmax scaling + fp32 scale)
# --------------------------------------------------------------------
def _quantize(x: torch.Tensor, groups=()) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` as int8 and its fp32 scale ``max|x| / 127``.  ``x`` may be
    one rank's block of a tensor split over the process ``groups``: the
    max is then all-reduced over them, so every block shares the scale
    that the whole tensor has."""
    amax = x.abs().max()
    for group in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def init(cfg: OptimizerConfig, params) -> dict:
    """Zero moments shaped like ``params`` (fp32, fp64 for fp64
    parameters, or int8 with a 0-d fp32 scale) and a step count of 0, on
    the parameters' device."""
    flat = leaves(params)
    device = flat[0].device if flat else None
    if cfg.moment_dtype == "int8":
        def zero(p):
            return (torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                    torch.zeros((), dtype=F32, device=p.device))
    elif cfg.moment_dtype == "float32":
        def zero(p):
            return torch.zeros(p.shape, dtype=_work(p), device=p.device)
    else:
        raise ValueError(f"moment_dtype {cfg.moment_dtype!r}: want float32 "
                         "or int8")
    return {
        "m": tree_map(zero, params),
        "v": tree_map(zero, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree, placements=None) -> torch.Tensor:
    """sqrt of the sum, over the leaves in order, of each leaf's sum of
    squares in fp32 (fp64 for fp64 leaves).  With ``placements`` (one
    :class:`~repro_torch.parallel.sharding.Placement` per leaf, on a mesh
    that spans the run) the leaves are this rank's blocks: each leaf's
    sum is all-reduced over the run, a block that several ranks hold
    (the leaf replicated over an axis) counted once, and the norm is
    that of the whole tensors."""
    sq = [torch.sum(torch.square(g.to(_work(g)))) for g in leaves(tree)]
    if placements and placements[0].mesh.size() > 1:
        per_leaf = torch.stack([s if p.counted else torch.zeros_like(s)
                                for s, p in zip(sq, placements)])
        dist.all_reduce(per_leaf)
        sq = per_leaf.unbind()
    return torch.sqrt(sum(sq))


@torch.no_grad()
def update(cfg: OptimizerConfig, grads, state: dict, params,
           placements=None):
    """One AdamW step.  Returns ``(params, state, metrics)`` with
    ``metrics = {"grad_norm", "lr"}`` (0-d fp32 tensors; the norm fp64
    for fp64 gradients); ``params`` and the fp32 moments are updated in
    place and returned.  fp64 tensors are updated in fp64 throughout.

    With ``placements`` (one per parameter leaf) ``params``, ``grads``
    and the moments are this rank's blocks of a sharded state: the
    clipping norm and each int8 scale are those of the whole tensors
    (:func:`global_norm`, :func:`_quantize`), so every rank steps as the
    one-process update would."""
    count = state["count"] + 1
    gnorm = global_norm(grads, placements)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    int8 = cfg.moment_dtype == "int8"
    consts = {}

    def at(dtype):
        """(lr, 1 - b1^t, 1 - b2^t) in ``dtype``, each computed once."""
        if dtype not in consts:
            t = count.to(dtype)
            consts[dtype] = (schedule(cfg, count, dtype), 1.0 - cfg.b1 ** t,
                             1.0 - cfg.b2 ** t)
        return consts[dtype]

    lr = at(F32)[0]

    flat_p = leaves(params)
    flat_g = leaves(grads)
    flat_m = leaves(state["m"], is_moment)
    flat_v = leaves(state["v"], is_moment)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in structure")
    groups = [()] * len(flat_p) if placements is None else [
        [pl.mesh.get_group(a) for a in pl.split_axes] for pl in placements]
    new_m, new_v = [], []
    for g, p, m, v, grp in zip(flat_g, flat_p, flat_m, flat_v, groups):
        lr_p, bc1, bc2 = at(_work(p))
        g = g.to(_work(p)) * clip
        m_f = _dequantize(*m) if int8 else m
        v_f = _dequantize(*v) if int8 else v
        m_f = m_f.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v_f = v_f.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        upd = (m_f / bc1).div_(torch.sqrt(v_f / bc2).add_(cfg.eps))
        if cfg.weight_decay and _decayable(p):
            upd.add_(cfg.weight_decay * p.to(upd.dtype))
        p.copy_(p.to(upd.dtype) - lr_p * upd)
        del upd
        new_m.append(_quantize(m_f, grp) if int8 else m_f)
        new_v.append(_quantize(v_f, grp) if int8 else v_f)

    state2 = {
        "m": with_leaves(state["m"], new_m, is_moment),
        "v": with_leaves(state["v"], new_v, is_moment),
        "count": count,
    }
    return params, state2, {"grad_norm": gnorm, "lr": lr}


def opt_state_logical(defs, cfg: OptimizerConfig) -> dict:
    """Logical axes of the optimizer state of ``defs``: each moment
    sharded as its parameter (ZeRO-3), an int8 moment's scale
    replicated."""
    if cfg.moment_dtype == "int8":
        mom = tree_map(lambda d: (d.logical, ()), defs, is_leaf=is_def)
    else:
        mom = tree_map(lambda d: d.logical, defs, is_leaf=is_def)
    return {"m": mom, "v": mom, "count": ()}


def opt_state_abstract(defs, cfg: OptimizerConfig) -> dict:
    """:func:`init`'s state for parameters declared by ``defs``, as meta
    tensors: fp32 moments (fp64 for fp64 declarations), or int8 with a
    0-d fp32 scale, and an int32 count."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.moment_dtype == "int8":
        def mom(d):
            return meta(d.shape, torch.int8), meta((), F32)
    elif cfg.moment_dtype == "float32":
        def mom(d):
            return meta(d.shape, torch.promote_types(F32, d.dtype))
    else:
        raise ValueError(f"moment_dtype {cfg.moment_dtype!r}: want float32 "
                         "or int8")
    return {"m": tree_map(mom, defs, is_leaf=is_def),
            "v": tree_map(mom, defs, is_leaf=is_def),
            "count": meta((), torch.int32)}
