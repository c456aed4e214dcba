"""GPipe-style pipeline parallelism over a mesh axis.

The port's twin of the reference's ``parallel/pipeline.py``.  The layer
stack is split into ``n_stages`` contiguous stages (stage s holds layers
[s·L/P, (s+1)·L/P)), one per rank along the axis, and microbatches
stream through them: the classic GPipe fill-run-drain schedule of
``n_micro + P - 1`` ticks, stage s running microbatch t - s at tick t,
bubble fraction (P-1)/(n_micro+P-1).  A stage hands its activation to
the next with ``send``/``recv`` on the axis's process group; the last
stage's outputs are broadcast to every rank along the axis.

The hand-offs are autograd functions: the backward of a receive sends
the cotangent back a stage, the backward of a send receives it, so
``backward()`` on each rank's copy of the loss is the GPipe backward
(all forward, then all backward).  The broadcast passes back only the
last stage's own cotangent: each rank holds the same logical output,
and summing the P copies' cotangents would give P times the gradient.

On a one-rank axis the same schedule runs with nothing sent: the one
stage is first and last, its outputs pass through the broadcast of a
one-rank group, and the result is the layer stack applied to each
microbatch in order.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .. import tree


class _Send(torch.autograd.Function):
    """Forward: send ``x`` to rank ``peer`` and return an empty token
    that carries the stage's graph to the loss.  Backward: receive the
    cotangent of ``x`` from ``peer``."""

    @staticmethod
    def forward(ctx, x, peer: int, group, tag: int):
        ctx.peer, ctx.group, ctx.tag = peer, group, tag
        ctx.like = (x.shape, x.dtype, x.device)
        dist.send(x.contiguous(), peer, group=group, tag=tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.like
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, ctx.peer, group=ctx.group, tag=ctx.tag)
        return g, None, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive an activation shaped like ``like`` from rank
    ``peer`` (``anchor``, an empty tensor that requires grad, puts the
    result on the graph).  Backward: send its cotangent to ``peer``."""

    @staticmethod
    def forward(ctx, anchor, like: torch.Tensor, peer: int, group, tag: int):
        ctx.peer, ctx.group, ctx.tag = peer, group, tag
        x = torch.empty_like(like)
        dist.recv(x, peer, group=group, tag=tag)
        return x

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), ctx.peer, group=ctx.group, tag=ctx.tag)
        return None, None, None, None, None


class _Broadcast(torch.autograd.Function):
    """Forward: ``out`` on the last stage (rank ``src``), broadcast to
    every rank of ``group`` (``out`` on the others is a token; ``like``
    gives the shape).  Backward: the last stage keeps its own cotangent,
    the others pass a zero to their token."""

    @staticmethod
    def forward(ctx, out, like: torch.Tensor, src: int, group, last: bool):
        ctx.last = last
        buf = out.clone() if last else torch.empty_like(like)
        dist.broadcast(buf, src, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else g.new_zeros(())), None, None, None, None


def _layers(stacked_params) -> list:
    """Per-layer parameter trees: a list of them as given (the port's
    models' layout), or the slices of a tree whose leaves stack the
    layers on a leading axis (the reference's layout)."""
    if isinstance(stacked_params, (list, tuple)):
        return list(stacked_params)
    n = tree.leaves(stacked_params)[0].shape[0]
    return [tree.tree_map(lambda a, i=i: a[i], stacked_params)
            for i in range(n)]


def pipeline_forward(
    layer_apply: Callable,  # (layer_params, x) -> x
    stacked_params,  # tree, leaves (L, ...); or a list of L layer trees
    x: torch.Tensor,  # (n_micro, mb, ...) microbatched input
    mesh,  # a live DeviceMesh
    axis: str = "pod",
) -> torch.Tensor:
    """Run the layer stack as a pipeline over ``axis`` of ``mesh``.

    Every rank passes the same ``stacked_params`` and ``x`` (replicated
    into the pipe) and runs only its stage's layers; ``layer_apply``
    keeps the shape and dtype of its input.  Returns the full (n_micro,
    mb, ...) output on every rank along the axis (the last stage's,
    broadcast); its gradient is the sequential stack's, each stage's
    layers receiving theirs on that stage's rank."""
    layers = _layers(stacked_params)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers on {n_stages} stages")
    per_stage = len(layers) // n_stages
    stage = mesh.get_local_rank(axis)
    mine = layers[stage * per_stage:(stage + 1) * per_stage]

    def apply_stage(h):
        for lp in mine:
            h = layer_apply(lp, h)
        return h

    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    first, last = stage == 0, stage == n_stages - 1
    anchor = x.new_empty(0).requires_grad_()
    outs, tokens = [], []
    for m in range(x.shape[0]):
        h = x[m] if first else _Recv.apply(anchor, x[m], ranks[stage - 1],
                                           group, m)
        a = apply_stage(h)
        if last:
            outs.append(a)
        else:
            tokens.append(_Send.apply(a, ranks[stage + 1], group, m))
    held = torch.stack(outs) if last else torch.stack(tokens).sum()
    return _Broadcast.apply(held, x, ranks[-1], group, last)


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
