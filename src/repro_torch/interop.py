"""Carry a plan or weights made elsewhere into the port.

The reference package plans with its own cost surface; these functions
rebuild its network, contraction tree and plan here from plain Python
and numpy values (the reference's ``TensorNetwork`` fields and
``ContractionTree.children`` as ints), so that the port can execute the
reference's exact plan.  :func:`lm_params_from_numpy` and
:func:`opt_state_from_numpy` do the same for an LM's parameter tree and
its optimizer state.  They take no object of the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.contraction_tree import ContractionTree
from .core.executor import ContractionPlan
from .core.tensor_network import TensorNetwork
from .hardware import DEFAULT_HARDWARE, Hardware
from .models.lm import num_dense_layers


def network_from_reference(inputs, open_inds=(), ind_sizes=None) -> TensorNetwork:
    """A :class:`TensorNetwork` from the reference's ``inputs`` (index
    labels per tensor), ``open_inds`` and ``ind_sizes``."""
    return TensorNetwork(
        [list(t) for t in inputs], list(open_inds),
        dict(ind_sizes) if ind_sizes else None,
    )


def tree_from_reference(tn: TensorNetwork, children, root: int) -> ContractionTree:
    """A :class:`ContractionTree` over ``tn`` from the reference tree's
    ``children`` (node → (left, right), node ids as ints) and ``root``.
    Leaves are ``0 .. tn.num_tensors - 1``, as in the reference."""
    t = ContractionTree(tn)
    t.children = {
        int(v): (int(l), int(r)) for v, (l, r) in dict(children).items()
    }
    for v, (l, r) in t.children.items():
        t.parent[l] = v
        t.parent[r] = v
    t.root = int(root)
    t._next_id = max([tn.num_tensors - 1, *t.children]) + 1
    for v in t.contract_order():
        l, r = t.children[v]
        t.emask[v] = t._result_mask(t.emask[l], t.emask[r])
    t.check_valid()
    return t


def plan_from_reference(
    tree: ContractionTree,
    smask: int,
    backend: str = "gemm",
    dtype=torch.complex64,
    device="cuda",
    hw: Hardware = DEFAULT_HARDWARE,
    fused: bool = True,
    precisions=None,
) -> ContractionPlan:
    """A :class:`ContractionPlan` for the reference's ``(tree, S)``.
    ``precisions`` carries the reference schedule's per-step precisions
    (``"fp32"``/``"bf16"``, in step order) across, so that the two
    schedules can be compared step by step."""
    return ContractionPlan(
        tree, int(smask), backend=backend, dtype=dtype, device=device,
        hw=hw, fused=fused, precisions=precisions,
        precision="fp32" if precisions is None else "auto",
    )


def _tensor(x) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":  # numpy has no bf16: widen exactly
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))  # a writable copy


def _stacks(cfg) -> list[tuple[str, tuple[int, ...], str]]:
    """The reference's stacked groups of ``cfg``'s layers, in layer
    order, with their stacking axes and the port's list each goes to:
    ``dense_layers`` (``first_k_dense`` rows for an MoE model, every
    layer for a dense one), then ``moe_layers``; the SSM's ``layers``;
    the hybrid's ``groups`` (groups x ``attn_every`` rows, stacked
    twice), then its ``tail``, all into ``layers``; the
    encoder-decoder's ``enc_layers`` into ``enc_layers`` and its
    ``dec_layers`` into ``layers``."""
    if cfg.family == "ssm":
        stacks = [("layers", (cfg.num_layers,))]
    elif cfg.family == "hybrid":
        ng = cfg.num_layers // cfg.attn_every
        stacks = [("groups", (ng, cfg.attn_every)),
                  ("tail", (cfg.num_layers - ng * cfg.attn_every,))]
    elif cfg.family in ("dense", "moe"):
        n_dense = num_dense_layers(cfg)
        stacks = [("dense_layers", (n_dense,)),
                  ("moe_layers", (cfg.num_layers - n_dense,))]
    elif cfg.family == "encdec":
        return [("enc_layers", (cfg.encoder_layers,), "enc_layers"),
                ("dec_layers", (cfg.num_layers,), "layers")]
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return [(k, axes, "layers") for k, axes in stacks if axes[0]]


def _merged(x, axes: int):
    """A stacked leaf with its ``axes`` leading stacking axes merged into
    one (of an int8 moment ``(q, scale)``, ``q``'s)."""
    if isinstance(x, tuple):
        return (_merged(x[0], axes),) + x[1:]
    x = np.asarray(x)
    return x.reshape((-1,) + x.shape[axes:])


def _unstack(cfg, tree: dict, leaf) -> dict:
    """The reference's stacked tree in the port's layout: each stacked
    group's entries cut into one dict per layer, the groups one after
    the other in one list (``layers``; the encoder-decoder's encoder in
    ``enc_layers``; a group stacked twice in row-major order).
    ``leaf(x, i)`` turns a reference leaf into the port's (row ``i`` of
    its group, or ``None`` for an unstacked entry, whose dicts keep their
    nesting)."""
    def unstacked(v):
        if isinstance(v, dict):
            return {k: unstacked(x) for k, x in v.items()}
        return leaf(v, None)

    stacks = _stacks(cfg)
    keys = {k for k, _, _ in stacks}
    out = {k: unstacked(v) for k, v in tree.items() if k not in keys}
    for key, axes, into in stacks:
        stacked = {}
        for k, v in tree[key].items():
            shape = np.shape(v[0] if isinstance(v, tuple) else v)
            if tuple(shape[:len(axes)]) != axes:
                raise ValueError(f"{key}.{k}: stacked {shape[:len(axes)]}, "
                                 f"config has {axes}")
            stacked[k] = _merged(v, len(axes)) if len(axes) > 1 else v
        n = int(np.prod(axes))
        out.setdefault(into, []).extend(
            {k: leaf(v, i) for k, v in stacked.items()} for i in range(n))
    return out


def _layer(x, i):
    t = _tensor(x)
    return t if i is None else t[i].clone()


def lm_params_from_numpy(cfg, tree: dict) -> dict:
    """The port's parameters for ``cfg`` from the reference's parameter
    pytree as numpy arrays (bf16 ones included).

    The reference stacks each layer's parameters on a leading axis for
    ``lax.scan`` (``"dense_layers"`` for the dense family, then
    ``"moe_layers"`` for an MoE model, ``"layers"`` for the SSM, the
    hybrid's ``"groups"`` on two axes and its ``"tail"``, the
    encoder-decoder's ``"enc_layers"`` and ``"dec_layers"``); the port
    keeps one dict per layer, in layer order.  Returns ``{"embed",
    "final_norm", ["head"], ["shared"], ["enc_norm", "enc_layers": [dict
    per encoder layer]], "layers": [dict per layer]}`` of CPU tensors,
    for :func:`repro_torch.models.build_model`."""
    return _unstack(cfg, tree, _layer)


def opt_state_from_numpy(cfg, state: dict) -> dict:
    """The port's optimizer state (:func:`repro_torch.train.optimizer.
    init`'s layout) from the reference's ``{"m", "v", "count"}`` as numpy
    arrays.  fp32 moments are cut per layer like the parameters; an int8
    moment ``(q, scale)`` of a stacked tensor becomes each layer's slice
    of ``q`` with the stacked tensor's one scale (the same values; the
    port's next update scales each layer on its own)."""
    def moment(x, i):
        if isinstance(x, tuple):
            return _layer(x[0], i), _tensor(x[1])
        return _layer(x, i)

    return {"m": _unstack(cfg, state["m"], moment),
            "v": _unstack(cfg, state["v"], moment),
            "count": _tensor(state["count"])}
