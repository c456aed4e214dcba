"""Carry a plan or weights made elsewhere into the port.

The reference package plans with its own cost surface; these functions
rebuild its network, contraction tree and plan here from plain Python
and numpy values (the reference's ``TensorNetwork`` fields and
``ContractionTree.children`` as ints), so that the port can execute the
reference's exact plan.  :func:`lm_params_from_numpy` does the same for
an LM's parameter tree.  They take no object of the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.contraction_tree import ContractionTree
from .core.executor import ContractionPlan
from .core.tensor_network import TensorNetwork
from .hardware import DEFAULT_HARDWARE, Hardware


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


def lm_params_from_numpy(cfg, tree: dict) -> dict:
    """The port's parameters for ``cfg`` from the reference's parameter
    pytree as numpy arrays (bf16 ones included).

    The reference stacks each layer's parameters on a leading axis for
    ``lax.scan`` (``"dense_layers"`` for the dense family, ``"layers"``
    for the SSM); the port keeps one dict per layer.  Returns
    ``{"embed", "final_norm", ["head"], "layers": [dict per layer]}`` of
    CPU tensors, for :func:`repro_torch.models.build_model`."""
    stack_key = {"dense": "dense_layers", "ssm": "layers"}.get(cfg.family)
    if stack_key is None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (ROADMAP.md, queue 1 item 11)"
        )
    out = {k: _tensor(v) for k, v in tree.items() if k != stack_key}
    stacked = {k: _tensor(v) for k, v in tree[stack_key].items()}
    n = cfg.num_layers
    for k, v in stacked.items():
        if v.shape[0] != n:
            raise ValueError(f"{stack_key}.{k}: {v.shape[0]} layers, config "
                             f"has {n}")
    out["layers"] = [
        {k: v[i].clone() for k, v in stacked.items()} for i in range(n)
    ]
    return out
