"""Carry a plan made elsewhere into the port.

The reference package plans with its own cost surface; these functions
rebuild its network, contraction tree and plan here from plain Python
and numpy values (the reference's ``TensorNetwork`` fields and
``ContractionTree.children`` as ints), so that the port can execute the
reference's exact plan.  They take no object of the reference package.
"""

from __future__ import annotations

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
) -> ContractionPlan:
    """A :class:`ContractionPlan` for the reference's ``(tree, S)``."""
    return ContractionPlan(
        tree, int(smask), backend=backend, dtype=dtype, device=device,
        hw=hw, fused=fused,
    )
