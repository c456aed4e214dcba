"""Execution engine: the session layer every slice strategy runs through.

A :class:`ContractionSession` is a compiled
:class:`~repro_torch.core.executor.ContractionPlan` bound to concrete
leaf tensors on the plan's device, with the two-phase hoist mode
resolved once and the hoisted prologue materialized once per session.

Strategies:

  * :meth:`ContractionSession.run_slice` — one subtask,
  * :meth:`ContractionSession.run_slices` — the masked partial sum over
    an explicit batch of slice ids (the unit a scheduler or a server
    hands out),
  * :meth:`ContractionSession.run_all` — all ``2^|S|`` subtasks.

The reference runs a batch of slices as one ``vmap``; PyTorch has no
counterpart, so here a batch loops over its valid lanes and launches each
slice's schedule in turn.  The per-slice GEMM forms and chain plans are
then exactly what executes, and each chain's certified per-slice
workspace holds as planned.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def mask_invalid(contrib: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero the padded lanes of a leading batch axis.

    ``valid`` is a boolean vector over ``contrib``'s leading axis.  The
    mask is a select, NOT a weight multiply: a NaN/Inf in a padded
    contribution would leak through ``0 * NaN == NaN``."""
    keep = valid.to(contrib.device).reshape((-1,) + (1,) * (contrib.dim() - 1))
    return torch.where(keep, contrib, torch.zeros((), dtype=contrib.dtype,
                                                  device=contrib.device))


def padded_ids(
    n_slices: int, multiple: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Slice ids padded (by wrap-around) to a multiple of ``multiple``.

    Returns ``(ids, valid, total)``: int32 ids of length ``total`` (the
    ceiling multiple), a boolean validity vector marking the real ids,
    and ``total`` itself.  Padding with *wrapped* ids keeps every lane a
    legal slice id; the validity mask keeps the duplicates out of the
    sum."""
    total = -(-n_slices // multiple) * multiple
    ids = np.arange(total, dtype=np.int32) % n_slices
    valid = np.arange(total) < n_slices
    return ids, valid, total


def to_device(arrays, device: torch.device) -> list[torch.Tensor]:
    """Leaf arrays (numpy or tensors) as contiguous tensors on ``device``."""
    out = []
    for a in arrays:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a)
        )
        out.append(t.to(device).contiguous())
    return out


class ContractionSession:
    """A compiled plan bound to leaf tensors, ready to execute slices.

    ``hoist`` selects two-phase execution (silently off when the plan
    has nothing to hoist).  The prologue is materialized lazily, once.
    """

    def __init__(self, plan, arrays, hoist: bool = True):
        self.plan = plan
        self.arrays = to_device(arrays, plan.device)
        self.hoist = bool(hoist and plan.can_hoist)
        self._hoisted: list | None = None
        if plan.device.type == "cuda":
            from ..core.executor import exact_fp32_matmul

            exact_fp32_matmul()

    @property
    def n_slices(self) -> int:
        return 1 << self.plan.num_sliced

    def hoisted(self) -> list:
        """The materialized slice-invariant prologue buffers (``[]``
        when hoisting is off) — computed once per session."""
        if not self.hoist:
            return []
        if self._hoisted is None:
            self._hoisted = self.plan.contract_prologue(self.arrays)
        return self._hoisted

    def run_slice(self, slice_id: int) -> torch.Tensor:
        """Contract one subtask."""
        return self.plan.contract_slice(
            self.arrays, int(slice_id),
            self.hoisted() if self.hoist else None,
        )

    def run_slices(self, slice_ids, valid=None) -> torch.Tensor:
        """Execute a batch of slice ids and return the partial sum over
        its valid lanes.

        ``slice_ids`` may contain wrapped-around padding ids; ``valid``
        (default all-true) marks the lanes that contribute.  Only valid
        lanes are launched, so a padded lane can contribute neither work
        nor a NaN."""
        ids = np.asarray(slice_ids, dtype=np.int64).reshape(-1)
        if valid is None:
            valid = np.ones(ids.shape, dtype=bool)
        valid = np.asarray(valid, dtype=bool).reshape(-1)
        if valid.shape != ids.shape:
            raise ValueError(f"valid {valid.shape} != ids {ids.shape}")
        acc = None
        for sid in ids[valid]:
            contrib = self.run_slice(int(sid))
            acc = contrib.clone() if acc is None else acc.add_(contrib)
        if acc is None:
            return self.zeros()
        return acc

    def run_all(self) -> torch.Tensor:
        """Sum over all ``2^|S|`` subtasks."""
        return self.run_slices(np.arange(self.n_slices))

    def zeros(self) -> torch.Tensor:
        """A zero accumulator of the output's shape on the device."""
        dtype = functools.reduce(
            torch.promote_types, [a.dtype for a in self.arrays],
            self.arrays[0].dtype if self.arrays else self.plan.dtype,
        )
        return torch.zeros(
            self.plan.out_shape(), dtype=dtype, device=self.plan.device
        )
