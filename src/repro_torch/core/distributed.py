"""Distributed sliced contraction: slice parallelism over devices, and
slice-level fault tolerance.

The paper's process-level parallelism: the ``2^|S|`` slice subtasks are
independent ("embarrassing parallelism ... only one all-reduce operation
is required after the computation").  Here:

  * :func:`contract_sharded` splits the slice ids into contiguous chunks
    over an explicit list of devices; each device gets its own copy of
    the leaves and its own hoisted prologue and scans only the
    slice-dependent epilogue, and the partials are summed on the first
    device in device order — one fixed order, the counterpart of the
    reference's ``shard_map`` + ``psum``;
  * :class:`SliceRangeCheckpoint` is the fault-tolerance unit: the set of
    completed slice ids (as merged intervals) plus the partial sum.
    Completion is id-keyed, so a resume may re-chunk freely;
  * :func:`contract_resumable` is the single-host runner of that
    checkpoint/restart contract.

This module is the single-process (device-level) layer.  Process-level
parallelism — LPT work-stealing scheduling across hosts, the overlapped
collective transport, and elastic per-host claims built on
:class:`SliceRangeCheckpoint` — lives in :mod:`repro_torch.distributed`
(``contract_multihost``).  Both runners here are thin adapters over
:class:`repro_torch.engine.session.ContractionSession`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs import trace as _trace
from .executor import ContractionPlan


def contract_sharded(
    plan: ContractionPlan,
    arrays,
    devices,
    slice_batch: int = 1,
    hoist: bool = True,
) -> torch.Tensor:
    """Contract all slices with slice parallelism over ``devices`` (a
    list of devices, e.g. ``["cuda:0"]`` or ``["cpu", "cpu"]``; repeats
    allowed).  The list holds at most one CUDA device, the current one
    (:func:`~repro_torch.engine.session.check_devices`): the cards of a
    host are driven by one process each (:mod:`repro_torch.distributed`).

    Every device sums its contiguous chunk of slice ids in batches of
    ``slice_batch`` (padded ids wrap around and are masked); the
    partials are summed on ``devices[0]`` in device order.  When the
    plan's network holds output indices open (batched sampling) every
    device's accumulator is the full open-batch tensor: only the slice
    axis is split.  Under two-phase execution (``hoist``) each device
    materializes the slice-invariant prologue once, through the plan's
    hoist cache (one entry per device), before its slice loop.

    Adapter over :meth:`~repro_torch.engine.session.ContractionSession.
    run_sharded`; the result lies on ``devices[0]``."""
    from ..engine.session import ContractionSession, check_devices  # lazy: cycle

    check_devices(devices)  # before the session moves the leaves
    sess = ContractionSession(plan, arrays, hoist=hoist, device=devices[0])
    return sess.run_sharded(devices, slice_batch=slice_batch)


@dataclasses.dataclass
class SliceRangeCheckpoint:
    """Fault-tolerance unit for long contractions: completed slice ids
    (stored as canonical merged ``[start, end)`` intervals) plus the
    running partial sum.  Restart = re-enqueue the missing ids.

    **Resume-chunk contract**: completion is tracked by slice *id*, so
    :meth:`missing` is chunk-agnostic: a checkpoint written with
    ``chunk=k1`` resumes correctly under any ``chunk=k2`` without
    re-summing completed slices.  Storage stays O(#intervals), never
    O(2^|S|).  ``done`` also accepts bare ids and unmerged or overlapping
    tuples (a legacy checkpoint); everything is canonicalized on use.
    ``partial`` is a host value (numpy or a Python number)."""

    n_slices: int
    done: set
    partial: np.ndarray | complex

    def _intervals(self) -> list[tuple[int, int]]:
        """Sorted disjoint ``[start, end)`` intervals covering ``done``."""
        iv: list[tuple[int, int]] = []
        for d in self.done:
            if isinstance(d, tuple):
                if d[1] > d[0]:
                    iv.append((int(d[0]), int(d[1])))
            else:
                iv.append((int(d), int(d) + 1))
        iv.sort()
        merged: list[tuple[int, int]] = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        return merged

    def done_ids(self) -> set[int]:
        """Completed slice ids, materialized (tests and small
        checkpoints; prefer :meth:`_intervals` at scale)."""
        return {i for s, e in self._intervals() for i in range(s, e)}

    def add_range(self, start: int, end: int) -> None:
        """Record ids ``[start, end)`` as summed into ``partial``."""
        self.done.add((int(start), int(end)))
        self.done = set(self._intervals())

    def missing(self, chunk: int) -> list[tuple[int, int]]:
        """Maximal runs of not-yet-done slice ids, capped at ``chunk``
        length.  Ranges need not align to any previous chunking."""
        out: list[tuple[int, int]] = []
        pos = 0
        bounds = [
            (min(s, self.n_slices), min(e, self.n_slices))
            for s, e in self._intervals()
        ] + [(self.n_slices, self.n_slices)]
        for s, e in bounds:
            while pos < s:
                nxt = min(pos + chunk, s)
                out.append((pos, nxt))
                pos = nxt
            pos = max(pos, e)
        return out


def contract_resumable(
    plan: ContractionPlan,
    arrays,
    chunk: int = 4,
    state: SliceRangeCheckpoint | None = None,
    fail_on: set[int] | None = None,
    hoist: bool = True,
):
    """Single-host resumable runner: the checkpoint/restart contract of
    slice-level fault tolerance.

    The prologue is materialized once, outside the slice loop.  Each
    missing range of at most ``chunk`` ids is summed on the device (one
    :meth:`~repro_torch.engine.session.ContractionSession.run_slices`
    batch, in id order) and goes to the host when the range is
    checkpointed: ``state.partial`` gains it and ``state`` records the
    ids.  A restart re-derives the prologue from the same leaves, so the
    checkpoint stays just the completed ids and the partial sum, and a
    resume may use another ``chunk`` than the run that wrote it.

    ``fail_on``: range starts that raise (a simulated node failure) the
    first time they come up; ``state`` then holds every range completed
    before it.  Returns ``(partial, state)``."""
    from ..engine.session import ContractionSession, record_execution  # lazy: cycle

    sess = ContractionSession(plan, arrays, hoist=hoist)
    hoist = sess.hoist
    n_slices = sess.n_slices
    if state is None:
        state = SliceRangeCheckpoint(n_slices, set(), sess.zeros().cpu().numpy())
    failed = set(fail_on or ())

    with sess._hold(), _trace.span(
        "exec.resumable", cat="exec", slices=n_slices, chunk=chunk,
        hoist=hoist,
    ):
        sess.hoisted()  # materialize the prologue outside the slice loop
        for s, e in state.missing(chunk):
            if s in failed:
                failed.discard(s)
                raise RuntimeError(
                    f"simulated failure in slice range [{s},{e})"
                )
            with _trace.span(
                "exec.slice_range", cat="exec", start=s, end=e
            ):
                acc = sess.run_slices(np.arange(s, e))
                _trace.sync(acc)
            state.partial = state.partial + acc.cpu().numpy()
            state.add_range(s, e)
            record_execution(plan, e - s, hoist)
    return state.partial, state
