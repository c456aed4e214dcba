"""Multi-process transport: ``torch.distributed`` set-up and the
overlapped, chunked all-reduce.

The paper ends every sliced contraction with "only one all-reduce
operation ... after the computation" — a terminal barrier.  The
cross-process reduction can instead overlap the remaining slice
computation ("Closing the gap", arXiv 2110.14502).  This module provides
that as a transport the multi-host runner composes with the scheduler:

  * :func:`init_multi_host` wraps ``torch.distributed.init_process_group``
    (``gloo`` for CPU tensors, ``nccl`` for CUDA ones) from explicit
    arguments or torch's own ``env://`` variables, and is a no-op for one
    process — the same script runs unchanged as 1 or N processes;
  * :class:`CollectiveTransport` reduces the partial amplitude in a
    **fixed number of rounds × chunks** of ``all_reduce`` calls.  Fixing
    the call count up front is what makes overlapping safe under work
    stealing: hosts execute *different* numbers of slice batches, but
    every host dispatches the identical sequence of collectives (zero deltas
    once its work ran out), so the order-matched rendezvous can never
    deadlock.  Each round is dispatched with ``async_op=True`` and runs while
    the host goes on with its next slice batch; only :meth:`finalize`
    waits, which yields the measured ``overlap_fraction``;
  * :class:`FileTransport` is the collective-free fallback: partials
    travel through the elastic claim store's merged checkpoint, so a host
    dying mid-run can never hang a rendezvous;
  * :class:`NullTransport` is world size 1: a local sum.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..checkpoint.manager import _host


def _dist():
    import torch.distributed as dist

    return dist


def world() -> tuple[int, int]:
    """``(rank, world_size)`` of the ``torch.distributed`` process group,
    ``(0, 1)`` when none is up."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_multi_host(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> tuple[int, int]:
    """Join an N-process run: ``torch.distributed.init_process_group``.

    ``coordinator`` is ``host:port`` or an init URL
    (``tcp://localhost:29500``); with it, ``num_processes`` and
    ``process_id`` are required.  Without it, torch's own ``env://``
    variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
    are used when ``WORLD_SIZE`` names more than one process.  One
    process, or no configuration at all, is a no-op (world size 1).
    ``backend`` defaults to ``nccl`` where CUDA is available and ``gloo``
    otherwise; :class:`CollectiveTransport` reduces on the backend's
    device (CUDA tensors for ``nccl``, CPU tensors for ``gloo``).
    Returns ``(rank, world_size)``."""
    dist = _dist()
    if dist.is_initialized():
        return world()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator is None:
        size = int(os.environ.get("WORLD_SIZE", "1"))
        if num_processes is not None:
            size = int(num_processes)
        if size <= 1 or "MASTER_ADDR" not in os.environ:
            return world()
        dist.init_process_group(
            backend, init_method="env://", world_size=size,
            rank=int(process_id if process_id is not None
                     else os.environ.get("RANK", "0")),
        )
        return world()
    if num_processes is None or process_id is None:
        raise ValueError(
            "init_multi_host: a coordinator needs num_processes and process_id"
        )
    if int(num_processes) <= 1:
        return world()
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id),
    )
    return world()


class Transport:
    """Reduction transport for the multi-host runner.

    The runner calls :meth:`push` exactly ``rounds`` times per host with
    the local partial-sum *delta* accumulated since the previous push
    (zeros when the host's work has drained), then :meth:`finalize` once
    for the fully reduced value (on the host).  ``overlap_fraction`` is
    only meaningful after finalize."""

    #: number of push rounds the runner must emit (uniform across hosts)
    rounds: int = 1
    overlap_fraction: float = 0.0

    def push(self, delta) -> None:
        raise NotImplementedError

    def finalize(self):
        raise NotImplementedError


class NullTransport(Transport):
    """World size 1: the local accumulator *is* the reduction.  Deltas
    are summed where they lie (on the device) and come to the host once,
    in :meth:`finalize`."""

    def __init__(self, rounds: int = 1):
        self.rounds = max(1, int(rounds))
        self._acc = None

    def push(self, delta) -> None:
        self._acc = delta if self._acc is None else self._acc + delta

    def finalize(self):
        return None if self._acc is None else _host(self._acc)


class CollectiveTransport(Transport):
    """Chunked, overlapped cross-process all-reduce over the
    ``torch.distributed`` process group.

    A delta is viewed as a flat real buffer (complex as interleaved re/im
    pairs — the collectives reduce real buffers), zero-padded to
    ``chunks`` equal pieces, and each :meth:`push` dispatches ``chunks``
    ``all_reduce(..., async_op=True)`` calls without waiting.
    :meth:`finalize` waits on every outstanding reduction, sums the
    rounds in round order and restores shape and dtype.

    ``overlap_fraction`` = 1 − (wall blocked in finalize) / (wall from the
    first push to the end of finalize): 1.0 means the reduction was
    hidden behind slice compute, 0.0 that it degenerated to the paper's
    terminal barrier."""

    def __init__(self, chunks: int = 4, group=None):
        self.chunks = max(1, int(chunks))
        self.group = group
        self.rounds = 1  # the runner sets it before the run starts
        self._pending: list = []  # per round: [(work, buffer), ...]
        self._template = None  # (shape, dtype, flat_len, pad)
        self._t_first_push = None

    def _device(self) -> torch.device:
        if _dist().get_backend(self.group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    @staticmethod
    def _as_flat(d: torch.Tensor) -> torch.Tensor:
        d = d.contiguous()
        if d.is_complex():
            d = torch.view_as_real(d)
        return d.reshape(-1)

    def push(self, delta) -> None:
        dist = _dist()
        d = delta if isinstance(delta, torch.Tensor) else torch.as_tensor(
            np.asarray(delta)
        )
        if self._template is None:
            n = self._as_flat(d).numel()
            self._template = (tuple(d.shape), d.dtype, n, -n % self.chunks)
        shape, dtype, n, pad = self._template
        flat = self._as_flat(d.to(dtype)).to(self._device(), copy=True)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        if self._t_first_push is None:
            self._t_first_push = time.perf_counter()
        csize = flat.numel() // self.chunks
        outs = []
        for i in range(self.chunks):
            buf = flat[i * csize:(i + 1) * csize].clone()
            work = dist.all_reduce(buf, group=self.group, async_op=True)
            outs.append((work, buf))
        self._pending.append(outs)

    def finalize(self):
        if not self._pending:
            return None
        t0 = time.perf_counter()
        for outs in self._pending:
            for work, _ in outs:
                work.wait()
        if self._device().type == "cuda":
            torch.cuda.synchronize(self._device())
        t_block = time.perf_counter() - t0
        window = time.perf_counter() - (self._t_first_push or t0)
        self.overlap_fraction = (
            max(0.0, 1.0 - t_block / window) if window > 0 else 0.0
        )
        shape, dtype, n, pad = self._template
        total = None
        for outs in self._pending:
            flat = torch.cat([buf for _, buf in outs])[:n]
            total = flat if total is None else total + flat
        total = total.cpu()
        if dtype.is_complex:
            return torch.view_as_complex(total.reshape(-1, 2)).reshape(shape).numpy()
        return total.to(dtype).reshape(shape).numpy()


class FileTransport(Transport):
    """Reduce through the elastic claim store's merged checkpoint.

    The runner already persists every completed range's partial delta to
    the store (the fault-tolerance contract), so the reduction is the
    merged checkpoint's partial sum — no collectives, no rendezvous to
    hang when a host dies mid-run.  ``finalize`` returns the merged
    partial *regardless of coverage*; the runner checks coverage and
    reports incompleteness."""

    def __init__(self, store):
        self.store = store
        self.rounds = 1

    def push(self, delta) -> None:  # partials travel via the store
        pass

    def finalize(self):
        state = self.store.merged()
        return np.asarray(state.partial)
