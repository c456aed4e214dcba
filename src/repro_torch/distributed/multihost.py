"""Multi-host sliced-contraction runner: scheduler × transport × claims.

This is the composition root of the package — the loop every host of an
N-process run executes identically:

  1. build the same LPT queues from the same ``(missing, costs, n_hosts,
     seed)`` (no communication needed to agree on the assignment);
  2. claim ranges through the :class:`~repro_torch.distributed.scheduler.
     Arbiter` — own queue first, then steal — and execute each as one
     :meth:`~repro_torch.engine.session.ContractionSession.run_slices`
     batch (wrapped ids + validity mask, the engine's shared ragged-batch
     contract: padded lanes are never launched);
  3. persist every completed range's partial delta to the elastic
     :class:`~repro_torch.distributed.elastic.ClaimStore` (when a checkpoint
     dir is given): fault tolerance is a side effect of the hot loop,
     not a separate mode;
  4. emit exactly ``transport.rounds`` reduction pushes — the fixed
     collective-call count that makes overlapped reduction deadlock-safe
     under stealing (hosts whose work drained pad with zero deltas);
  5. finalize the transport for the reduced amplitude and report
     ``schedule_imbalance`` / ``steal_count`` / ``overlap_fraction``.

World-size-1 invariance: with one process the scheduler degenerates to a
single queue in id order, the transport to a local sum on the device, and
each range runs the same session batch the single-host paths run.

One process drives one card: the execution gate is per process and a
plan's certified peak assumes one contraction per card, so an N-process
run on one host gives each process its own device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..obs import metrics as _metrics, trace as _trace
from .elastic import ClaimStore
from .scheduler import LocalArbiter, SliceScheduler
from .transport import (
    CollectiveTransport,
    FileTransport,
    NullTransport,
    Transport,
    world,
)


@dataclasses.dataclass
class MultiHostResult:
    """Outcome of one host's :func:`contract_multihost` participation.

    ``value`` is the globally reduced amplitude (identical on every host
    for collective/file transports); ``complete`` is False when coverage
    has holes — a dead peer's unfinished ids, recoverable by a resumed
    run with a bumped epoch."""

    value: np.ndarray
    complete: bool
    n_slices: int
    executed_slices: int
    padded_slices: int
    executed_ranges: list
    schedule_imbalance: float
    initial_imbalance: float
    steal_count: int
    steal_order: list
    overlap_fraction: float
    state: object | None = None  # merged SliceRangeCheckpoint (store runs)


def _resolve_transport(
    transport, size: int, store, reduce_rounds: int, reduce_chunks: int
) -> Transport:
    if isinstance(transport, Transport):
        return transport
    name = transport
    if name == "auto":
        name = "null" if size == 1 else "collective"
    if name == "null":
        return NullTransport(rounds=reduce_rounds)
    if name == "collective":
        tp = CollectiveTransport(chunks=reduce_chunks)
        tp.rounds = max(1, int(reduce_rounds))
        return tp
    if name == "file":
        if store is None:
            raise ValueError(
                "transport='file' requires checkpoint_dir (the partials "
                "travel through the claim store's merged checkpoint)"
            )
        return FileTransport(store)
    raise ValueError(
        f"transport {transport!r} not in ('auto', 'null', 'collective', "
        "'file') and not a Transport instance"
    )


def contract_multihost(
    plan,
    arrays,
    *,
    slice_batch: int = 1,
    hoist: bool = True,
    costs=None,
    transport="auto",
    devices=None,
    checkpoint_dir: str | None = None,
    epoch: int = 0,
    policy: str = "lpt",
    seed: int = 0,
    reduce_rounds: int = 4,
    reduce_chunks: int = 4,
    fail_after: int | None = None,
    report=None,
    rank: int | None = None,
    world_size: int | None = None,
) -> MultiHostResult:
    """Contract all slices across the processes of a ``torch.distributed``
    run.

    Every process calls this with identical arguments (plus its own
    implicit rank); the per-slice modeled FLOPs (``costs``, default the
    co-optimizer's :func:`~repro_torch.optimize.search.
    per_slice_cost_vector`) seed the LPT
    queues, ``checkpoint_dir`` turns on elastic claims + resume, and
    ``transport`` picks the reduction plane (``"auto"``:
    :class:`NullTransport` at world size 1, overlapped
    :class:`CollectiveTransport` otherwise; ``"file"`` reduces through
    the claim store — the transport that survives a peer dying mid-run).

    ``fail_after=k`` simulates a host failure: this host executes ``k``
    ranges, then dies *holding its next claim* — the stale-claim shape a
    bumped-``epoch`` resume must reclaim.  ``report`` (a
    :class:`~repro_torch.core.api.PlanReport`) receives
    ``schedule_imbalance`` / ``steal_count`` / ``overlap_fraction``.

    ``devices`` names this process's device (its first entry; default
    the plan's): the ranges run in a session bound there.  One process
    drives one card: the list holds at most one CUDA device, the current
    one (:func:`~repro_torch.engine.session.check_devices`).

    ``rank``/``world_size`` default to the ``torch.distributed`` world; the
    overrides let collective-free transports (``"file"``) emulate an
    N-host run as N sequential runner calls in one process — the
    deterministic harness the host-failure resume tests use (a real
    dead peer would hang a collective rendezvous, so failure runs are
    file-transport by construction).
    """
    from ..core.distributed import SliceRangeCheckpoint
    from ..core.executor import auto_slice_batch
    from ..engine.session import (
        ContractionSession, check_devices, record_execution,
    )

    if devices is not None:
        check_devices(devices)
    wrank, wsize = world()
    rank = wrank if rank is None else int(rank)
    size = wsize if world_size is None else int(world_size)
    sess = ContractionSession(
        plan, arrays, hoist=hoist,
        device=None if devices is None else list(devices)[0],
    )
    n_slices = sess.n_slices
    sb = auto_slice_batch(slice_batch, n_slices)
    hoist = sess.hoist

    if costs is None and plan.num_sliced:
        from ..optimize.search import per_slice_cost_vector

        costs = per_slice_cost_vector(plan.tree, plan.smask)

    store = None
    if checkpoint_dir is not None:
        store = ClaimStore(checkpoint_dir, n_slices, host=rank, epoch=epoch)
        store.reclaim_stale()
        store.sync_dirs()
        base = store.merged()
    else:
        base = SliceRangeCheckpoint(n_slices, set(), 0.0)
    missing = base.missing(sb)

    scheduler = SliceScheduler(
        missing, size, costs, policy=policy, seed=seed
    )
    arbiter = store if store is not None else LocalArbiter()
    # cross-host stealing needs a cross-host arbiter; without a claim
    # store an N-process run falls back to its static (but still LPT)
    # assignment — each host executes exactly its own queue.
    allow_steal = store is not None or size == 1

    tp = _resolve_transport(
        transport, size, store, reduce_rounds, reduce_chunks
    )
    rounds = max(1, tp.rounds)

    zero = sess.zeros()

    own0 = len(scheduler.queues[rank])
    per_round = max(1, -(-own0 // rounds))  # ranges between pushes
    _metrics.set_gauge(f"sched.queue_depth.h{rank}", own0)

    pushes = 0
    since_push = None  # accumulated (async) delta since the last push
    executed_ranges: list = []
    executed_ids = 0
    padded = 0

    def emit_push():
        nonlocal pushes, since_push
        tp.push(since_push if since_push is not None else zero)
        pushes += 1
        since_push = None

    with sess._hold(), _trace.span(
        "exec.multihost", cat="exec", rank=rank, size=size,
        slices=n_slices, slice_batch=sb, hoist=hoist, policy=policy,
        rounds=rounds, transport=type(tp).__name__,
    ):
        sess.hoisted()  # materialize the prologue outside the claim loop
        while True:
            rng = scheduler.next_range(rank, arbiter, steal=allow_steal)
            if rng is None:
                break
            if fail_after is not None and len(executed_ranges) >= fail_after:
                # die *holding* this claim: nobody completes it, and only
                # a bumped-epoch resume may reclaim it (a live same-epoch
                # peer must never — we might just be slow, not dead).
                raise RuntimeError(
                    f"simulated host {rank} failure holding claim "
                    f"[{rng.start},{rng.end})"
                )
            ids = (
                np.arange(rng.start, rng.start + sb, dtype=np.int64)
                % n_slices
            )
            valid = np.arange(rng.start, rng.start + sb) < rng.end
            with _trace.span(
                "exec.mh_range", cat="exec", start=rng.start, end=rng.end,
                stolen=rng.home != rank,
            ):
                delta = sess.run_slices(ids, valid)
            since_push = delta if since_push is None else since_push + delta
            executed_ranges.append(rng.key())
            executed_ids += rng.n_ids
            padded += sb - rng.n_ids
            if store is not None:
                store.complete(rng, delta)
            if pushes < rounds - 1 and (
                len(executed_ranges) % per_round == 0
            ):
                emit_push()
        # drain the fixed collective schedule: every host must emit
        # exactly `rounds` pushes or a peer's rendezvous never completes
        while pushes < rounds:
            emit_push()
        value = tp.finalize()

    if value is None:
        value = zero.cpu().numpy()
    if store is not None and not isinstance(tp, FileTransport):
        # resumed work completed in earlier epochs travelled through the
        # store, not this run's pushes; fold the merged base back in
        # (identical on every host — base is the global pre-run state)
        value = value + np.asarray(base.partial)

    final_state = None
    complete = True
    if store is not None:
        final_state = store.merged()
        complete = not final_state.missing(1)

    record_execution(plan, executed_ids, hoist, padded)
    imb = scheduler.realized_imbalance()
    if report is not None:
        report.schedule_imbalance = imb
        report.steal_count = scheduler.steal_count
        report.overlap_fraction = tp.overlap_fraction

    return MultiHostResult(
        value=value,
        complete=complete,
        n_slices=n_slices,
        executed_slices=executed_ids,
        padded_slices=padded,
        executed_ranges=executed_ranges,
        schedule_imbalance=imb,
        initial_imbalance=scheduler.initial_imbalance,
        steal_count=scheduler.steal_count,
        steal_order=list(scheduler.steal_order),
        overlap_fraction=tp.overlap_fraction,
        state=final_state,
    )
