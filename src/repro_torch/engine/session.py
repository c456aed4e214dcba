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
  * :meth:`ContractionSession.run_all` — all ``2^|S|`` subtasks,
  * :meth:`ContractionSession.run_sharded` — all subtasks split into
    contiguous chunks over an explicit list of devices, each device with
    its own copy of the leaves and its own hoisted prologue, the partials
    summed on the first device in device order (the reference's
    ``shard_map`` + ``psum``).  A list holds at most one CUDA device, the
    calling thread's current one (:func:`check_devices`).

The reference runs a batch of slices as one ``vmap``; PyTorch has no
counterpart, so here a batch loops over its valid lanes and launches each
slice's schedule in turn.  The per-slice GEMM forms and chain plans are
then exactly what executes, and each chain's certified per-slice
workspace holds as planned.

**One contraction on a device at a time.**  Every execution (prologue,
slices, a whole contraction) holds the device's :class:`ExecutionGate`.
The reference needs no such lock: a jitted JAX program is pure, so two
threads may run one cached plan at once.  The port's plan is not pure:
the chain kernel's launch state keeps one carry workspace per chain
(``kernels/contract_gemm.ChainLaunch``), shared by every call of the
chain, and the certified peak of a plan assumes its contraction is the
only one on the card.  The gate serializes execution per device (planning
stays concurrent) and, when a probe is set, measures each contraction's
own device-memory peak over the bytes resident when it starts.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from ..core.executor import auto_slice_batch, device_key
from ..obs import metrics as _metrics, trace as _trace


def check_devices(devices) -> None:
    """Refuse a device list that the kernels' launchers cannot serve.

    The K1-K3 launchers launch into the current stream of their tensors'
    device, which CUDA accepts only while that device is the calling
    thread's current one, and the fused kernel sets its shared-memory
    attribute once per process, for the device current at its first
    launch.  So a list of devices (:meth:`ContractionSession.run_sharded`,
    ``contract_multihost(devices=)``) holds CPU devices and at most one
    CUDA device, the current one: one process per card."""
    keys = {device_key(d) for d in devices}
    cuda = sorted((d for d in keys if d.type == "cuda"), key=str)
    if len(cuda) > 1:
        raise ValueError(
            f"devices hold {len(cuda)} CUDA devices ({', '.join(map(str, cuda))}): "
            "the kernels run on one card per process; start one process per "
            "card (repro_torch.distributed.contract_multihost)"
        )
    if cuda and torch.cuda.is_available():
        current = torch.cuda.current_device()
        if cuda[0].index != current:
            raise ValueError(
                f"device {cuda[0]} is not the current CUDA device "
                f"(cuda:{current}): call torch.cuda.set_device first"
            )


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


class ExecutionGate:
    """One contraction on a device at a time (see the module docstring).

    :meth:`hold` is re-entrant within a thread: a contraction's prologue
    and slices run under the hold of the contraction.  With ``probe`` set
    to a list, every outermost hold on a CUDA device appends one record:
    the device-memory peak of the held work over the bytes allocated when
    it started (``max_memory_allocated`` after a reset, with the device
    synchronized at both ends) beside the ``planned`` bytes its caller
    names.  The probe adds those synchronizations; it is off (``None``)
    by default."""

    def __init__(self, device):
        self.device = device_key(device)
        self._lock = threading.RLock()
        self._tls = threading.local()
        self.probe: list | None = None

    @contextlib.contextmanager
    def hold(self, planned: int | None = None, label: str = ""):
        with self._lock:
            depth = getattr(self._tls, "depth", 0)
            self._tls.depth = depth + 1
            probe = self.probe if depth == 0 and self.device.type == "cuda" else None
            if probe is not None:
                torch.cuda.synchronize(self.device)
                base = torch.cuda.memory_allocated(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
            try:
                yield
            finally:
                self._tls.depth = depth
                if probe is not None:
                    torch.cuda.synchronize(self.device)
                    peak = torch.cuda.max_memory_allocated(self.device) - base
                    probe.append(dict(label=label, resident_bytes=base,
                                      peak_bytes=peak, planned_bytes=planned))


_GATES: dict[torch.device, ExecutionGate] = {}
_GATES_LOCK = threading.Lock()


def execution_gate(device) -> ExecutionGate:
    """The :class:`ExecutionGate` of ``device`` (one per device)."""
    dev = device_key(device)
    with _GATES_LOCK:
        gate = _GATES.get(dev)
        if gate is None:
            gate = _GATES[dev] = ExecutionGate(dev)
        return gate


def record_execution(plan, executed: int, hoist: bool, padded: int = 0) -> None:
    """Work accounting of a contraction: ``executed`` slices summed into
    the amplitude.  The prologue's FLOPs are counted where it runs
    (``contract_prologue``; a hoist-cache hit executes nothing), so under
    hoisting only the per-slice epilogue cost lands here.  ``padded``
    counts the masked lanes of ragged batches (wrapped ids that were
    neither launched nor summed), kept apart from ``executed``."""
    _metrics.inc("exec.slices_executed", executed)
    if padded:
        _metrics.inc("exec.padded_slices", padded)
    if hoist:
        _metrics.inc("exec.flops_executed", plan.partition.per_slice_cost * executed)
    else:
        _metrics.inc("exec.flops_executed", plan.executed_flops(executed, hoist=False))
    chains = plan._chain_dispatch.get("epilogue" if hoist else "naive")
    if chains:
        _metrics.inc("exec.chain_calls", len(chains) * executed)


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
    has nothing to hoist).  The prologue is materialized lazily, once,
    through the plan's :class:`~repro_torch.lowering.cache.HoistCache`,
    keyed by the leaves as the caller gave them (host arrays by value),
    so sessions over the same leaves — repeated requests, server tenants —
    share it.  Every execution holds the device's :class:`ExecutionGate`.

    ``device`` binds the session to another device than the plan's (one
    plan, one session per device: :meth:`run_sharded`).
    """

    def __init__(self, plan, arrays, hoist: bool = True, device=None):
        self.plan = plan
        self._given = list(arrays)
        self.device = device_key(plan.device if device is None else device)
        self.gate = execution_gate(self.device)
        with self.gate.hold():
            self.arrays = to_device(arrays, self.device)
        self.hoist = bool(hoist and plan.can_hoist)
        self._hoisted: list | None = None
        if self.device.type == "cuda":
            from ..core.executor import exact_fp32_matmul

            exact_fp32_matmul()

    @property
    def n_slices(self) -> int:
        return 1 << self.plan.num_sliced

    def _hold(self):
        mem = self.plan.memory_plan()
        return self.gate.hold(
            planned=mem.peak_bytes_hoisted if self.hoist else mem.peak_bytes,
            label=f"{self.plan.backend}:{self.plan.num_sliced}",
        )

    def hoisted(self) -> list:
        """The materialized slice-invariant prologue buffers (``[]``
        when hoisting is off) — computed once per session, served from
        the plan's HoistCache across sessions on the same leaves."""
        if not self.hoist:
            return []
        if self._hoisted is None:
            with self._hold():
                self._hoisted = self.plan.contract_prologue(
                    self._given, device=self.device
                )
        return self._hoisted

    def run_slice(self, slice_id: int) -> torch.Tensor:
        """Contract one subtask."""
        with self._hold():
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
        with self._hold():
            for sid in ids[valid]:
                contrib = self.run_slice(int(sid))
                acc = contrib.clone() if acc is None else acc.add_(contrib)
            if acc is None:
                return self.zeros()
        return acc

    def run_all(self) -> torch.Tensor:
        """Sum over all ``2^|S|`` subtasks (one contraction: one hold of
        the gate, one ``exec.contract_all`` span)."""
        plan = self.plan
        with self._hold(), _trace.span(
            "exec.contract_all", cat="exec", slices=self.n_slices,
            hoist=self.hoist, backend=plan.backend,
        ):
            out = self.run_slices(np.arange(self.n_slices))
            _trace.sync(out)
        if plan.num_sliced == 0:
            _metrics.inc("exec.slices_executed", 1)
            _metrics.inc("exec.flops_executed", plan.executed_flops(1, hoist=False))
        else:
            record_execution(plan, self.n_slices, self.hoist)
        return out

    def zeros(self) -> torch.Tensor:
        """A zero accumulator of the output's shape on the device."""
        dtype = functools.reduce(
            torch.promote_types, [a.dtype for a in self.arrays],
            self.arrays[0].dtype if self.arrays else self.plan.dtype,
        )
        return torch.zeros(
            self.plan.out_shape(), dtype=dtype, device=self.device
        )

    def on(self, device) -> "ContractionSession":
        """This session on ``device``: itself when bound there, else a new
        session over the same leaves with its own copy of them and its own
        hoisted prologue."""
        dev = device_key(device)
        if dev == self.device:
            return self
        return ContractionSession(self.plan, self._given, self.hoist, device=dev)

    def run_sharded(self, devices, slice_batch: int = 1) -> torch.Tensor:
        """Contract all slices with the slice ids split over ``devices``.

        The ids are padded by wrap-around to a multiple of
        ``len(devices) * slice_batch`` (:func:`padded_ids`) and cut into
        one contiguous chunk per device, in list order; each device runs
        its chunk as :meth:`run_slices` batches of ``slice_batch`` ids
        (padded lanes masked, never launched) on its own copy of the
        leaves and its own hoisted prologue, holding its own
        :class:`ExecutionGate`.  The partials are then summed on
        ``devices[0]`` in device order: one fixed order, no atomics, so a
        run is bitwise reproducible (with one device and
        ``slice_batch=1`` it sums in :meth:`run_all`'s order).  Distinct
        devices run concurrently, one thread each; the list may repeat a
        device and holds at most one CUDA device, the current one
        (:func:`check_devices`).  Open-batch axes ride in every device's
        accumulator; only the slice axis is split."""
        devs = [device_key(d) for d in devices]
        if not devs:
            raise ValueError("run_sharded needs at least one device")
        check_devices(devs)
        n_slices = self.n_slices
        sb = auto_slice_batch(slice_batch, n_slices)
        ids, valid, total = padded_ids(n_slices, len(devs) * sb)
        per = total // len(devs)
        sessions = [self.on(d) for d in devs]

        def work(k: int) -> torch.Tensor:
            sess = sessions[k]
            lo = k * per
            acc = None
            on_card = (torch.cuda.device(sess.device)
                       if sess.device.type == "cuda"
                       else contextlib.nullcontext())
            with on_card, sess._hold():
                for b in range(lo, lo + per, sb):
                    delta = sess.run_slices(ids[b:b + sb], valid[b:b + sb])
                    acc = delta if acc is None else acc.add_(delta)
            return acc

        with _trace.span(
            "exec.sharded", cat="exec", slices=n_slices, devices=len(devs),
            hoist=self.hoist,
        ):
            if len(set(devs)) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(len(devs)) as pool:
                    partials = list(pool.map(work, range(len(devs))))
            else:
                partials = [work(k) for k in range(len(devs))]
            out = partials[0]
            for p in partials[1:]:
                out = out + p.to(out.device)
            _trace.sync(out)
        record_execution(self.plan, n_slices, self.hoist, total - n_slices)
        return out
