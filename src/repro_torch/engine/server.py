"""Contraction-as-a-service: a multi-tenant engine over compiled plans.

The serving observation behind this module: a quantum-circuit simulation
service sees *families* — many amplitude/sampling requests against the
same circuit structure (verification sweeps, XEB scoring, spoofing
studies), differing only in bitstring or sampler seed.  Planning is
expensive and family-keyed (the compiled-plan cache); execution is cheap
and request-keyed.  A server that groups by family amortizes the plan
across tenants and can answer many amplitude requests from *one*
contraction.

:class:`EngineServer` implements that:

  * **bounded intake** — :meth:`~EngineServer.submit` enqueues onto a
    bounded queue and returns a :class:`Ticket` immediately; a full
    queue rejects with :class:`ServerOverloaded` (carrying a
    ``retry_after_s`` estimate) instead of accepting unbounded latency,
  * **continuous batching** — background dispatch thread(s) drain up to
    ``max_batch`` tickets at a time and group them by family fingerprint
    (circuit structure + target width + plan kwargs),
  * **amplitude coalescing** — a group of amplitude requests whose
    bitstrings differ on at most ``max_open`` positions is served from a
    single open-qubit batch contraction (the positions that differ
    become the open axes); each request reads its amplitude at its flat
    batch index.  The open set is stabilized grow-only per family (the
    *coalescing window*), so successive groups converge on one batch
    network and one compiled plan instead of replanning per diff-subset.
    Sampling requests against one batch network share one contraction
    and draw per tenant,
  * **warm/cold paths** — the first group of a family (cold: planning
    dominates) runs on a planner thread pool so the dispatch thread
    never blocks on planning; once the family's plan is cached, groups
    run warm on the dispatch thread itself,
  * **per-request accounting** — every ticket records queue/compute/
    total latency; the server keeps coalescing/rejection counters and
    feeds the :mod:`repro_torch.obs.metrics` registry when tracing is on.

Execution rides on the session layer: a group is one
:func:`repro_torch.core.api.open_amplitude_batch` /
:func:`~repro_torch.core.api.simulate_amplitude` call on the server's
``device``, which contracts through
:class:`~repro_torch.engine.session.ContractionSession` under the shared
plan and hoist caches.

Two rules differ from the reference:

  * **One contraction on the device at a time.**  Planning runs
    concurrently on the planner pool, but every execution holds the
    device's :class:`~repro_torch.engine.session.ExecutionGate`, a lock
    per device.  The reference needs none: its plan is a pure jitted JAX
    program, so two threads may run one cached plan at once.  The port's
    plan is not pure: the chain kernel keeps one carry workspace per
    chain, shared by every call of the chain, and two threads on one plan
    would interleave chain segments on it; and a plan's certified peak
    assumes its contraction is the only one on the card, where two
    concurrent contractions would add their live sets.
  * **No ``slice_batch``.**  The reference batches a slice's lanes with
    ``vmap`` and takes ``slice_batch=``; the port launches each valid
    lane's schedule in turn (``ContractionSession.run_slices``), so the
    knob has nothing to set and the server does not take it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core.executor import resolve_device
from ..obs import metrics as _metrics, trace as _trace

_SAMPLERS = ("frequency", "rejection", "topk")


def circuit_fingerprint(circuit) -> str:
    """Structural digest of a circuit: qubit count + the exact gate
    sequence (name, qubits, params).  Two requests share a serving
    family iff their circuits share this fingerprint — equal gate
    sequences produce equal amplitudes, so coalescing across distinct
    but structurally identical Circuit objects is sound."""
    h = hashlib.sha256()
    h.update(str(int(circuit.num_qubits)).encode())
    for op in circuit.ops:
        h.update(
            repr((op.name, tuple(op.qubits), tuple(op.params))).encode()
        )
    return h.hexdigest()[:16]


class ServerOverloaded(RuntimeError):
    """Backpressure rejection: the bounded request queue is full.

    ``retry_after_s`` estimates when capacity frees up (queue depth ×
    recent per-group service time / batch size) — clients should back
    off at least that long before resubmitting."""

    def __init__(self, retry_after_s: float, depth: int):
        super().__init__(
            f"request queue full ({depth} queued); "
            f"retry in ~{retry_after_s:.2f}s"
        )
        self.retry_after_s = float(retry_after_s)
        self.depth = int(depth)


@dataclasses.dataclass
class AmplitudeRequest:
    """One amplitude <bitstring|C|0…0>.  ``plan_kwargs`` are forwarded to
    the planner (backend/precision/seed…) and join the family key —
    requests planned differently never coalesce.  The device is the
    server's, not a plan keyword."""

    circuit: object
    bitstring: str
    target_dim: int = 20
    plan_kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SampleRequest:
    """One correlated-sampling job (``num_samples`` draws from one
    open-qubit batch).  ``open_qubits``/``base_bitstring`` default as in
    :func:`repro_torch.core.api.sample_bitstrings`; requests sharing the
    resolved batch network share one contraction and differ only in
    their per-tenant draw (sampler, seed, count)."""

    circuit: object
    num_samples: int = 1024
    open_qubits: tuple | None = None
    base_bitstring: str | None = None
    sampler: str = "frequency"
    seed: int = 0
    target_dim: int = 20
    plan_kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Ticket:
    """Handle returned by :meth:`EngineServer.submit`.

    ``value`` is a complex amplitude (AmplitudeRequest) or a
    :class:`~repro_torch.sampling.SamplingResult` (SampleRequest); ``batched``
    marks tickets answered from a shared/coalesced contraction.  The
    latency split is the server's accounting unit: ``queue_s`` (submit →
    group start), ``compute_s`` (group start → done), ``total_s``."""

    id: int
    request: object
    status: str = "queued"  # queued|running|done|failed
    t_submit: float = 0.0
    t_start: float = 0.0
    t_done: float = 0.0
    value: object = None
    error: BaseException | None = None
    report: object = None
    batched: bool = False
    # the open qubits of the batch contraction that answered the ticket
    # (empty when a scalar contraction did)
    open_qubits: tuple = ()
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False
    )

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """Block until served; raise the group's error if it failed."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"ticket {self.id} not served within {timeout}s"
            )
        if self.status == "failed":
            raise self.error
        return self.value

    @property
    def queue_s(self) -> float:
        return max(0.0, self.t_start - self.t_submit)

    @property
    def compute_s(self) -> float:
        return max(0.0, self.t_done - self.t_start)

    @property
    def total_s(self) -> float:
        return max(0.0, self.t_done - self.t_submit)


class EngineServer:
    """Multi-tenant contraction server (see module docstring).

    Use as a context manager or call :meth:`start`/:meth:`stop`::

        with EngineServer(max_batch=8) as srv:
            t = srv.submit(AmplitudeRequest(circuit, "0" * 16, target_dim=12))
            amp = t.result(timeout=120)

    Contractions run on ``device`` (default ``"cuda"``; with no GPU the
    constructor raises unless ``device="cpu"`` is passed).  ``stop()``
    drains the queue before returning — every accepted ticket is served
    or failed, never abandoned.
    """

    def __init__(
        self,
        max_queue: int = 64,
        max_batch: int = 8,
        max_open: int = 6,
        dispatchers: int = 1,
        planner_threads: int = 2,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.max_queue = int(max_queue)
        self.max_batch = max(1, int(max_batch))
        self.max_open = max(1, int(max_open))
        self.dispatchers = max(1, int(dispatchers))
        self.planner_threads = max(1, int(planner_threads))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque[Ticket] = deque()
        self._threads: list[threading.Thread] = []
        self._planner: ThreadPoolExecutor | None = None
        self._running = False
        self._next_id = 0
        self._warm: set = set()
        self._amp_window: dict[tuple, frozenset] = {}
        self._ewma_group_s: float | None = None
        self._stats = {
            "submitted": 0,
            "completed": 0,
            "failed": 0,
            "rejected": 0,
            "coalesced": 0,
            "groups": 0,
            "warm_groups": 0,
            "cold_groups": 0,
        }

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "EngineServer":
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._planner = ThreadPoolExecutor(
            max_workers=self.planner_threads,
            thread_name_prefix="repro-torch-serve-planner",
        )
        self._threads = [
            threading.Thread(
                target=self._dispatch_loop,
                name=f"repro-torch-serve-dispatch-{i}",
                daemon=True,
            )
            for i in range(self.dispatchers)
        ]
        for th in self._threads:
            th.start()
        return self

    def stop(self) -> None:
        """Stop intake, drain the queue, join every worker."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        for th in self._threads:
            th.join()
        self._threads = []
        if self._planner is not None:
            self._planner.shutdown(wait=True)
            self._planner = None

    def __enter__(self) -> "EngineServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------
    def submit(self, request) -> Ticket:
        """Validate + enqueue; returns immediately with a :class:`Ticket`.

        Raises :class:`ServerOverloaded` when the bounded queue is full
        (backpressure — the request was *not* accepted) and
        ``ValueError`` on malformed requests (fail fast, before they
        occupy queue capacity)."""
        self._normalize(request)
        with self._cond:
            if not self._running:
                raise RuntimeError(
                    "EngineServer is not running; use start() or `with`"
                )
            depth = len(self._queue)
            if depth >= self.max_queue:
                self._stats["rejected"] += 1
                _metrics.inc("serve.rejected")
                per_group = self._ewma_group_s or 0.1
                retry = max(
                    0.01, per_group * (depth / self.max_batch)
                )
                raise ServerOverloaded(retry, depth)
            self._next_id += 1
            ticket = Ticket(
                id=self._next_id, request=request,
                t_submit=time.monotonic(),
            )
            self._queue.append(ticket)
            self._stats["submitted"] += 1
            _metrics.set_gauge("serve.queue_depth", depth + 1)
            self._cond.notify()
        return ticket

    def _normalize(self, request) -> None:
        if isinstance(request, (AmplitudeRequest, SampleRequest)):
            if "device" in request.plan_kwargs:
                raise ValueError(
                    "plan_kwargs may not name a device: the server's "
                    f"device ({self.device}) runs every request"
                )
        if isinstance(request, AmplitudeRequest):
            n = request.circuit.num_qubits
            bs = request.bitstring
            if len(bs) != n or set(bs) - {"0", "1"}:
                raise ValueError(
                    f"bitstring must be {n} chars of 0/1, got {bs!r}"
                )
            return
        if isinstance(request, SampleRequest):
            n = request.circuit.num_qubits
            if request.num_samples <= 0:
                raise ValueError(
                    f"num_samples must be positive, got {request.num_samples}"
                )
            if request.sampler not in _SAMPLERS:
                raise ValueError(f"unknown sampler {request.sampler!r}")
            # resolve the batch-network defaults here so the family key
            # (and hence coalescing) sees the resolved values
            if request.open_qubits is None:
                k = min(6, n)
                request.open_qubits = tuple(range(n - k, n))
            request.open_qubits = tuple(sorted(set(request.open_qubits)))
            if not request.open_qubits:
                raise ValueError("need at least one open qubit to sample")
            if request.base_bitstring is None:
                request.base_bitstring = "0" * n
            elif len(request.base_bitstring) != n or set(
                request.base_bitstring
            ) - {"0", "1"}:
                raise ValueError(
                    f"base_bitstring must be {n} chars of 0/1, "
                    f"got {request.base_bitstring!r}"
                )
            return
        raise TypeError(
            f"expected AmplitudeRequest or SampleRequest, got {request!r}"
        )

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _family_key(self, req) -> tuple:
        pk = tuple(sorted(req.plan_kwargs.items()))
        fp = circuit_fingerprint(req.circuit)
        if isinstance(req, AmplitudeRequest):
            return ("amp", fp, req.target_dim, pk)
        return (
            "smp", fp, req.open_qubits, req.base_bitstring,
            req.target_dim, pk,
        )

    def _amp_open_set(self, key, reqs) -> tuple | None:
        """Open positions for a coalesced amplitude group, or ``None``
        when the group can't coalesce (singleton, identical bitstrings,
        or spread over more than ``max_open`` positions).

        The positions where the group's bitstrings differ are unioned
        grow-only into the family's *coalescing window*: successive
        groups of one family quickly converge on a stable open set and
        therefore ONE batch network + compiled plan, instead of planning
        a fresh network for every distinct diff-subset the arrival
        pattern happens to produce.  (Reading a few extra amplitudes out
        of a 2^k batch is far cheaper than replanning.)  When the union
        would exceed ``max_open`` the group falls back to its own diff
        set."""
        base = reqs[0].bitstring
        n = reqs[0].circuit.num_qubits
        diff = {
            i
            for r in reqs
            for i in range(n)
            if r.bitstring[i] != base[i]
        }
        if len(reqs) == 1 or not diff or len(diff) > self.max_open:
            return None
        with self._lock:
            merged = diff | self._amp_window.get(key, frozenset())
            if len(merged) <= self.max_open:
                self._amp_window[key] = frozenset(merged)
                return tuple(sorted(merged))
        return tuple(sorted(diff))

    def _plan_sig(self, key, tickets) -> tuple:
        """What the group will actually contract — the warm/cold unit.

        Amplitude families serve from different compiled plans depending
        on how the group coalesces (scalar network vs open-qubit batch
        over a specific open set), so warmth is per (family, plan), not
        per family: a family whose scalar path is warm still plans cold
        the first time a coalesced group shows up, and that planning
        must not run inline on the dispatch thread."""
        if key[0] == "amp":
            open_set = self._amp_open_set(
                key, [t.request for t in tickets]
            )
            return (key, "scalar" if open_set is None else open_set)
        return key

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while self._running and not self._queue:
                    self._cond.wait(timeout=0.1)
                if not self._queue:
                    if not self._running:
                        return
                    continue
                take = min(self.max_batch, len(self._queue))
                batch = [self._queue.popleft() for _ in range(take)]
                _metrics.set_gauge("serve.queue_depth", len(self._queue))
            groups: dict[tuple, list[Ticket]] = {}
            for t in batch:
                groups.setdefault(self._family_key(t.request), []).append(t)
            for key, tickets in groups.items():
                sig = self._plan_sig(key, tickets)
                with self._lock:
                    warm = sig in self._warm
                    self._stats["warm_groups" if warm else "cold_groups"] += 1
                if warm:
                    # plan is cached: serve inline, no planning stall
                    self._run_group(key, tickets, warm=True)
                else:
                    # cold: planning dominates — keep it off the dispatch
                    # thread so warm tenants behind it are not stalled
                    self._planner.submit(
                        self._run_group, key, tickets, False
                    )

    def _run_group(self, key, tickets, warm: bool) -> None:
        t0 = time.monotonic()
        for t in tickets:
            t.t_start = t0
            t.status = "running"
        try:
            with _trace.span(
                "serve.group", cat="serve", kind=key[0],
                size=len(tickets), warm=warm,
            ):
                if key[0] == "amp":
                    self._serve_amplitudes(key, tickets)
                else:
                    self._serve_samples(tickets)
        except BaseException as e:  # noqa: BLE001 — fail the tickets, not the loop
            now = time.monotonic()
            for t in tickets:
                t.error = e
                t.status = "failed"
                t.t_done = now
                t._event.set()
            with self._lock:
                self._stats["failed"] += len(tickets)
            _metrics.inc("serve.failed", len(tickets))
            return
        now = time.monotonic()
        for t in tickets:
            t.t_done = now
            t.status = "done"
            t._event.set()
            _metrics.observe("serve.queue_s", t.queue_s)
            _metrics.observe("serve.compute_s", t.compute_s)
        # per-family accounting: labeled series are cardinality-bounded
        # by the registry (overflow collapses into `{_other}`)
        _metrics.inc("serve.family_requests", len(tickets), label=key[1])
        dt = now - t0
        sig = self._plan_sig(key, tickets)
        with self._lock:
            self._warm.add(sig)
            self._stats["completed"] += len(tickets)
            self._stats["groups"] += 1
            self._ewma_group_s = (
                dt
                if self._ewma_group_s is None
                else 0.5 * self._ewma_group_s + 0.5 * dt
            )
        _metrics.inc("serve.completed", len(tickets))

    # ------------------------------------------------------------------
    # group execution (on sessions, through the plan/hoist caches; each
    # contraction holds the device's execution gate)
    # ------------------------------------------------------------------
    def _serve_amplitudes(self, key, tickets) -> None:
        from ..core import api

        reqs = [t.request for t in tickets]
        circuit = reqs[0].circuit
        base = reqs[0].bitstring
        open_set = self._amp_open_set(key, reqs)
        pk = dict(reqs[0].plan_kwargs, device=self.device)
        if open_set is not None:
            # coalesce: the family's stabilized open window covers every
            # position where the group's bitstrings differ; ONE batch
            # contraction answers every tenant
            batch, report = api.open_amplitude_batch(
                circuit,
                open_qubits=open_set,
                base_bitstring=base,
                target_dim=reqs[0].target_dim,
                **pk,
            )
            flat = batch.flat()
            for t in tickets:
                idx = 0
                for q in open_set:  # MSB-first: bit j ↔ open_qubits[j]
                    idx = (idx << 1) | int(t.request.bitstring[q])
                t.value = complex(flat[idx])
                t.report = report
                t.batched = True
                t.open_qubits = open_set
            with self._lock:
                self._stats["coalesced"] += len(tickets)
            _metrics.inc("serve.coalesced", len(tickets))
            return
        # singleton group / identical bitstrings / too spread to batch:
        # scalar contractions, deduped by bitstring (plan shared via cache)
        done: dict[str, object] = {}
        for t in tickets:
            bs = t.request.bitstring
            if bs not in done:
                done[bs] = api.simulate_amplitude(
                    circuit, bs,
                    target_dim=t.request.target_dim,
                    **pk,
                )
            res = done[bs]
            t.value = complex(np.asarray(res.value))
            t.report = res.report
        if len(tickets) > len(done):  # duplicates shared a contraction
            for t in tickets:
                t.batched = True

    def _serve_samples(self, tickets) -> None:
        from ..core import api

        r0 = tickets[0].request
        # one contraction for the whole sub-group (same batch network by
        # family-key construction); per-tenant draws on the shared batch
        batch, report = api.open_amplitude_batch(
            r0.circuit,
            open_qubits=r0.open_qubits,
            base_bitstring=r0.base_bitstring,
            target_dim=r0.target_dim,
            device=self.device,
            **dict(r0.plan_kwargs),
        )
        for t in tickets:
            r = t.request
            res = api.draw_from_batch(
                batch, r.num_samples, sampler=r.sampler, seed=r.seed,
                report=report,
            )
            t.value = res
            t.report = report
            t.batched = len(tickets) > 1
            t.open_qubits = batch.open_qubits
        if len(tickets) > 1:
            with self._lock:
                self._stats["coalesced"] += len(tickets)
            _metrics.inc("serve.coalesced", len(tickets))

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Point-in-time serving counters (+ live queue depth and the
        number of warm families)."""
        with self._lock:
            out = dict(self._stats)
            out["queue_depth"] = len(self._queue)
            out["warm_families"] = len(self._warm)
            out["ewma_group_s"] = self._ewma_group_s or 0.0
        return out
