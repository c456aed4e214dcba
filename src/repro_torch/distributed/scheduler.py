"""Slice work-queue scheduler: LPT assignment + work stealing.

The paper's Sec. V-D scheme distributes the ``2^|S|`` slice subtasks over
processes with a *static* uniform split — fine when every subtask costs
the same, which the cost model guarantees only in expectation.  Its
successors (SW-TNC, arXiv 2504.09186) replace the static split with
dynamic slice scheduling because measured per-slice costs are ragged:
cache effects, ragged final batches, heterogeneous or flaky hosts.  This
module is that scheduler, kept free of torch:

  * slice ids are grouped into contiguous :class:`SliceRange` units of at
    most ``slice_batch`` ids (the session's batch — per-host
    batch sizing goes through :func:`repro_torch.core.executor.auto_slice_batch`
    upstream);
  * the initial assignment is **longest-processing-time** (LPT): ranges
    sorted by modeled cost descending feed the least-loaded host queue —
    the classic 4/3-approximation, seeded by the co-optimizer's per-slice
    modeled FLOPs (:func:`repro_torch.optimize.search.per_slice_cost_vector`);
  * between dispatch rounds a host whose queue has drained **steals**
    from the victim with the most modeled work remaining, from the tail
    of the victim's queue (the cheapest pending ranges — the head is what
    the victim itself starts next, so tail steals minimize conflict);
  * every transfer of ownership goes through an :class:`Arbiter` —
    in-process (:class:`LocalArbiter`) for threads and benchmarks, or the
    filesystem claim store of :mod:`repro_torch.distributed.elastic` for real
    multi-process runs — so the same scheduler code serves both and a
    steal is exactly "my claim won".

Everything is deterministic for a given ``(costs, n_hosts, seed)``: ties
break by range start, victim order by (remaining cost, host id), so a
run's assignment and steal order replay bit-identically — the property
the plan cache and the 2-process conformance tests rely on.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from ..obs import metrics as _metrics


@dataclasses.dataclass(frozen=True)
class SliceRange:
    """A contiguous run of slice ids ``[start, end)`` — the unit of
    scheduling, claiming, checkpointing, and stealing.  ``cost`` is the
    summed modeled FLOPs of its ids; ``home`` the LPT-assigned host."""

    start: int
    end: int
    cost: float
    home: int

    @property
    def n_ids(self) -> int:
        return self.end - self.start

    def key(self) -> tuple[int, int]:
        return (self.start, self.end)


def make_ranges(
    missing: list[tuple[int, int]], costs
) -> list[tuple[int, int, float]]:
    """Attach summed per-slice costs to ``[start, end)`` id runs (the
    output of :meth:`SliceRangeCheckpoint.missing`, already capped at the
    per-host slice batch)."""
    out = []
    for s, e in missing:
        c = float(sum(costs[s:e])) if costs is not None else float(e - s)
        out.append((s, e, c))
    return out


def lpt_assignment(
    ranges: list[tuple[int, int, float]], n_hosts: int
) -> list[list[SliceRange]]:
    """Longest-processing-time initial assignment: ranges by cost
    descending (ties by start ascending) onto the least-loaded host
    (ties by host id).  Deterministic; per-host queues come back in
    assignment order, i.e. biggest work first."""
    if n_hosts < 1:
        raise ValueError("n_hosts must be >= 1")
    queues: list[list[SliceRange]] = [[] for _ in range(n_hosts)]
    loads = [0.0] * n_hosts
    for s, e, c in sorted(ranges, key=lambda r: (-r[2], r[0])):
        h = min(range(n_hosts), key=lambda i: (loads[i], i))
        queues[h].append(SliceRange(s, e, c, h))
        loads[h] += c
    return queues


def uniform_assignment(
    ranges: list[tuple[int, int, float]], n_hosts: int
) -> list[list[SliceRange]]:
    """The paper's static split: contiguous, near-equal *count* of ranges
    per host, blind to cost — the baseline the work-stealing scheduler is
    benchmarked against."""
    if n_hosts < 1:
        raise ValueError("n_hosts must be >= 1")
    ordered = sorted(ranges, key=lambda r: r[0])
    n = len(ordered)
    queues: list[list[SliceRange]] = []
    base, extra = divmod(n, n_hosts)
    pos = 0
    for h in range(n_hosts):
        take = base + (1 if h < extra else 0)
        queues.append(
            [SliceRange(s, e, c, h) for s, e, c in ordered[pos:pos + take]]
        )
        pos += take
    return queues


def imbalance(queues: list[list[SliceRange]]) -> float:
    """Max over mean modeled host load (1.0 = perfectly balanced; the
    value ``PlanReport.schedule_imbalance`` reports for the realized
    assignment)."""
    loads = [sum(r.cost for r in q) for q in queues]
    total = sum(loads)
    if total <= 0 or not loads:
        return 1.0
    return max(loads) / (total / len(loads))


class Arbiter:
    """Ownership arbitration: ``try_claim`` returns True exactly once per
    range across all hosts.  Subclasses: :class:`LocalArbiter` (threads,
    benchmarks) and :class:`repro_torch.distributed.elastic.ClaimStore`
    (multi-process, atomic claim files on a shared filesystem)."""

    def try_claim(self, rng: SliceRange, host: int) -> bool:
        raise NotImplementedError


class LocalArbiter(Arbiter):
    """In-process arbiter: a lock-protected claimed set."""

    def __init__(self):
        self._lock = threading.Lock()
        self._claimed: set[tuple[int, int]] = set()

    def try_claim(self, rng: SliceRange, host: int) -> bool:
        with self._lock:
            if rng.key() in self._claimed:
                return False
            self._claimed.add(rng.key())
            return True


class SliceScheduler:
    """Per-host slice work queues with LPT seeding and tail stealing.

    One instance may be shared by threads (benchmarks — pops are
    lock-protected) or instantiated identically on every process of a
    multi-host run (the queues are a deterministic function of
    ``(missing, costs, n_hosts, seed)``, so all hosts agree on the
    assignment without communicating; the :class:`Arbiter` is the only
    cross-host coordination point).
    """

    def __init__(
        self,
        missing: list[tuple[int, int]],
        n_hosts: int,
        costs=None,
        *,
        policy: str = "lpt",
        seed: int = 0,
    ):
        if policy not in ("lpt", "uniform"):
            raise ValueError(f"policy {policy!r} not in ('lpt', 'uniform')")
        self.n_hosts = n_hosts
        self.seed = seed
        self.policy = policy
        ranges = make_ranges(missing, costs)
        assign = lpt_assignment if policy == "lpt" else uniform_assignment
        self.queues: list[list[SliceRange]] = assign(ranges, n_hosts)
        self.initial_imbalance = imbalance(self.queues)
        self._lock = threading.Lock()
        self.steal_count = 0
        self.steal_order: list[tuple[int, int, int]] = []  # (thief, s, e)
        self.executed_cost = [0.0] * n_hosts
        self._drained_at: dict[int, float] = {}  # host -> wall queue drained

    # ------------------------------------------------------------------
    def remaining_cost(self, host: int) -> float:
        return sum(r.cost for r in self.queues[host])

    def queue_depth(self, host: int) -> int:
        return len(self.queues[host])

    def next_range(
        self, host: int, arbiter: Arbiter, steal: bool = True
    ) -> SliceRange | None:
        """Pop the next range ``host`` should execute: own queue head
        first, then steal from the most-loaded victim's tail.  Returns
        ``None`` when no range anywhere can be claimed (all work is
        owned).  ``steal=False`` restricts the host to its own queue —
        the static-assignment mode used when no cross-host arbiter
        exists (collective transport without a claim store).
        Thread-safe for a shared instance; claim latency of a
        successful steal lands in the ``sched.steal_latency_s``
        histogram and queue depth in the ``sched.queue_depth`` gauge."""
        while True:
            with self._lock:
                q = self.queues[host]
                rng = q.pop(0) if q else None
            if rng is None:
                break
            _metrics.set_gauge(
                f"sched.queue_depth.h{host}", self.queue_depth(host)
            )
            if arbiter.try_claim(rng, host):
                with self._lock:
                    self.executed_cost[host] += rng.cost
                return rng
            # claimed elsewhere (a thief got it, or a resumed run raced):
            # just drop it and keep draining
        if not steal:
            return None  # static assignment: own queue only
        # own queue drained: steal
        t_drain = self._drained_at.setdefault(host, time.perf_counter())
        while True:
            with self._lock:
                victims = sorted(
                    (h for h in range(self.n_hosts) if h != host),
                    key=lambda h: (-self.remaining_cost(h), h),
                )
                rng = None
                victim = None
                for v in victims:
                    if self.queues[v]:
                        rng = self.queues[v].pop()  # tail: cheapest pending
                        victim = v
                        break
            if rng is None:
                return None
            if arbiter.try_claim(rng, host):
                with self._lock:
                    self.steal_count += 1
                    self.steal_order.append((host, rng.start, rng.end))
                    self.executed_cost[host] += rng.cost
                _metrics.inc("sched.steals")
                _metrics.observe(
                    "sched.steal_latency_s", time.perf_counter() - t_drain
                )
                _metrics.set_gauge(
                    f"sched.queue_depth.h{victim}", self.queue_depth(victim)
                )
                return rng

    # ------------------------------------------------------------------
    def realized_imbalance(self) -> float:
        """Max/mean of the modeled cost each host actually claimed."""
        total = sum(self.executed_cost)
        if total <= 0:
            return 1.0
        return max(self.executed_cost) / (total / self.n_hosts)

    def summary(self) -> dict:
        return {
            "n_hosts": self.n_hosts,
            "policy": self.policy,
            "initial_imbalance": self.initial_imbalance,
            "realized_imbalance": self.realized_imbalance(),
            "steal_count": self.steal_count,
            "queue_depths": [len(q) for q in self.queues],
        }


# ----------------------------------------------------------------------
# deterministic virtual-time simulation (tests + modeled benchmark rows)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class SimResult:
    """Virtual-time execution of a scheduler: no sleeping, no threads —
    events advance in deterministic ``(time, host)`` order, so two
    simulations of the same inputs are bit-identical (the seeded
    determinism contract the tests pin)."""

    makespan: float
    host_busy: list[float]
    steal_count: int
    steal_order: list[tuple[int, int, int]]
    executed: list[list[tuple[int, int]]]  # per host, in execution order

    @property
    def imbalance(self) -> float:
        total = sum(self.host_busy)
        if total <= 0:
            return 1.0
        return max(self.host_busy) / (total / len(self.host_busy))


def simulate(
    scheduler: SliceScheduler,
    host_speed=None,
    cost_scale=None,
) -> SimResult:
    """Run ``scheduler`` to completion in virtual time.

    ``host_speed[h]`` scales host ``h``'s execution rate (0.5 = half
    speed — the heterogeneity that makes stealing matter even under a
    perfect cost model); ``cost_scale(start, end) -> float`` optionally
    maps a range to its *true* execution cost (modeled-cost noise).
    Mutates ``scheduler`` (queues drain); build a fresh one per run."""
    n = scheduler.n_hosts
    speed = list(host_speed) if host_speed is not None else [1.0] * n
    arbiter = LocalArbiter()
    clock = [0.0] * n
    executed: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    done = [False] * n
    while not all(done):
        # next event: the idle-most host asks for work (ties by host id)
        h = min((i for i in range(n) if not done[i]), key=lambda i: (clock[i], i))
        rng = scheduler.next_range(h, arbiter)
        if rng is None:
            done[h] = True
            continue
        true_cost = (
            cost_scale(rng.start, rng.end) if cost_scale is not None
            else rng.cost
        )
        clock[h] += true_cost / max(speed[h], 1e-12)
        executed[h].append(rng.key())
    return SimResult(
        makespan=max(clock) if clock else 0.0,
        host_busy=clock,
        steal_count=scheduler.steal_count,
        steal_order=list(scheduler.steal_order),
        executed=executed,
    )
