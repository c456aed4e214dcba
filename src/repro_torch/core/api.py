"""End-to-end pipeline: circuit → network → path → slicing → tuning →
merging → lowering → sliced PyTorch contraction.  This is the public API
the port's users, its examples and ``chip_smoke.py`` drive.

``backend="gemm"`` (the default) compiles the planned tree through
:mod:`repro_torch.lowering` into an explicit kernel schedule (the
hand-written tiled, fused and chain kernels plus library fallbacks);
``backend="einsum"`` is the oracle path, asked for by name.  Every entry
point takes ``device`` (default ``"cuda"``); with no GPU it raises unless
``device="cpu"`` is passed.

Planned artifacts are memoized in the compiled-plan cache
(:data:`repro_torch.lowering.cache.PLAN_CACHE`) keyed by the canonical
network fingerprint + planner parameters + device + hardware, so repeated
requests for the same circuit family skip planning — pass
``use_cache=False`` to force a fresh plan.  ``telemetry=True`` turns span
tracing and metrics on for the call and returns their snapshot in
``PlanReport.telemetry``.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..hardware import DEFAULT_HARDWARE, Hardware
from ..obs import trace as _trace
from .contraction_tree import ContractionTree
from .executor import ContractionPlan, default_backend, simplify_network
from .merging import modeled_tree_time
from .tensor_network import popcount


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if b < 1024:
            return f"{b:.0f}{unit}"
        b /= 1024
    return f"{b:.1f}TB"


@dataclasses.dataclass
class PlanReport:
    """Planner metrics mirroring the paper's reported quantities (the
    fields this port fills so far)."""

    num_tensors: int
    width_before: int
    width_after: int
    log2_cost: float
    log2_sliced_cost: float
    num_sliced: int
    slicing_overhead: float  # Eq. 4
    modeled_time_s: float  # Sec. V model, one card
    plan_wall_s: float
    backend: str = "gemm"
    # compiled-plan cache: this call's hit, and the cache's totals
    cache_hit: bool = False
    cache_hits: int = 0
    cache_misses: int = 0
    lowered_backends: dict | None = None  # node counts per kernel backend
    pad_waste: float = 0.0  # FLOPs-weighted tile padding fraction
    hoist: bool = True  # whether two-phase execution is enabled
    invariant_fraction: float = 0.0  # share of C(B) hoisted out of slices
    measured_overhead: float = 1.0  # executed-FLOPs overhead of the mode
    modeled_time_hoisted_s: float = 0.0  # Sec. V model under hoisting
    peak_bytes: int = 0  # exact live-set peak, naive subtask
    peak_bytes_hoisted: int = 0  # live-set peak under two-phase execution
    buffer_slots: int = 0  # linear-scan slot count (naive subtask)
    transpose_bytes_saved: float = 0.0  # bytes the fused kernel avoids/slice
    # anytime path–slice co-optimizer
    optimize: str = "oneshot"  # planner mode: oneshot | anytime
    search_evals: int = 0  # candidate evaluations the search spent
    search_trace: list | None = None  # best-so-far improvements (dicts)
    budget_bytes: int = 0  # the search's certified-peak budget (0: one-shot)
    feasible: bool = True  # the searched plan's certified peak fits it
    fused_chains: int = 0  # multi-step chains planned
    max_chain_len: int = 0
    chain_hbm_bytes_saved: float = 0.0  # modeled bytes chains avoid/slice
    # metrics snapshot + per-span aggregates (obs.telemetry_summary()),
    # filled only when tracing is on (telemetry=True) — None otherwise
    telemetry: dict | None = None
    # multi-host scheduling: realized max/mean host load, ranges stolen
    # across hosts, and the share of the reduction hidden behind slice
    # compute — filled by contract_multihost when a report is passed;
    # the defaults describe a single-host run
    schedule_imbalance: float = 0.0  # 0.0 = not a multi-host run
    steal_count: int = 0
    overlap_fraction: float = 0.0
    # mixed precision under an XEB budget
    precision: str = "fp32"  # fp32 | bf16 | auto
    fidelity_tol: float = 0.0  # the XEB budget the plan was certified at
    precision_counts: dict | None = None  # step counts per precision
    predicted_amp_error: float = 0.0  # error model's relative amplitude error
    hardware: str = DEFAULT_HARDWARE.name

    def row(self) -> str:
        """One-line report (the reference's row for the fields the port
        fills)."""
        row = (
            f"tensors={self.num_tensors} W={self.width_before}->"
            f"{self.width_after} log2C={self.log2_cost:.2f} "
            f"slices={self.num_sliced} overhead={self.slicing_overhead:.3f} "
            f"t_model={self.modeled_time_s:.3e}s plan={self.plan_wall_s:.2f}s "
            f"backend={self.backend}"
        )
        if self.num_sliced:
            row += (
                f" hoist={'on' if self.hoist else 'off'}"
                f"[inv={self.invariant_fraction:.2f}"
                f" ov={self.measured_overhead:.3f}]"
            )
        if self.optimize != "oneshot":
            row += f" opt={self.optimize}[evals={self.search_evals}]"
        if self.peak_bytes:
            row += f" peak={_fmt_bytes(self.peak_bytes)}"
            if self.peak_bytes_hoisted != self.peak_bytes:
                row += f"->{_fmt_bytes(self.peak_bytes_hoisted)}"
            row += f" slots={self.buffer_slots}"
        if self.cache_hit:
            row += " cache=hit"
        if self.lowered_backends:
            nodes = " ".join(
                f"{k}={v}" for k, v in sorted(self.lowered_backends.items())
            )
            row += f" lowered[{nodes}] pad_waste={self.pad_waste*100:.1f}%"
            if self.transpose_bytes_saved:
                row += f" tb_saved={_fmt_bytes(self.transpose_bytes_saved)}"
        if self.fused_chains:
            row += (
                f" chains={self.fused_chains}"
                f" chain_saved={_fmt_bytes(self.chain_hbm_bytes_saved)}"
            )
        if self.schedule_imbalance:
            row += (
                f" sched[imb={self.schedule_imbalance:.2f}"
                f" steals={self.steal_count}"
                f" overlap={self.overlap_fraction:.2f}]"
            )
        if self.precision != "fp32":
            counts = self.precision_counts or {}
            total = sum(counts.values())
            row += (
                f" prec={self.precision}"
                f"[bf16={counts.get('bf16', 0)}/{total}"
                f" tol={self.fidelity_tol:g}"
                f" amp_err={self.predicted_amp_error:.2e}]"
            )
        return row


@dataclasses.dataclass
class SimulationResult:
    value: np.ndarray | complex
    report: PlanReport
    tree: ContractionTree
    smask: int
    plan: ContractionPlan | None = None  # carries the lowered schedule


def _telemetry_snapshot() -> dict:
    from .. import obs  # lazy: obs is also importable standalone

    return obs.telemetry_summary()


def _with_telemetry(report: PlanReport) -> PlanReport:
    if not _trace.enabled():
        return report
    return dataclasses.replace(report, telemetry=_telemetry_snapshot())


@_trace.traced("plan.build", cat="plan")
def plan_contraction(
    tn,
    target_dim: int,
    method: str = "lifetime",
    tune: bool = True,
    merge: bool = True,
    repeats: int = 8,
    seed: int = 0,
    slicing_mode: str = "width",
    itemsize: int = 8,
    optimize: str = "oneshot",
    search_evals: int = 64,
    search_workers: int = 4,
    search_wall_s: float | None = None,
    budget_bytes: int | None = None,
    hw: Hardware = DEFAULT_HARDWARE,
    precision: str = "fp32",
    fidelity_tol: float | None = None,
):
    """Full planning pipeline on a tensor network.

    ``slicing_mode="peak"`` re-judges the final slicing mask against the
    lifetime-based memory plan's live-set peak instead of the width
    proxy; under ``precision="auto"`` (or ``"bf16"``) a second,
    prune-only pass counts the bf16-stored nodes at half width.  ``hw``
    prices branch merging and the modeled times.

    ``optimize="anytime"`` replaces the staged one-shot pipeline with the
    path–slice–memory co-optimizer (:func:`repro_torch.optimize.
    plan_search`): the slicer is re-invoked in place after every accepted
    tree move and candidates are scored by hoist-aware executed FLOPs
    under the certified peak budget.  ``search_evals`` / ``search_wall_s``
    are its anytime budgets over ``search_workers`` annealing workers
    (stopping early always yields a plan no worse than the one-shot
    seed); the report carries the improvement trace in
    ``PlanReport.search_trace``."""
    from ..lowering.memory import plan_memory  # lazy: avoid cycle
    from ..lowering.partition import partition_tree  # lazy: cycle
    from ..optimize import oneshot_plan, plan_search

    t0 = time.perf_counter()
    search_trace = None
    search_evals_spent = 0
    search_budget, feasible = 0, True
    if optimize == "anytime":
        sr = plan_search(
            tn, target_dim, budget_bytes=budget_bytes, itemsize=itemsize,
            num_workers=search_workers, max_evals=search_evals,
            wall_clock_s=search_wall_s, seed=seed, method=method, tune=tune,
            merge=merge, repeats=repeats, slicing_mode=slicing_mode,
            precision=precision, fidelity_tol=fidelity_tol, hw=hw,
        )
        tree, smask = sr.tree, sr.smask
        width0 = sr.width_before  # raw greedy seed width, as in oneshot
        search_trace = [dataclasses.asdict(t) for t in sr.trace]
        search_evals_spent = sr.evaluations
        search_budget, feasible = sr.budget_bytes, sr.feasible
    elif optimize == "oneshot":
        shot = oneshot_plan(
            tn, target_dim, method=method, tune=tune, merge=merge,
            repeats=repeats, seed=seed, slicing_mode=slicing_mode,
            itemsize=itemsize, budget_bytes=budget_bytes, hw=hw,
            precision=precision, fidelity_tol=fidelity_tol,
        )
        tree, smask, width0 = shot.tree, shot.smask, shot.width_before
    else:
        raise ValueError(f"unknown optimize {optimize!r}")
    wall = time.perf_counter() - t0
    naive_overhead = tree.slicing_overhead(smask)
    invariant_fraction = 0.0
    hoisted_overhead = naive_overhead
    part = None
    if smask:
        part = partition_tree(tree, smask)
        invariant_fraction = part.invariant_fraction
        hoisted_overhead = part.hoisted_overhead()
    modeled = modeled_tree_time(tree, smask, hw)
    mem = plan_memory(tree, smask, itemsize=itemsize, part=part)
    report = PlanReport(
        num_tensors=tn.num_tensors,
        width_before=width0,
        width_after=tree.sliced_width(smask),
        log2_cost=tree.log2_total_cost(),
        log2_sliced_cost=math.log2(tree.sliced_cost(smask)),
        num_sliced=popcount(smask),
        slicing_overhead=naive_overhead,
        modeled_time_s=modeled,
        plan_wall_s=wall,
        invariant_fraction=invariant_fraction,
        measured_overhead=hoisted_overhead,
        modeled_time_hoisted_s=modeled * hoisted_overhead / naive_overhead,
        peak_bytes=mem.peak_bytes,
        peak_bytes_hoisted=mem.peak_bytes_hoisted,
        buffer_slots=mem.buffer_slots,
        optimize=optimize,
        search_evals=search_evals_spent,
        search_trace=search_trace,
        budget_bytes=search_budget,
        feasible=feasible,
        hardware=hw.name,
    )
    return tree, smask, report


def plan_compiled(
    tn,
    target_dim: int,
    dtype=torch.complex64,
    backend: str = "gemm",
    device="cuda",
    precision: str = "fp32",
    hoist: bool = True,
    hw: Hardware = DEFAULT_HARDWARE,
    fused: bool = True,
    fidelity_tol: float | None = None,
    method: str = "lifetime",
    tune: bool = True,
    merge: bool = True,
    repeats: int = 8,
    seed: int = 0,
    slicing_mode: str = "width",
    optimize: str = "oneshot",
    search_evals: int = 64,
    search_workers: int = 4,
    search_wall_s: float | None = None,
    budget_bytes: int | None = None,
    use_cache: bool = True,
    telemetry: bool | None = None,
) -> tuple[ContractionPlan, PlanReport]:
    """Plan + lower a network into an executable :class:`ContractionPlan`
    on ``device``, consulting the compiled-plan cache.

    ``method``/``tune``/``merge``/``repeats``/``seed``/``slicing_mode``/
    ``budget_bytes`` and the planner mode ``optimize`` (``"oneshot"`` or
    ``"anytime"``, with ``search_evals``/``search_workers``/
    ``search_wall_s``) go to :func:`plan_contraction`.  ``precision``
    (``"fp32"``, ``"bf16"`` or ``"auto"``) and ``fidelity_tol`` select the
    mixed-precision schedule (see :class:`ContractionPlan`).

    The cache key is the canonical network fingerprint (structure + dtype
    + open indices, invariant under index relabeling) plus every planner
    and lowering parameter — the reference's key without its
    environment-driven parts, with ``fused`` (an argument here), the
    device and the :class:`~repro_torch.hardware.Hardware` (its name and
    constants) added — so a hit returns the *identical* plan object, with
    its hoist cache and the kernels' launch state.  The fidelity
    tolerance joins the key only off fp32, and the search parameters only
    under ``optimize="anytime"`` (a searched plan is cache-addressable; it
    is deterministic across processes only when ``search_wall_s`` is
    ``None``).  Concurrent misses on one key
    plan once (single flight).  ``hoist`` is an execution-time choice and
    is not part of the key.  ``use_cache=False`` plans afresh.

    ``telemetry=True`` forces span tracing + metrics on for this call
    (``False`` forces off, ``None`` leaves the tracer as it is); when
    tracing is on the report carries ``PlanReport.telemetry``.  The
    toggle never joins the key: traced and untraced calls share entries.
    """
    with _trace.enabled_scope(telemetry):
        plan, report = _plan_compiled(
            tn, target_dim, dtype=dtype, backend=backend, device=device,
            precision=precision, hoist=hoist, hw=hw, fused=fused,
            fidelity_tol=fidelity_tol, method=method, tune=tune, merge=merge,
            repeats=repeats, seed=seed, slicing_mode=slicing_mode,
            optimize=optimize, search_evals=search_evals,
            search_workers=search_workers, search_wall_s=search_wall_s,
            budget_bytes=budget_bytes, use_cache=use_cache,
        )
        report = _with_telemetry(report)
    return plan, report


def _plan_compiled(
    tn, target_dim, dtype, backend, device, precision, hoist, hw, fused,
    fidelity_tol, use_cache, **planner,
) -> tuple[ContractionPlan, PlanReport]:
    from ..lowering.cache import PLAN_CACHE, PlanEntry, network_fingerprint
    from ..lowering.precision import DEFAULT_FIDELITY_TOL, check_mode
    from .executor import resolve_device

    backend = backend if backend is not None else default_backend()
    device = resolve_device(device)
    precision = check_mode(precision)
    t0 = time.perf_counter()

    def build() -> PlanEntry:
        return PlanEntry(*_plan_fresh(
            tn, target_dim, dtype=dtype, backend=backend, device=device,
            precision=precision, hoist=hoist, hw=hw, fused=fused,
            fidelity_tol=fidelity_tol, t0=t0, **planner,
        ))

    if not use_cache:
        ent = build()
        return ent.plan, ent.report
    tol = DEFAULT_FIDELITY_TOL if fidelity_tol is None else float(fidelity_tol)
    p = planner
    # the search parameters shape the plan only under optimize="anytime":
    # kept out of the one-shot key so ignored knobs cause no misses
    search_key = (
        (p["search_evals"], p["search_workers"], p["search_wall_s"])
        if p["optimize"] == "anytime"
        else ()
    )
    key = network_fingerprint(
        tn,
        dtype,
        extra=(backend, target_dim, p["method"], p["tune"], p["merge"],
               p["repeats"], p["seed"], p["slicing_mode"], fused,
               p["optimize"], p["budget_bytes"], search_key, precision,
               tol if precision != "fp32" else None,
               str(device), dataclasses.astuple(hw)),
    )
    fresh: list[PlanEntry] = []

    def factory() -> PlanEntry:
        ent = build()
        fresh.append(ent)
        return ent

    ent = PLAN_CACHE.single_flight(key, factory)
    stats = PLAN_CACHE.stats()
    if fresh:  # this thread planned: report the fresh planning run
        return ent.plan, dataclasses.replace(
            ent.report, cache_hits=stats["hits"], cache_misses=stats["misses"]
        )
    # a hit, or a wait on another thread's planning: the hoist mode is
    # this call's, so re-derive what depends on it
    plan = ent.plan
    report = dataclasses.replace(
        ent.report,
        plan_wall_s=time.perf_counter() - t0,
        cache_hit=True,
        cache_hits=stats["hits"],
        cache_misses=stats["misses"],
        telemetry=None,
    )
    _set_hoist(plan, report, hoist)
    return plan, report


def _set_hoist(plan: ContractionPlan, report: PlanReport, hoist: bool) -> None:
    """The report fields that follow the execution-time hoist mode."""
    report.hoist = bool(hoist and plan.can_hoist)
    report.measured_overhead = plan.executed_overhead(report.hoist)
    if plan.chain_plan is not None:
        seg = "epilogue" if report.hoist and plan.num_sliced else "naive"
        report.chain_hbm_bytes_saved = plan.chain_plan.hbm_bytes_saved(seg)


def _plan_fresh(
    tn, target_dim, dtype, backend, device, precision, hoist, hw, fused,
    fidelity_tol, t0, **planner,
) -> tuple[ContractionPlan, PlanReport]:
    """One fresh planning + lowering run (no cache consultation) — the
    body a :meth:`PlanCache.single_flight` leader executes."""
    tree, smask, report = plan_contraction(
        tn, target_dim, itemsize=dtype.itemsize, hw=hw, precision=precision,
        fidelity_tol=fidelity_tol, **planner
    )
    with _trace.span("plan.lower", cat="plan", backend=backend):
        plan = ContractionPlan(
            tree, smask, backend=backend, dtype=dtype, precision=precision,
            device=device, hw=hw, fused=fused, fidelity_tol=fidelity_tol,
        )
    report.backend = plan.backend
    report.precision = plan.precision_mode
    if plan.precision_mode != "fp32":
        report.fidelity_tol = plan.fidelity_tol
    report.invariant_fraction = plan.invariant_fraction
    if plan.schedule is not None:
        sched = plan.schedule
        report.modeled_time_s = sched.modeled_time_s * (1 << plan.num_sliced)
        prologue_t = sum(
            sched.specs[k].modeled_time_s for k in plan.prologue_idx
        )
        report.modeled_time_hoisted_s = prologue_t + (
            sched.modeled_time_s - prologue_t
        ) * (1 << plan.num_sliced)
        report.lowered_backends = sched.backend_counts()
        report.pad_waste = sched.pad_waste()
        report.transpose_bytes_saved = sched.transpose_bytes_eliminated()
        report.precision_counts = sched.precision_counts()
        report.predicted_amp_error = sched.predicted_amp_error
        if plan._itemsize_of:
            # bf16-stored nodes shrink the live-set peak: the memory
            # fields follow the plan's own dtype-true memory plan
            # (plan_contraction counted full-width storage)
            mem = plan.memory_plan()
            report.peak_bytes = mem.peak_bytes
            report.peak_bytes_hoisted = mem.peak_bytes_hoisted
            report.buffer_slots = mem.buffer_slots
    if plan.chain_plan is not None:
        cp = plan.chain_plan
        report.fused_chains = cp.num_multi
        report.max_chain_len = max((c.n_steps for c in cp.chains), default=0)
    _set_hoist(plan, report, hoist)
    report.plan_wall_s = time.perf_counter() - t0
    return plan, report


def _network(circuit, bitstring: str):
    from ..quantum.circuits import circuit_to_network  # avoid import cycle

    tn, arrays = circuit_to_network(circuit, bitstring=bitstring)
    return simplify_network(tn, arrays)


def simulate_amplitude(
    circuit,
    bitstring: str,
    target_dim: int = 20,
    backend: str = "gemm",
    hoist: bool = True,
    device="cuda",
    precision: str = "fp32",
    fidelity_tol: float | None = None,
    use_cache: bool = True,
    telemetry: bool | None = None,
    **plan_kwargs,
) -> SimulationResult:
    """Amplitude <bitstring|C|0…0> via the full planner + executor stack
    on ``device``.  ``precision``/``fidelity_tol`` select the
    mixed-precision schedule; ``plan_kwargs`` go to
    :func:`plan_compiled` (the planner mode ``optimize="anytime"`` with
    ``search_evals``/``search_workers``/``search_wall_s`` among them).
    Two calls on the same circuit share one plan through the plan cache
    (different bitstrings change leaf values, never network structure);
    ``telemetry=True`` traces the call."""
    with _trace.enabled_scope(telemetry):
        tn, arrays = _network(circuit, bitstring)
        plan, report = plan_compiled(
            tn, target_dim, backend=backend, device=device, hoist=hoist,
            precision=precision, fidelity_tol=fidelity_tol,
            use_cache=use_cache, **plan_kwargs,
        )
        value = plan.contract_all(arrays, hoist=hoist).cpu().numpy()
        report = _with_telemetry(report)
    return SimulationResult(value, report, plan.tree, plan.smask, plan)


def open_amplitude_batch(
    circuit,
    open_qubits=None,
    base_bitstring: str | None = None,
    target_dim: int = 20,
    backend: str = "gemm",
    hoist: bool = True,
    device="cuda",
    precision: str = "fp32",
    fidelity_tol: float | None = None,
    use_cache: bool = True,
    telemetry: bool | None = None,
    devices=None,
    **plan_kwargs,
):
    """Contract one open-qubit batch: all ``2^k`` correlated amplitudes
    sharing ``base_bitstring`` outside ``open_qubits`` (default: the last
    ``min(6, n)`` qubits open, all-zeros base).  The serving engine
    (:mod:`repro_torch.engine.server`) calls this directly: one batch
    contraction answers a coalesced group of amplitude requests or feeds
    any number of per-tenant :func:`draw_from_batch` calls.  ``devices``
    splits the slice ids over a list of devices (see
    :func:`repro_torch.sampling.batch.contract_amplitude_batch`); the plan
    is built on ``device``.

    Returns ``(AmplitudeBatch, PlanReport)``."""
    from ..sampling import AmplitudeBatch, batch as batch_mod

    n = circuit.num_qubits
    if open_qubits is None:
        k = min(6, n)
        open_qubits = tuple(range(n - k, n))
    open_qubits = tuple(sorted(set(open_qubits)))
    if not open_qubits:
        raise ValueError("need at least one open qubit")
    if base_bitstring is None:
        base_bitstring = "0" * n
    elif len(base_bitstring) != n or set(base_bitstring) - {"0", "1"}:
        raise ValueError(
            f"base_bitstring must be {n} chars of 0/1, got {base_bitstring!r}"
        )
    with _trace.enabled_scope(telemetry):
        tn, arrays = batch_mod.open_batch_network(
            circuit, base_bitstring, open_qubits
        )
        # open indices cannot be sliced: the width floor is the batch rank
        plan, report = plan_compiled(
            tn, max(target_dim, len(open_qubits) + 1), backend=backend,
            device=device, hoist=hoist, precision=precision,
            fidelity_tol=fidelity_tol, use_cache=use_cache, **plan_kwargs,
        )
        amps = batch_mod.contract_amplitude_batch(
            plan, arrays, hoist=hoist, devices=devices,
        )
        report = _with_telemetry(report)
    return AmplitudeBatch(amps, open_qubits, base_bitstring, n), report


def draw_from_batch(
    batch,
    num_samples: int,
    sampler: str = "frequency",
    seed: int = 0,
    report: PlanReport | None = None,
):
    """Draw + score a sample set from an already-contracted
    :class:`~repro_torch.sampling.AmplitudeBatch` (numpy
    ``default_rng(seed)`` randomness, as in the reference).  Many tenants
    can share one batch contraction and each pay only the draw."""
    from ..quantum import xeb as xeb_mod  # avoid import cycle
    from ..sampling import samplers

    if num_samples <= 0:
        raise ValueError(f"num_samples must be positive, got {num_samples}")
    if sampler not in ("frequency", "rejection", "topk"):
        raise ValueError(f"unknown sampler {sampler!r}")
    idx = samplers.draw(batch, num_samples, sampler=sampler, seed=seed)
    sampled_amps = batch.flat()[idx]
    probs = np.abs(sampled_amps) ** 2
    return samplers.SamplingResult(
        bitstrings=batch.bitstrings_for(idx),
        amplitudes=sampled_amps,
        probs=probs,
        xeb=xeb_mod.linear_xeb(batch.num_qubits, probs),
        batch=batch,
        sampler=sampler,
        report=report,
    )


def sample_bitstrings(
    circuit,
    num_samples: int = 1024,
    open_qubits=None,
    base_bitstring: str | None = None,
    target_dim: int = 20,
    seed: int = 0,
    sampler: str = "frequency",
    backend: str = "gemm",
    hoist: bool = True,
    device="cuda",
    precision: str = "fp32",
    fidelity_tol: float | None = None,
    use_cache: bool = True,
    telemetry: bool | None = None,
    devices=None,
    **plan_kwargs,
):
    """Draw correlated bitstring samples from one batched contraction —
    the paper's flagship workload (Sec. VI).

    ``open_qubits`` (default: the last ``min(6, n)`` qubits) stay open
    through the contraction stem, so a single sliced contraction yields
    all ``2^k`` amplitudes sharing the ``base_bitstring`` prefix; the
    bitstrings are drawn from that batch with ``sampler`` and scored with
    Linear XEB.  ``seed`` seeds both the planner and the sampler.
    ``devices`` (a list of devices) splits the slice ids over them.  Planner keywords (``optimize="anytime"``,
    ``search_evals``, ...) go through ``plan_kwargs`` to
    :func:`plan_compiled`.  Returns a :class:`repro_torch.sampling.
    SamplingResult`."""
    if num_samples <= 0:
        raise ValueError(f"num_samples must be positive, got {num_samples}")
    if sampler not in ("frequency", "rejection", "topk"):
        raise ValueError(f"unknown sampler {sampler!r}")  # fail pre-contraction
    with _trace.enabled_scope(telemetry):
        batch, report = open_amplitude_batch(
            circuit, open_qubits=open_qubits, base_bitstring=base_bitstring,
            target_dim=target_dim, backend=backend, hoist=hoist,
            device=device, seed=seed, precision=precision,
            fidelity_tol=fidelity_tol, use_cache=use_cache, devices=devices,
            **plan_kwargs,
        )
        res = draw_from_batch(batch, num_samples, sampler=sampler, seed=seed)
        res.report = _with_telemetry(report)
    return res


def open_session(
    circuit,
    bitstring: str,
    target_dim: int = 20,
    backend: str = "gemm",
    hoist: bool = True,
    device="cuda",
    precision: str = "fp32",
    fidelity_tol: float | None = None,
    use_cache: bool = True,
    telemetry: bool | None = None,
    **plan_kwargs,
):
    """Plan a circuit amplitude and return a live
    :class:`~repro_torch.engine.session.ContractionSession` plus its
    report, ready for ``run_slice`` / ``run_slices`` / ``run_all`` /
    ``run_sharded``.  ``plan_kwargs`` go to :func:`plan_compiled`
    (``optimize="anytime"`` among them)."""
    from ..engine.session import ContractionSession

    tn, arrays = _network(circuit, bitstring)
    plan, report = plan_compiled(
        tn, target_dim, backend=backend, device=device, hoist=hoist,
        precision=precision, fidelity_tol=fidelity_tol, use_cache=use_cache,
        telemetry=telemetry, **plan_kwargs,
    )
    return ContractionSession(plan, arrays, hoist=hoist), report
