"""Observability: span tracing, metrics, structured logging, calibration.

The measurement substrate for the port's performance claims.  Four parts:

  * :mod:`repro_torch.obs.trace` — low-overhead span tracer:
    context-manager / decorator spans on a thread-local stack, monotonic
    wall clocks, ``torch.cuda.synchronize`` sync points at phase
    boundaries, ``torch.profiler.record_function`` passthrough (spans show
    up in profiler traces), JSONL export readable by Perfetto.
  * :mod:`repro_torch.obs.metrics` — process-global named counters /
    gauges / histograms (plan-cache and HoistCache hits, misses and
    evicted bytes, slices executed, chains fused, executed FLOPs, serving
    latencies), snapshot-able as a dict and reset-able for tests.
  * :mod:`repro_torch.obs.log` — level-filtered status lines that also
    land on the trace as instant events.
  * :mod:`repro_torch.obs.calibrate` — joins per-step measured time
    (CUDA events on the card) against the refiner's modeled times and the
    lifetime planner's certified peaks into a model-vs-measured table per
    backend class.

Tracing is off by default and turned on by :func:`set_enabled`,
:class:`enabled_scope` or an entry point's ``telemetry=True``; the port
reads no environment variable for it.  The off path is no-op stubs at the
Python orchestration layer: the same kernels run on the same tensors, so
results are bitwise unchanged whether tracing is on or off.
"""

from __future__ import annotations

from . import calibrate, log, metrics, trace  # noqa: F401
from .calibrate import CalibrationReport, calibrate_plan  # noqa: F401
from .trace import (  # noqa: F401
    annotate,
    dump_trace,
    enabled,
    enabled_scope,
    get_spans,
    merge_traces,
    set_enabled,
    span,
    sync,
)


def telemetry_summary() -> dict:
    """Compact snapshot of the current telemetry state — what
    ``PlanReport.telemetry`` carries when a ``telemetry=True`` run asks
    for it: the full metrics snapshot plus per-span-name count/total-wall
    aggregates (never the raw span list — that is what
    :func:`repro_torch.obs.trace.dump_trace` is for)."""
    return {"metrics": metrics.snapshot(), "spans": trace.summary()}


def reset() -> None:
    """Clear all recorded spans and metrics (tests, between measurement
    arms).  Does not change whether tracing is enabled."""
    trace.reset()
    metrics.reset()
