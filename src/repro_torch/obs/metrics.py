"""Process-global metrics registry: named counters, gauges, histograms.

The numeric side of the observability layer (spans answer *where time
went*; metrics answer *how much work happened*): plan-cache and
HoistCache hits/misses/evicted bytes, slices executed, fused-chain
dispatches, executed FLOPs, serving queue/compute latencies.  The
registry is thread-safe, snapshot-able as one plain dict
(:func:`snapshot`) and reset-able for tests (:func:`reset`).

Writer/snapshot consistency: every instrument mutation happens under the
registry's (reentrant) lock — the same lock :meth:`Registry.snapshot`
holds — so a snapshot is a *point-in-time* view.  In particular a
histogram can never be read torn (``count`` bumped but ``total`` not)
while another thread is mid-``observe``, and concurrent ``inc`` calls
never lose updates; this is what makes the registry safe under the
serving engine's threaded dispatch.

Cardinality: the helpers accept an optional ``label`` (e.g. a serving
family fingerprint).  Labeled series materialize as
``name{label}`` entries, and the registry caps the distinct labels per
base name (:attr:`Registry.max_labels`, default 64) — the overflow
collapses into ``name{_other}``, so per-request labels can never grow a
snapshot without bound.

The module-level helpers :func:`inc` / :func:`set_gauge` /
:func:`observe` are the instrumentation entry points: they early-return
on the shared tracing flag (see :mod:`repro_torch.obs.trace`), so hot
paths stay zero-overhead with telemetry off.  Direct registry access
(``REGISTRY.counter(name)``) bypasses the gate — for tests and for the
tracer's own bookkeeping.
"""

from __future__ import annotations

import threading

from .trace import enabled

#: label value unbounded-cardinality series collapse into
OVERFLOW_LABEL = "_other"


class Counter:
    """Monotonic accumulator (``int`` or ``float`` increments)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.RLock | None = None):
        self.value = 0
        self._lock = lock if lock is not None else threading.RLock()

    def inc(self, v=1):
        with self._lock:
            self.value += v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.RLock | None = None):
        self.value = 0
        self._lock = lock if lock is not None else threading.RLock()

    def set(self, v):
        with self._lock:
            self.value = v


class Histogram:
    """Streaming summary (count/total/min/max) — enough for wall-time
    and byte-size distributions without bucket configuration.  The four
    fields mutate atomically (one lock around the whole ``observe``), so
    a concurrent reader can never see them disagree."""

    __slots__ = ("count", "total", "min", "max", "_lock")

    def __init__(self, lock: threading.RLock | None = None):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._lock = lock if lock is not None else threading.RLock()

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def summary(self) -> dict:
        with self._lock:
            return {
                "count": self.count,
                "total": self.total,
                "min": self.min,
                "max": self.max,
                "mean": self.total / self.count if self.count else None,
            }


class Registry:
    """Thread-safe name → instrument map, one per kind.

    Instruments share the registry's reentrant lock, so snapshots and
    mutations serialize against each other (see module docstring)."""

    def __init__(self, max_labels: int = 64):
        # reentrant: snapshot() holds it while Histogram.summary() takes
        # it again through the shared instrument lock
        self._lock = threading.RLock()
        self.max_labels = int(max_labels)
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._labels: dict[str, set[str]] = {}

    def labeled(self, name: str, label) -> str:
        """Series name for ``name`` + ``label``, enforcing the per-base
        cardinality cap: the first ``max_labels`` distinct labels get
        their own series, later ones collapse into ``{_other}``."""
        if label is None:
            return name
        label = str(label)
        with self._lock:
            seen = self._labels.setdefault(name, set())
            if label not in seen:
                if len(seen) >= self.max_labels:
                    label = OVERFLOW_LABEL
                else:
                    seen.add(label)
        return f"{name}{{{label}}}"

    def counter(self, name: str, label=None) -> Counter:
        name = self.labeled(name, label)
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(self._lock)
            return c

    def gauge(self, name: str, label=None) -> Gauge:
        name = self.labeled(name, label)
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(self._lock)
            return g

    def histogram(self, name: str, label=None) -> Histogram:
        name = self.labeled(name, label)
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(self._lock)
            return h

    def snapshot(self) -> dict:
        """One plain dict of everything — JSON-serializable, suitable
        for ``PlanReport.telemetry`` and workflow artifacts.  Taken
        under the shared instrument lock: a consistent point-in-time
        view even with writers mid-flight on other threads."""
        with self._lock:
            return {
                "counters": {
                    k: c.value for k, c in sorted(self._counters.items())
                },
                "gauges": {
                    k: g.value for k, g in sorted(self._gauges.items())
                },
                "histograms": {
                    k: h.summary()
                    for k, h in sorted(self._histograms.items())
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._labels.clear()


#: the process-global registry
REGISTRY = Registry()


def inc(name: str, v=1, label=None) -> None:
    """Increment counter ``name`` — no-op while telemetry is off."""
    if enabled():
        REGISTRY.counter(name, label=label).inc(v)


def set_gauge(name: str, v, label=None) -> None:
    """Set gauge ``name`` — no-op while telemetry is off."""
    if enabled():
        REGISTRY.gauge(name, label=label).set(v)


def observe(name: str, v, label=None) -> None:
    """Record one histogram observation — no-op while telemetry is off."""
    if enabled():
        REGISTRY.histogram(name, label=label).observe(v)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
