"""Span tracer: thread-local span stacks, monotonic wall, JSONL export.

Design constraints (as in the reference's tracer):

  * **Zero-overhead off path.**  Tracing is off by default: :func:`span`
    then returns a shared no-op context manager and :func:`sync` /
    :func:`instant` return on one boolean check.  Instrumentation lives
    at the Python orchestration layer only, so with tracing on or off the
    same kernels run on the same tensors and results are bitwise equal.
  * **Well-formed span trees.**  Spans nest on a thread-local stack:
    every record carries its parent's id, and per thread the intervals
    are properly nested (children inside parents, siblings
    non-overlapping) because enter/exit order is stack order.
  * **Profiler passthrough.**  An active span also enters
    ``torch.profiler.record_function(name)``, so the same names show up
    on the host timeline of a ``torch.profiler`` trace when one is being
    captured.
  * **Sync points.**  Wall times at phase boundaries are only meaningful
    once launched work retires; :func:`sync` is
    ``torch.cuda.synchronize(device)`` for CUDA tensors, gated on the
    tracing flag, so enabling tracing adds the barriers and disabling it
    leaves asynchronous launches untouched.

The flag is set by :func:`set_enabled` / :class:`enabled_scope` (the API
layer's per-call ``telemetry=`` argument); the port reads no environment
variable for it.

Export is Chrome-trace-event JSONL (one complete-event object per line)
via :func:`dump_trace`; ``fmt="chrome"`` wraps the same events as
``{"traceEvents": [...]}`` which Perfetto / ``chrome://tracing`` open
directly.  :func:`merge_traces` concatenates per-process JSONL files
(each record carries its pid) into one timeline.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import threading
import time

import torch

#: recorded spans are dropped beyond this cap (a long traced session
#: must not grow memory without bound); drops are counted in
#: ``metrics`` under ``trace.dropped_spans``.
MAX_SPANS = 200_000

_enabled = False
_lock = threading.Lock()
_records: list[SpanRecord] = []
_ids = itertools.count(1)
_tls = threading.local()


def enabled() -> bool:
    """Whether tracing is currently on (off until :func:`set_enabled` or
    :class:`enabled_scope` turns it on)."""
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


class enabled_scope:
    """Temporarily force tracing on/off (``None`` leaves it unchanged) —
    the implementation of the API layer's per-call ``telemetry=``
    toggle.  Process-global, like the flag itself: overlapping scopes
    from concurrent threads see last-writer-wins, the documented
    limitation of a per-call toggle on a process-global tracer."""

    def __init__(self, on: bool | None):
        self.on = on
        self._prev = None

    def __enter__(self):
        if self.on is not None:
            self._prev = _enabled
            set_enabled(self.on)
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            set_enabled(self._prev)
        return False


@dataclasses.dataclass
class SpanRecord:
    """One finished span (flat record; the tree is in ``parent_id``)."""

    span_id: int
    parent_id: int  # 0 = top-level span of its thread
    name: str
    cat: str
    t_start: float  # time.perf_counter seconds
    t_end: float
    thread: int
    pid: int
    attrs: dict

    @property
    def dur_s(self) -> float:
        return self.t_end - self.t_start

    def event(self) -> dict:
        """Chrome trace 'complete' event (Perfetto-compatible)."""
        args = dict(self.attrs)
        args["span_id"] = self.span_id
        args["parent_id"] = self.parent_id
        return {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": self.t_start * 1e6,
            "dur": self.dur_s * 1e6,
            "pid": self.pid,
            "tid": self.thread,
            "args": args,
        }


class _Noop:
    """Shared do-nothing span/annotation for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _Noop()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _append(rec: SpanRecord) -> None:
    with _lock:
        if len(_records) < MAX_SPANS:
            _records.append(rec)
            return
    from . import metrics  # local: avoid import cycle at init

    metrics.REGISTRY.counter("trace.dropped_spans").inc(1)


class _Span:
    __slots__ = ("name", "cat", "attrs", "span_id", "parent_id", "t0", "_ann")

    def __init__(self, name: str, cat: str, attrs: dict):
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def set(self, **attrs):
        """Attach attributes to a live span (measured values only become
        known mid-span, e.g. a cache hit discovered after the lookup)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        st = _stack()
        self.parent_id = st[-1].span_id if st else 0
        self.span_id = next(_ids)
        st.append(self)
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._ann.__exit__(*exc)
        st = _stack()
        # tolerate exits out of stack order (a generator holding a span
        # across yields): unwind to this span if present
        if self in st:
            while st and st[-1] is not self:
                st.pop()
            st.pop()
        _append(SpanRecord(
            span_id=self.span_id,
            parent_id=self.parent_id,
            name=self.name,
            cat=self.cat,
            t_start=self.t0,
            t_end=t1,
            thread=threading.get_ident(),
            pid=os.getpid(),
            attrs=self.attrs,
        ))
        return False


def span(name: str, cat: str = "span", **attrs):
    """Context manager recording one span.  No-op (shared stub, no
    allocation beyond the kwargs dict) when tracing is off."""
    if not _enabled:
        return _NOOP
    return _Span(name, cat, attrs)


def traced(name: str | None = None, cat: str = "fn"):
    """Decorator form of :func:`span` (checks the flag per call, so a
    decorated function stays zero-overhead while tracing is off)."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            with _Span(label, cat, {}):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def annotate(name: str):
    """Profiler-only annotation (``torch.profiler.record_function``):
    for launch sites where a wall-clock span would time the enqueue, not
    the work.  No-op when tracing is off."""
    if not _enabled:
        return _NOOP
    return torch.profiler.record_function(name)


def _devices(x, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _devices(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _devices(y, out)
    return out


def sync(x):
    """Phase-boundary sync point: ``torch.cuda.synchronize`` on every
    CUDA device ``x`` (a tensor, or a list/tuple/dict of them) lives on
    when tracing is on (span walls then measure retired work, not the
    enqueue), the identity when off (asynchronous launches untouched)."""
    if not _enabled:
        return x
    for dev in _devices(x, set()):
        torch.cuda.synchronize(dev)
    return x


def instant(name: str, cat: str = "instant", **attrs) -> None:
    """Zero-duration event (structured log records ride on these)."""
    if not _enabled:
        return
    t = time.perf_counter()
    st = _stack()
    _append(SpanRecord(
        span_id=next(_ids),
        parent_id=st[-1].span_id if st else 0,
        name=name,
        cat=cat,
        t_start=t,
        t_end=t,
        thread=threading.get_ident(),
        pid=os.getpid(),
        attrs=attrs,
    ))


def get_spans() -> list[SpanRecord]:
    """Finished spans recorded so far (snapshot copy)."""
    with _lock:
        return list(_records)


def reset() -> None:
    """Drop all recorded spans (open spans on any stack still record on
    exit)."""
    with _lock:
        _records.clear()


def summary() -> dict:
    """Per-name aggregates: ``{name: {count, total_s, max_s}}``."""
    out: dict[str, dict] = {}
    for rec in get_spans():
        agg = out.setdefault(
            rec.name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
        )
        agg["count"] += 1
        agg["total_s"] += rec.dur_s
        agg["max_s"] = max(agg["max_s"], rec.dur_s)
    return out


def dump_trace(path: str, fmt: str = "jsonl") -> int:
    """Write all recorded spans to ``path``; returns the event count.

    ``fmt="jsonl"`` (default): one Chrome-trace complete-event object
    per line — greppable, appendable, mergeable across processes.
    ``fmt="chrome"``: the same events wrapped as
    ``{"traceEvents": [...]}`` — open directly in Perfetto or
    ``chrome://tracing``.
    """
    if fmt not in ("jsonl", "chrome"):
        raise ValueError(f"unknown trace format {fmt!r}")
    events = [rec.event() for rec in get_spans()]
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        if fmt == "jsonl":
            for ev in events:
                f.write(json.dumps(ev) + "\n")
        else:
            json.dump({"traceEvents": events}, f)
    return len(events)


def merge_traces(paths, out_path: str) -> int:
    """Merge per-process JSONL traces into one JSONL timeline.

    Each event already carries its producer's ``pid``, so merging is
    concatenation sorted by start time; Perfetto renders distinct pids as
    distinct process tracks.  Returns the merged event count."""
    events: list[dict] = []
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    events.append(json.loads(line))
    events.sort(key=lambda ev: ev.get("ts", 0.0))
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return len(events)
