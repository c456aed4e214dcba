"""Compiled-plan cache and hoisted-prologue cache.

Planning an RQC contraction (pathfinding, slicing, tuning, merging,
lowering) costs seconds while executing one slice costs milliseconds, so
a service that re-plans per request spends most of its wall time
planning.  Circuit families are *structurally* repetitive: two amplitude
requests for the same circuit with different bitstrings produce tensor
networks that differ only in leaf values, never in structure.  This
module keys a cache on that structure:

  * :func:`network_fingerprint` canonicalizes a
    :class:`~repro_torch.core.tensor_network.TensorNetwork` by renaming
    every index to its first-appearance ordinal (so arbitrary user labels
    hash identically), then SHA-256s the structure + per-index sizes +
    open indices + dtype — the reference's digest for the same network,
    dtype and ``extra`` (a torch dtype hashes under the reference's name
    for it, ``"complex64"``);
  * a :class:`PlanCache` (thread-safe LRU with single-flight misses) maps
    ``(fingerprint, planner/lowering parameters)`` to the planned
    artifact: the live :class:`~repro_torch.core.executor.ContractionPlan`
    (tree, slicing mask, refined schedule, chain plan, memory plan) and
    its report;
  * a :class:`HoistCache` (one per plan) maps the prologue's leaf tensors
    to the materialized slice-invariant buffers.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Hashable, Sequence

import numpy as np
import torch

from ..obs import metrics as _metrics


def dtype_name(dtype) -> str:
    """The name the reference's plan key gives ``dtype`` (its
    ``str(jnp.dtype(...))``): ``torch.complex64``, ``np.complex64`` and
    ``"complex64"`` are all ``"complex64"``; ``None`` is ``"None"``."""
    if dtype is None:
        return "None"
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def network_fingerprint(tn, dtype=None, extra: tuple = ()) -> str:
    """Canonical SHA-256 fingerprint of a tensor network's structure.

    Invariant under index relabeling: labels are replaced by their
    first-appearance ordinal scanning ``tn.inputs`` in order.  ``extra``
    lets callers fold planner parameters into the digest."""
    rename: dict[Hashable, int] = {}

    def rid(ix) -> int:
        if ix not in rename:
            rename[ix] = len(rename)
        return rename[ix]

    structure = tuple(tuple(rid(ix) for ix in t) for t in tn.inputs)
    open_ids = tuple(rid(ix) for ix in tn.open_inds)
    sizes = tuple(tn.size_of(ix) for ix in rename)
    payload = repr((structure, open_ids, sizes, dtype_name(dtype), extra))
    return hashlib.sha256(payload.encode()).hexdigest()


def _host_bytes(a) -> tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of a leaf on the host."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return tuple(t.shape), dtype_name(t.dtype), data
    a = np.asarray(a)
    return a.shape, str(a.dtype), np.ascontiguousarray(a).tobytes()


def leaf_fingerprint(arrays: Sequence, indices: Sequence[int] | None = None) -> str:
    """SHA-256 over the *values* of selected leaf arrays (numpy arrays
    hash as in the reference).

    The hoisted prologue is a pure function of the prologue's leaf
    arrays, so it can be served from an LRU keyed by this digest.
    ``indices`` restricts the digest to the leaves the prologue
    consumes.  Value hashing copies device tensors to the host — the hot
    path uses :func:`leaf_key`, which keys tensors without reading them."""
    h = hashlib.sha256()
    for i in range(len(arrays)) if indices is None else indices:
        shape, dt, data = _host_bytes(arrays[i])
        h.update(repr((int(i), shape, dt)).encode())
        h.update(data)
    return h.hexdigest()


def leaf_key(
    arrays: Sequence, indices: Sequence[int] | None = None
) -> tuple[str, tuple]:
    """Cache key over leaf arrays that never copies a tensor to the host.

    A ``torch.Tensor`` leaf is keyed by its device, ``data_ptr``, storage
    offset, shape, stride, dtype **and version counter**
    (``tensor._version``, which every in-place write bumps): unlike the
    reference's immutable JAX arrays, a torch tensor can be written in
    place after it was keyed, and such a tensor must miss.  Host leaves
    (numpy and anything else) hash by value, as in the reference.

    Returns ``(digest, keepalive)``.  **The caller must store
    ``keepalive`` alongside the cache entry**: it holds the keyed tensors
    so their storage cannot be freed and reused by another tensor (a
    reused ``data_ptr`` at version 0 would alias a stale entry) while the
    entry is alive.  Equal-valued but distinct tensors miss — the safe
    direction; a miss only costs one prologue run."""
    h = hashlib.sha256()
    keepalive = []
    for i in range(len(arrays)) if indices is None else indices:
        a = arrays[i]
        if isinstance(a, torch.Tensor):
            h.update(repr((
                "dev", int(i), str(a.device), a.data_ptr(), a.storage_offset(),
                tuple(a.shape), tuple(a.stride()), dtype_name(a.dtype), a._version,
            )).encode())
            keepalive.append(a)
        else:
            a = np.asarray(a)
            h.update(repr(("host", int(i), a.shape, str(a.dtype))).encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest(), tuple(keepalive)


@dataclasses.dataclass
class PlanEntry:
    """Cached planning artifact for one (network family, params) key."""

    plan: Any  # ContractionPlan (tree, smask, schedule, hoist cache)
    report: Any  # PlanReport template from the original planning run


class PlanCache:
    """Thread-safe LRU cache of compiled contraction plans."""

    #: prefix for the obs counters this cache bumps (``<prefix>.hits`` /
    #: ``<prefix>.misses``); subclasses override so their traffic is
    #: attributable separately in a metrics snapshot.
    _metric = "plan_cache"

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._entries: OrderedDict[str, Any] = OrderedDict()
        self._lock = threading.Lock()
        self._inflight: dict[str, threading.Event] = {}
        self.hits = 0
        self.misses = 0

    def _hit(self, key: str):
        """The entry for ``key`` counted as a hit (lock held), or None."""
        ent = self._entries.get(key)
        if ent is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            _metrics.inc(f"{self._metric}.hits")
        return ent

    def get(self, key: str):
        with self._lock:
            ent = self._hit(key)
            if ent is None:
                self.misses += 1
                _metrics.inc(f"{self._metric}.misses")
            return ent

    def put(self, key: str, entry) -> None:
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)

    def single_flight(self, key: str, factory):
        """Return the entry for ``key``, computing it at most once across
        concurrent threads.

        The first thread to miss becomes the *leader*: it runs
        ``factory()`` outside the lock (planning takes seconds — holding
        the lock would serialize unrelated families) and publishes the
        result with :meth:`put`.  Threads that miss while the key is in
        flight wait on the leader's event instead of replanning.  A
        leader whose factory raises wakes the waiters and clears the
        in-flight mark; the next waiter retries as the new leader, so a
        transient failure never wedges the key.  Waiters count as hits,
        the leader as the one miss."""
        while True:
            with self._lock:
                ent = self._hit(key)
                if ent is not None:
                    return ent
                ev = self._inflight.get(key)
                leader = ev is None
                if leader:
                    ev = self._inflight[key] = threading.Event()
                    self.misses += 1
                    _metrics.inc(f"{self._metric}.misses")
            if leader:
                try:
                    value = factory()
                    self.put(key, value)
                    return value
                finally:
                    with self._lock:
                        self._inflight.pop(key, None)
                    ev.set()
            ev.wait()
            # loop: entry present on leader success; leader failure
            # promotes this waiter to leader on the next pass

    def __len__(self) -> int:
        return len(self._entries)

    def values(self) -> list:
        """A snapshot of the cached entries, least recent first."""
        with self._lock:
            return list(self._entries.values())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._entries),
                "maxsize": self.maxsize,
                "hits": self.hits,
                "misses": self.misses,
            }


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(getattr(a, "nbytes", 0))


class HoistCache(PlanCache):
    """LRU of materialized slice-invariant prologue tensors, keyed by
    :func:`leaf_key` of the prologue's leaf arrays.

    One instance lives on each :class:`~repro_torch.core.executor.
    ContractionPlan` (the hoisted buffers are only meaningful for that
    plan's partition); the stored value is ``(outputs, keepalive)`` — the
    hoisted tensors in ``partition.hoisted_nodes`` order and the key's
    keep-alive references, which live exactly as long as the entry.

    Entries hold device tensors, so eviction is what releases device
    memory.  Beyond the entry-count ``maxsize``, an optional
    ``max_bytes`` bounds the summed ``outputs`` bytes (a bf16-pair
    output counts at its stored width) — oldest entries are evicted until
    the total fits (the newest entry is always kept, even when it alone
    exceeds the bound: a best-effort LRU bound, not an admission
    policy)."""

    _metric = "hoist_cache"

    def __init__(self, maxsize: int = 8, max_bytes: int | None = None):
        super().__init__(maxsize=maxsize)
        self.max_bytes = max_bytes
        self._entry_bytes: OrderedDict[str, int] = OrderedDict()
        self.total_bytes = 0
        self.evictions = 0
        self.evicted_bytes = 0

    @staticmethod
    def entry_nbytes(value) -> int:
        return sum(_nbytes(a) for a in value[0])

    def put(self, key: str, value) -> None:
        nbytes = self.entry_nbytes(value)
        with self._lock:
            self.total_bytes -= self._entry_bytes.pop(key, 0)
            self._entries[key] = value
            self._entries.move_to_end(key)
            self._entry_bytes[key] = nbytes
            self.total_bytes += nbytes
            while len(self._entries) > 1 and (
                len(self._entries) > self.maxsize
                or (self.max_bytes is not None and self.total_bytes > self.max_bytes)
            ):
                evicted, _ = self._entries.popitem(last=False)
                freed = self._entry_bytes.pop(evicted)
                self.total_bytes -= freed
                self.evictions += 1
                self.evicted_bytes += freed
                _metrics.inc(f"{self._metric}.evictions")
                _metrics.inc(f"{self._metric}.evicted_bytes", freed)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._entry_bytes.clear()
            self.total_bytes = 0
            self.hits = 0
            self.misses = 0
            self.evictions = 0
            self.evicted_bytes = 0

    def stats(self) -> dict:
        out = super().stats()
        with self._lock:
            out.update(
                total_bytes=self.total_bytes,
                max_bytes=self.max_bytes,
                evictions=self.evictions,
                evicted_bytes=self.evicted_bytes,
            )
        return out


#: process-global cache used by :mod:`repro_torch.core.api` (its size is
#: this constructor's argument; the port reads no environment variable)
PLAN_CACHE = PlanCache(maxsize=64)
