"""The port's plan and hoist caches against the JAX package's.

Fingerprints must be the reference's digests; single flight, LRU and
byte-bound eviction behave as in ``tests/test_cache_concurrency.py`` and
``tests/test_obs.py``; and ``leaf_key`` keys a torch tensor by its
storage, layout and version counter, so a tensor written in place after
it was keyed misses (the reference keys immutable JAX arrays by identity).

The threaded tests use private caches, barriers and events — no sleeps —
and every join carries a timeout.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.lowering import cache as ref_cache  # noqa: E402
from repro.quantum import circuits as ref_circuits  # noqa: E402

from repro_torch.core import open_session, plan_compiled  # noqa: E402
from repro_torch.core.executor import ContractionPlan, simplify_network  # noqa: E402
from repro_torch.engine.session import ContractionSession  # noqa: E402
from repro_torch.core.tensor_network import TensorNetwork  # noqa: E402
from repro_torch.hardware import H100_SXM  # noqa: E402
from repro_torch.kernels.ref import to_pairs16  # noqa: E402
from repro_torch.lowering import cache  # noqa: E402
from repro_torch.lowering.cache import HoistCache, PlanCache, PlanEntry  # noqa: E402
from repro_torch.quantum import circuits  # noqa: E402

JOIN_S = 60


def _run_threads(n: int, fn) -> list:
    """Release ``n`` threads through a barrier into ``fn(i)``; re-raise
    the first worker exception; every join is bounded."""
    barrier = threading.Barrier(n, timeout=JOIN_S)
    results: list = [None] * n
    errors: list = []

    def work(i):
        try:
            barrier.wait()
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a worker did not finish"
    if errors:
        raise errors[0]
    return results


# ----------------------------------------------------------------------
# fingerprints: the reference's digests
# ----------------------------------------------------------------------
def _ref_and_port_networks(which: int):
    if which == 0:  # closed amplitude network, simplified
        kw = dict(bitstring="0" * 9)
        c = (3, 3, 6)
    elif which == 1:  # open-batch network
        kw = dict(bitstring="0" * 12, open_qubits=(9, 10, 11))
        c = (3, 4, 8)
    else:  # raw, unsimplified network
        kw = dict(bitstring="01" * 4)
        c = (2, 4, 5)
    ref_tn, _ = ref_circuits.circuit_to_network(ref_circuits.sycamore_like(*c), **kw)
    tn, _ = circuits.circuit_to_network(circuits.sycamore_like(*c), **kw)
    if which < 2:
        from repro.core.executor import simplify_network as ref_simplify

        ref_tn, _ = ref_simplify(ref_tn, _ref_arrays(ref_tn))
        tn, _ = simplify_network(tn, _ref_arrays(tn))
    return ref_tn, tn


def _ref_arrays(tn):
    return [np.ones([tn.size_of(ix) for ix in t], np.complex64) for t in tn.inputs]


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("extra", [(), ("gemm", 10, "lifetime", True, 0, None)])
def test_network_fingerprint_equals_reference(which, extra):
    ref_tn, tn = _ref_and_port_networks(which)
    # the reference's plan key holds jnp.dtype(complex64), whose str is
    # numpy's
    want = ref_cache.network_fingerprint(ref_tn, np.dtype("complex64"), extra=extra)
    assert cache.network_fingerprint(tn, torch.complex64, extra=extra) == want
    assert cache.network_fingerprint(tn, np.complex64, extra=extra) == want
    assert cache.network_fingerprint(tn, torch.complex128, extra=extra) != want


def test_fingerprint_invariant_under_relabeling():
    tn = TensorNetwork([("a", "b"), ("b", "c"), ("c", "a")], (), {"a": 2, "b": 3, "c": 2})
    tn2 = TensorNetwork([("x", "y"), ("y", "z"), ("z", "x")], (), {"x": 2, "y": 3, "z": 2})
    tn3 = TensorNetwork([("x", "y"), ("y", "z"), ("z", "x")], (), {"x": 2, "y": 2, "z": 2})
    assert cache.network_fingerprint(tn) == cache.network_fingerprint(tn2)
    assert cache.network_fingerprint(tn) != cache.network_fingerprint(tn3)


def test_leaf_fingerprint_equals_reference_on_host_arrays():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((2, 3)).astype(np.complex64),
              rng.standard_normal(4).astype(np.float32)]
    assert cache.leaf_fingerprint(arrays) == ref_cache.leaf_fingerprint(arrays)
    assert cache.leaf_fingerprint(arrays, [1]) == ref_cache.leaf_fingerprint(arrays, [1])
    # a tensor hashes by value like the array it holds
    as_tensors = [torch.from_numpy(a) for a in arrays]
    assert cache.leaf_fingerprint(as_tensors) == cache.leaf_fingerprint(arrays)


# ----------------------------------------------------------------------
# leaf_key: tensors by storage, layout and version; host by value
# ----------------------------------------------------------------------
def test_leaf_key_misses_after_in_place_write():
    t = torch.arange(6, dtype=torch.float32)
    k0, keep = cache.leaf_key([t])
    assert keep == (t,)
    assert cache.leaf_key([t])[0] == k0  # same tensor, unwritten: same key
    t.add_(0.0)  # an in-place write, even of the same values
    assert cache.leaf_key([t])[0] != k0
    t2 = t.clone()  # equal values, another storage: misses (the safe side)
    assert cache.leaf_key([t2])[0] != cache.leaf_key([t])[0]
    # views of one storage at another offset or stride key apart
    base = torch.zeros(8)
    keys = {cache.leaf_key([v])[0] for v in (base[:4], base[4:], base[::2])}
    assert len(keys) == 3


def test_leaf_key_hashes_host_arrays_by_value():
    a = np.arange(6, dtype=np.complex64)
    k, keep = cache.leaf_key([a, torch.ones(2)], indices=[0])
    assert keep == ()
    assert cache.leaf_key([a.copy()], indices=[0])[0] == k
    b = a.copy()
    b[0] = 7
    assert cache.leaf_key([b], indices=[0])[0] != k


def test_session_hoist_cache_hits_and_misses_after_write():
    """Two sessions over the same host leaves share one prologue; a
    tensor leaf written in place since it was keyed misses and computes
    the prologue afresh, with the new values."""
    c = circuits.sycamore_like(3, 3, 8, seed=1)
    tn, arrays = simplify_network(*circuits.circuit_to_network(c, bitstring="0" * 9))
    plan = ContractionPlan(*_tree(tn), device="cpu")
    assert plan.can_hoist
    first = ContractionSession(plan, arrays).hoisted()
    second = ContractionSession(plan, [a.copy() for a in arrays]).hoisted()
    assert all(x is y for x, y in zip(first, second))
    st = plan._hoist_cache.stats()
    assert (st["hits"], st["misses"]) == (1, 1)
    leaves = [torch.from_numpy(np.array(a)) for a in arrays]
    h1 = ContractionSession(plan, leaves).hoisted()
    i = plan.prologue_leaves[0]
    leaves[i].mul_(2)
    h2 = ContractionSession(plan, leaves).hoisted()
    assert plan._hoist_cache.stats()["misses"] == 3
    assert not all(torch.equal(x, y) for x, y in zip(h1, h2))


def _tree(tn):
    from repro_torch.core.api import plan_contraction

    tree, smask, _ = plan_contraction(tn, 6, seed=0)
    return tree, smask


# ----------------------------------------------------------------------
# single flight on a private cache
# ----------------------------------------------------------------------
def test_single_flight_one_miss_n_minus_one_hits():
    """N threads asking for one new key run its factory once: the leader
    blocks until every thread has entered, so the others find the key in
    flight (or already published), never absent."""
    n = 8
    c = PlanCache(maxsize=8)
    entered = threading.Semaphore(0)
    calls = []

    def factory():
        calls.append(threading.get_ident())
        for _ in range(n - 1):  # every other thread has entered
            assert entered.acquire(timeout=JOIN_S)
        return PlanEntry(plan="the-plan", report=None)

    def ask(i):
        entered.release()
        return c.single_flight("fam", factory)

    results = _run_threads(n, ask)
    assert len(calls) == 1
    assert all(r is results[0] for r in results)
    assert (c.misses, c.hits) == (1, n - 1)
    assert c.single_flight("fam", factory) is results[0] and len(calls) == 1


def test_single_flight_distinct_keys_run_concurrently():
    """Leaders of different keys do not serialize: the factory runs
    outside the cache lock (the barrier passes only with all inside)."""
    c = PlanCache(maxsize=8)
    inside = threading.Barrier(4, timeout=JOIN_S)

    def factory():
        inside.wait()
        return PlanEntry(plan=object(), report=None)

    results = _run_threads(4, lambda i: c.single_flight(f"fam-{i}", factory))
    assert len({id(r) for r in results}) == 4
    assert c.misses == 4


def test_single_flight_leader_failure_promotes_waiter():
    """A failing leader wakes its waiters; one of them retries as the new
    leader and the rest are served, and the key is not wedged."""
    n = 6
    c = PlanCache(maxsize=8)
    entered = threading.Semaphore(0)
    attempts = []

    def factory():
        attempts.append(None)
        if len(attempts) == 1:
            for _ in range(n - 1):
                assert entered.acquire(timeout=JOIN_S)
            raise RuntimeError("transient planning failure")
        return PlanEntry(plan="recovered", report=None)

    def ask(i):
        entered.release()
        try:
            return c.single_flight("fam", factory)
        except RuntimeError:
            return None

    results = _run_threads(n, ask)
    assert results.count(None) == 1
    assert all(r.plan == "recovered" for r in results if r is not None)
    assert len(attempts) == 2
    assert c.single_flight("fam", factory).plan == "recovered"


# ----------------------------------------------------------------------
# HoistCache: LRU order and the byte bound
# ----------------------------------------------------------------------
def test_hoist_cache_lru_order():
    c = HoistCache(maxsize=2)
    a = np.zeros(4, np.float32)
    c.put("k1", ((a,), ()))
    c.put("k2", ((a,), ()))
    assert c.get("k1") is not None  # k1 is now the most recent
    c.put("k3", ((a,), ()))  # evicts k2, the least recent
    assert c.get("k2") is None
    assert c.get("k1") is not None and c.get("k3") is not None
    st = c.stats()
    assert (st["size"], st["evictions"], st["total_bytes"]) == (2, 1, 32)


def test_hoist_cache_byte_bound_keeps_newest():
    c = HoistCache(maxsize=8, max_bytes=100)
    c.put("small", ((np.zeros(5, np.float64),), ()))  # 40 B
    c.put("big", ((torch.zeros(30, dtype=torch.float32),), ()))  # 120 B alone
    assert c.get("small") is None and c.get("big") is not None
    st = c.stats()
    assert (st["size"], st["total_bytes"], st["evicted_bytes"]) == (1, 120, 40)
    c.put("big", ((torch.zeros(2),), ()))  # re-put replaces the ledger entry
    assert c.stats()["total_bytes"] == 8
    c.clear()
    assert c.stats()["total_bytes"] == 0 and len(c) == 0


def test_hoist_cache_counts_bf16_pairs_at_their_width():
    """A bf16-stored output (bf16 (re, im) pairs) counts 4 bytes an
    element, half its complex64 width."""
    x = torch.complex(torch.randn(3, 5), torch.randn(3, 5))
    pairs = to_pairs16(x)
    assert pairs.dtype == torch.bfloat16
    assert HoistCache.entry_nbytes(((pairs,), ())) == 3 * 5 * 4
    assert HoistCache.entry_nbytes(((x, pairs), ())) == 3 * 5 * 12


def test_hoist_cache_single_flight_byte_ledger():
    c = HoistCache(maxsize=4, max_bytes=4 * 800)

    def fill(i):
        return c.single_flight(f"k{i % 6}", lambda: ([np.zeros(100, np.float64)], ()))

    _run_threads(12, fill)
    st = c.stats()
    assert st["size"] <= 4
    assert st["total_bytes"] == st["size"] * 800 <= c.max_bytes


# ----------------------------------------------------------------------
# plan_compiled through the global cache
# ----------------------------------------------------------------------
def test_plan_compiled_warm_call_returns_the_same_plan():
    c = circuits.random_1d_circuit(8, 6, seed=11)
    tn, _ = simplify_network(*circuits.circuit_to_network(c, bitstring="0" * 8))
    plan, rep = plan_compiled(tn, 10, device="cpu", seed=5)
    again, rep2 = plan_compiled(tn, 10, device="cpu", seed=5)
    assert again is plan and rep2.cache_hit and not rep.cache_hit
    assert rep2.cache_hits >= 1 and rep2.cache_misses >= 1
    assert rep2.plan_wall_s < rep.plan_wall_s
    # hoist is an execution-time choice: a hit re-derives its fields
    off, rep3 = plan_compiled(tn, 10, device="cpu", seed=5, hoist=False)
    assert off is plan and rep3.hoist is False
    assert rep3.measured_overhead == plan.executed_overhead(False)
    # planner parameters, the hardware's constants and use_cache=False
    # all give another plan
    other_hw = dataclasses.replace(H100_SXM, tile=128)  # same name
    assert plan_compiled(tn, 10, device="cpu", seed=5, hw=other_hw)[0] is not plan
    assert plan_compiled(tn, 10, device="cpu", seed=6)[0] is not plan
    fresh, rep4 = plan_compiled(tn, 10, device="cpu", seed=5, use_cache=False)
    assert fresh is not plan and not rep4.cache_hit


def test_open_session_shares_the_cached_plan_and_prologue():
    c = circuits.sycamore_like(3, 3, 8, seed=4)
    s1, r1 = open_session(c, "0" * 9, target_dim=6, device="cpu")
    s2, r2 = open_session(c, "0" * 9, target_dim=6, device="cpu")
    assert s2.plan is s1.plan and r2.cache_hit
    if s1.hoist:
        assert all(x is y for x, y in zip(s1.hoisted(), s2.hoisted()))
    assert torch.equal(s1.run_all(), s2.run_all())
