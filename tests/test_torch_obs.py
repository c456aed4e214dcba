"""The port's observability layer against the JAX package's: the off
path, span integrity, the metrics registry, cache counters, export,
logging and calibration (twins of ``tests/test_obs.py``), plus the
counters of the pinned syc-12 plan held equal to the reference's.

With tracing off the port adds no synchronization and records nothing;
with it on, the same kernels run on the same tensors, so amplitudes are
bitwise equal either way.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as ref_obs  # noqa: E402
from conftest import subprocess_kwargs  # noqa: E402
from repro.core.executor import ContractionPlan as RefPlan  # noqa: E402
from repro.core.executor import simplify_network as ref_simplify  # noqa: E402
from repro.core.pathfinder import random_greedy_tree as ref_greedy  # noqa: E402
from repro.core.slicing import find_slices as ref_find_slices  # noqa: E402
from repro.quantum import circuits as ref_circuits  # noqa: E402
from test_torch_planner import REF_HW  # noqa: E402

import repro_torch.obs as obs  # noqa: E402
from repro_torch.core import plan_compiled, simulate_amplitude  # noqa: E402
from repro_torch.core.executor import ContractionPlan, simplify_network  # noqa: E402
from repro_torch.core.pathfinder import random_greedy_tree  # noqa: E402
from repro_torch.core.slicing import find_slices  # noqa: E402
from repro_torch.hardware import H100_SXM  # noqa: E402
from repro_torch.lowering.cache import HoistCache, PlanCache, PlanEntry  # noqa: E402
from repro_torch.obs import log as obs_log, metrics, trace  # noqa: E402
from repro_torch.quantum import circuits  # noqa: E402

# sends the small circuits' steps to the kernels' plain versions
SMALL_HW = dataclasses.replace(
    H100_SXM, name="small", tile=4, block_candidates=(4, 8),
    einsum_flops_floor=64.0, chain_budget_bytes=1 << 16,
)
JOIN_S = 60


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Save/restore the process-global tracing flags and wipe recorded
    telemetry around every test."""
    prev, prev_ref = trace.enabled(), ref_obs.trace.enabled()
    obs.reset()
    ref_obs.reset()
    yield
    trace.set_enabled(prev)
    ref_obs.trace.set_enabled(prev_ref)
    obs.reset()
    ref_obs.reset()


def _setup(backend="gemm", seed=0):
    c = circuits.sycamore_like(3, 3, 8, seed=seed)
    tn, arrays = simplify_network(*circuits.circuit_to_network(c, bitstring="0" * 9))
    plan, report = plan_compiled(tn, 6, backend=backend, device="cpu",
                                 hw=SMALL_HW, use_cache=False)
    return plan, report, arrays


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


# ----------------------------------------------------------------------
# off-path contract
# ----------------------------------------------------------------------
def test_off_path_is_noop_stub():
    trace.set_enabled(False)
    s = trace.span("anything", key="value")
    assert s is trace._NOOP  # shared stub, no allocation per call
    with s:
        pass
    metrics.inc("should.not.exist")
    metrics.observe("should.not.exist.h", 1.0)
    assert trace.get_spans() == []
    snap = metrics.snapshot()
    assert "should.not.exist" not in snap["counters"]
    assert "should.not.exist.h" not in snap["histograms"]


def test_sync_adds_no_synchronization_when_off(monkeypatch):
    """``sync`` is the identity with tracing off: it never reaches
    ``torch.cuda.synchronize``; with tracing on it synchronizes only the
    CUDA devices its argument lives on (none for CPU tensors)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    x = [torch.ones(3), {"y": torch.zeros(2)}]
    trace.set_enabled(False)
    assert trace.sync(x) is x
    trace.set_enabled(True)
    assert trace.sync(x) is x
    assert calls == []


def test_off_path_results_bitwise_equal():
    plan, _, arrays = _setup()
    trace.set_enabled(False)
    off = plan.contract_all(arrays, hoist=False)
    trace.set_enabled(True)
    on = plan.contract_all(arrays, hoist=False)
    trace.set_enabled(False)
    again = plan.contract_all(arrays, hoist=False)
    assert torch.equal(off, on) and torch.equal(off, again)


def test_amplitude_bitwise_equal_with_telemetry():
    """An amplitude planned and contracted afresh with telemetry on is
    bitwise the one with telemetry off, through the kernels' plain
    versions, and only the traced report carries telemetry."""
    c = circuits.sycamore_like(3, 4, 8, seed=1)
    kw = dict(target_dim=8, device="cpu", hw=SMALL_HW, use_cache=False)
    off = simulate_amplitude(c, "0" * 12, telemetry=False, **kw)
    on = simulate_amplitude(c, "0" * 12, telemetry=True, **kw)
    assert np.asarray(off.value).tobytes() == np.asarray(on.value).tobytes()
    assert off.report.telemetry is None
    assert set(on.report.lowered_backends) & {"tiled", "fused"}
    spans = on.report.telemetry["spans"]
    assert {"plan.build", "plan.lower", "exec.contract_all"} <= set(spans)
    assert not trace.enabled()  # the per-call toggle is restored


def test_plan_fingerprint_unchanged_by_telemetry():
    """The telemetry toggle does not join the plan-cache key: a traced
    call hits the entry an untraced call planted."""
    c = circuits.sycamore_like(3, 3, 6, seed=3)
    tn, _ = circuits.circuit_to_network(c, bitstring="0" * 9)
    plan_a, rep_a = plan_compiled(tn, 6, device="cpu", telemetry=False)
    plan_b, rep_b = plan_compiled(tn, 6, device="cpu", telemetry=True)
    assert plan_b is plan_a
    assert rep_b.cache_hit
    assert rep_a.telemetry is None
    assert rep_b.telemetry is not None


def test_telemetry_report_through_api():
    c = circuits.sycamore_like(3, 3, 8, seed=0)
    r_off = simulate_amplitude(c, "0" * 9, target_dim=6, device="cpu",
                               telemetry=False)
    r_on = simulate_amplitude(c, "0" * 9, target_dim=6, device="cpu",
                              telemetry=True)
    assert r_off.report.telemetry is None
    t = r_on.report.telemetry
    assert np.asarray(r_off.value).tobytes() == np.asarray(r_on.value).tobytes()
    assert "exec.contract_all" in t["spans"]
    assert t["metrics"]["counters"]["exec.slices_executed"] >= 1


# ----------------------------------------------------------------------
# span integrity
# ----------------------------------------------------------------------
def _check_well_formed(spans):
    """Per thread: spans properly nested, siblings non-overlapping."""
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        assert s.t_end >= s.t_start
        if s.parent_id:
            p = by_id[s.parent_id]
            assert p.thread == s.thread
            assert p.t_start <= s.t_start and s.t_end <= p.t_end
    children = defaultdict(list)
    for s in spans:
        children[(s.thread, s.parent_id)].append(s)
    for sibs in children.values():
        sibs.sort(key=lambda s: s.t_start)
        for a, b in zip(sibs, sibs[1:]):
            assert a.t_end <= b.t_start


def test_span_tree_well_formed_nested():
    trace.set_enabled(True)
    with trace.span("outer"):
        with trace.span("mid"):
            with trace.span("inner"):
                pass
        with trace.span("mid2"):
            pass
    spans = trace.get_spans()
    assert [s.name for s in spans] == ["inner", "mid", "mid2", "outer"]
    _check_well_formed(spans)
    outer = spans[-1]
    assert outer.parent_id == 0
    assert {s.parent_id for s in spans if s.name.startswith("mid")} == {
        outer.span_id
    }


def test_span_stacks_are_thread_local():
    trace.set_enabled(True)
    barrier = threading.Barrier(4, timeout=JOIN_S)

    def work(tag):
        barrier.wait()
        with trace.span(f"t-{tag}"):
            with trace.span(f"t-{tag}-child"):
                pass
        barrier.wait()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    _join(threads)
    spans = trace.get_spans()
    assert len(spans) == 8
    _check_well_formed(spans)
    tops = [s for s in spans if s.parent_id == 0]
    assert len(tops) == 4
    assert len({s.thread for s in tops}) == 4


def test_contraction_spans_nest_and_count_slices():
    """A traced contraction's spans are well formed, the prologue nests
    inside ``exec.contract_all``, and every slice is counted once."""
    plan, _, arrays = _setup(seed=1)
    assert plan.can_hoist
    trace.set_enabled(True)
    plan.contract_all(arrays)
    spans = trace.get_spans()
    _check_well_formed(spans)
    by_name = {s.name: s for s in spans}
    assert by_name["exec.prologue"].parent_id == by_name["exec.contract_all"].span_id
    counters = metrics.snapshot()["counters"]
    assert counters["exec.slices_executed"] == 1 << plan.num_sliced
    assert counters["exec.flops_executed"] == pytest.approx(plan.executed_flops())


# ----------------------------------------------------------------------
# metrics registry
# ----------------------------------------------------------------------
def test_metrics_snapshot_reset_roundtrip():
    trace.set_enabled(True)
    metrics.inc("a.count")
    metrics.inc("a.count", 2)
    metrics.set_gauge("b.gauge", 7.5)
    metrics.observe("c.hist", 1.0)
    metrics.observe("c.hist", 3.0)
    snap = metrics.snapshot()
    assert snap["counters"]["a.count"] == 3
    assert snap["gauges"]["b.gauge"] == 7.5
    h = snap["histograms"]["c.hist"]
    assert h["count"] == 2 and h["min"] == 1.0 and h["max"] == 3.0
    assert h["mean"] == 2.0
    json.dumps(snap)
    metrics.reset()
    assert metrics.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_metrics_labeled_series_and_cardinality_cap():
    reg = metrics.Registry(max_labels=3)
    for fam in ("fam-a", "fam-b", "fam-c"):
        reg.counter("serve.family_requests", label=fam).inc()
    for fam in ("fam-d", "fam-e", "fam-f", "fam-g"):
        reg.counter("serve.family_requests", label=fam).inc()
    reg.counter("serve.family_requests", label="fam-a").inc()
    snap = reg.snapshot()["counters"]
    assert snap["serve.family_requests{fam-a}"] == 2
    assert snap["serve.family_requests{fam-b}"] == 1
    assert snap[f"serve.family_requests{{{metrics.OVERFLOW_LABEL}}}"] == 4
    assert "serve.family_requests{fam-d}" not in snap
    reg.counter("other.series", label="fam-z").inc()
    assert "other.series{fam-z}" in reg.snapshot()["counters"]
    assert reg.labeled("plain", None) == "plain"
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    reg.counter("serve.family_requests", label="fam-d").inc()
    assert "serve.family_requests{fam-d}" in reg.snapshot()["counters"]


def test_metrics_snapshot_consistent_under_concurrent_writers():
    """A snapshot is a point-in-time view: with writers mid-flight a
    histogram is never torn (``total == count * V`` exactly) and no
    increment is lost.  The switch interval is shortened to force
    interleavings."""
    reg = metrics.Registry()
    V = 0.5
    stop = threading.Event()
    PER_THREAD, N_WRITERS = 4000, 4

    def writer():
        h = reg.histogram("w.hist")
        c = reg.counter("w.count")
        for _ in range(PER_THREAD):
            h.observe(V)
            c.inc()

    torn = []

    def reader():
        while not stop.is_set():
            h = reg.snapshot()["histograms"].get("w.hist")
            if h is None or h["count"] == 0:
                continue
            if h["total"] != h["count"] * V:
                torn.append(h)
            if h["mean"] != V or h["min"] != V or h["max"] != V:
                torn.append(h)

    writers = [threading.Thread(target=writer) for _ in range(N_WRITERS)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in writers + readers:
            t.start()
        _join(writers)
    finally:
        stop.set()
        _join(readers)
        sys.setswitchinterval(interval)
    assert not torn
    snap = reg.snapshot()
    total = N_WRITERS * PER_THREAD
    assert snap["counters"]["w.count"] == total
    assert snap["histograms"]["w.hist"]["count"] == total


def test_cache_counters_match_plan_cache_stats():
    trace.set_enabled(True)
    cache = PlanCache(maxsize=4)
    cache.get("missing")
    cache.put("k", PlanEntry(None, None))
    cache.get("k")
    cache.get("k")
    stats = cache.stats()
    snap = metrics.snapshot()["counters"]
    assert stats["hits"] == 2 and stats["misses"] == 1
    assert snap["plan_cache.hits"] == stats["hits"]
    assert snap["plan_cache.misses"] == stats["misses"]


def test_hoist_cache_eviction_counters_match_stats():
    trace.set_enabled(True)
    cache = HoistCache(maxsize=8, max_bytes=100)
    a = np.zeros(10, np.float64)  # 80 bytes per entry
    cache.put("k1", ((a,), ()))
    cache.put("k2", ((a,), ()))  # over max_bytes -> evicts k1
    assert cache.get("k1") is None
    assert cache.get("k2") is not None
    stats = cache.stats()
    snap = metrics.snapshot()["counters"]
    assert stats["evictions"] == 1
    assert stats["evicted_bytes"] == 80
    assert snap["hoist_cache.evictions"] == stats["evictions"]
    assert snap["hoist_cache.evicted_bytes"] == stats["evicted_bytes"]
    assert snap["hoist_cache.hits"] == stats["hits"]
    assert snap["hoist_cache.misses"] == stats["misses"]


# ----------------------------------------------------------------------
# the pinned syc-12 plan: planner-algebra counters equal the reference's
# ----------------------------------------------------------------------
def test_syc12_counters_equal_reference():
    """On the pinned syc-12 plan (``random_greedy_tree(repeats=4,
    seed=0)``, lifetime slicing at 18, the reference's constants), one
    traced contraction counts exactly the reference's executed FLOPs,
    slices, chain calls, fused chains and chain bytes saved, and both
    amplitudes agree."""
    bits = "0" * 20
    tn_r, arr_r = ref_simplify(*ref_circuits.circuit_to_network(
        ref_circuits.sycamore_like(4, 5, 12, seed=0), bitstring=bits))
    tn_p, arr_p = simplify_network(*circuits.circuit_to_network(
        circuits.sycamore_like(4, 5, 12, seed=0), bitstring=bits))
    tree_r = ref_greedy(tn_r, repeats=4, seed=0)
    tree_p = random_greedy_tree(tn_p, repeats=4, seed=0)
    smask = ref_find_slices(tree_r, 18, method="lifetime")
    assert find_slices(tree_p, 18, method="lifetime") == smask
    ref_obs.trace.set_enabled(True)
    trace.set_enabled(True)
    want = complex(np.asarray(
        RefPlan(tree_r, smask, backend="gemm").contract_all(arr_r, slice_batch=8)))
    got = complex(ContractionPlan(tree_p, smask, device="cpu", hw=REF_HW)
                  .contract_all(arr_p))
    ref_c = ref_obs.metrics.snapshot()["counters"]
    port_c = metrics.snapshot()["counters"]
    for name in ("exec.flops_executed", "exec.slices_executed",
                 "exec.chain_calls", "plan.chains_fused",
                 "plan.chain_hbm_bytes_saved", "hoist_cache.misses"):
        assert port_c[name] == ref_c[name], name
    assert port_c["plan.chains_fused"] > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# export / merge
# ----------------------------------------------------------------------
def test_dump_trace_jsonl_chrome_and_merge(tmp_path):
    trace.set_enabled(True)
    with trace.span("alpha", cat="test", answer=42):
        pass
    p1 = tmp_path / "t1.jsonl"
    assert trace.dump_trace(str(p1)) == 1
    ev = json.loads(p1.read_text().strip())
    assert ev["name"] == "alpha" and ev["ph"] == "X"
    assert ev["args"]["answer"] == 42
    pc = tmp_path / "t.chrome.json"
    trace.dump_trace(str(pc), fmt="chrome")
    assert json.loads(pc.read_text())["traceEvents"][0]["name"] == "alpha"
    obs.reset()
    with trace.span("beta"):
        pass
    p2 = tmp_path / "t2.jsonl"
    trace.dump_trace(str(p2))
    merged = tmp_path / "merged.jsonl"
    assert trace.merge_traces([str(p1), str(p2)], str(merged)) == 2
    names = [json.loads(line)["name"] for line in merged.read_text().splitlines()]
    assert sorted(names) == ["alpha", "beta"]
    with pytest.raises(ValueError):
        trace.dump_trace(str(p1), fmt="nope")


# ----------------------------------------------------------------------
# structured logging
# ----------------------------------------------------------------------
def test_log_level_filter_and_verbatim_stdout(capsys):
    trace.set_enabled(False)
    try:
        obs_log.set_level("WARNING")
        obs_log.info("you should not see this")
        obs_log.warning("CACHED tag-1")
        assert capsys.readouterr().out == "CACHED tag-1\n"
        obs_log.set_level("DEBUG")
        obs_log.debug("now visible")
        assert capsys.readouterr().out == "now visible\n"
        with pytest.raises(ValueError):
            obs_log.set_level("LOUD")
    finally:
        obs_log.set_level(obs_log.DEFAULT_LEVEL)
    trace.set_enabled(True)
    obs_log.error("boom", code=3)
    recs = [s for s in trace.get_spans() if s.cat == "log"]
    assert len(recs) == 1
    assert recs[0].name == "boom"
    assert recs[0].attrs == {"level": "ERROR", "code": 3}


def test_reference_environment_is_not_read():
    """The reference's switches (``REPRO_TRACE``, ``REPRO_LOG_LEVEL``,
    ``REPRO_BACKEND``, ``REPRO_HOIST``) change nothing in the port: its
    tracing, log level, backend and hoist mode are arguments."""
    code = (
        "import repro_torch.obs as obs\n"
        "from repro_torch.core import default_backend, default_hoist\n"
        "from repro_torch.obs import log\n"
        "with obs.span('s'):\n"
        "    pass\n"
        "log.info('visible')\n"
        "print(obs.enabled(), len(obs.get_spans()), default_backend(), default_hoist())\n"
    )
    kw = subprocess_kwargs()
    env = dict(kw["env"], REPRO_TRACE="1", REPRO_LOG_LEVEL="ERROR",
               REPRO_BACKEND="einsum", REPRO_HOIST="0")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=kw["cwd"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split("\n")[:2] == ["visible", "False 0 gemm True"]


# ----------------------------------------------------------------------
# calibration
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["einsum", "gemm"])
def test_calibrate_plan_joins_model_and_measured(backend):
    plan, report, arrays = _setup(backend=backend, seed=2)
    cal = obs.calibrate_plan(plan, arrays, repeat=1)
    assert cal.backend == plan.backend
    assert cal.num_steps == len(plan.steps)
    assert cal.peak_bytes == report.peak_bytes
    assert cal.device == "cpu" and cal.hardware == "small"
    by_class = cal.ratio_by_class()
    assert by_class
    for cls, agg in by_class.items():
        assert agg["measured_s"] > 0.0
        assert agg["modeled_s"] > 0.0, cls
        assert np.isfinite(agg["ratio"]) and agg["ratio"] > 0.0
    if backend == "einsum":
        assert set(by_class) == {"einsum"}
    # one row per step or chain (a chain covers its n_steps)
    chains = plan._chain_dispatch.get("naive", {})
    assert len(cal.rows) == len(plan.steps) - sum(
        ch.n_steps - 1 for ch in chains.values())
    table = cal.table()
    assert "meas/model" in table and table.count("\n") >= 2
    json.dumps(cal.summary())


def test_calibrate_modeled_times_are_the_schedules():
    """Each row's modeled time is its step's spec time, a chain's the sum
    of its specs less its saved bytes at the plan's ``hw.mem_bw``."""
    plan, _, arrays = _setup(seed=2)
    cal = obs.calibrate_plan(plan, arrays, slice_id=1, repeat=1)
    chains = plan._chain_dispatch["naive"]
    pos = {st.out: k for k, st in enumerate(plan.steps)}
    by_out = {c.out_node: c for c in chains.values()}
    specs = plan.schedule.specs
    assert any(r.backend == "chain" for r in cal.rows)
    for r in cal.rows:
        if r.backend == "chain":
            ch = by_out[r.node]
            want = sum(specs[p].modeled_time_s for p in ch.positions) \
                - ch.hbm_bytes_saved / SMALL_HW.mem_bw
            assert r.modeled_s == pytest.approx(max(want, 0.0))
        else:
            spec = specs[pos[r.node]]
            assert (r.backend, r.modeled_s) == (spec.backend, spec.modeled_time_s)
