"""The port's mixed-precision planner and its bf16 routes against the JAX
reference, on the CPU.

With the reference's cost constants injected (``REF_HW``, which carries
the reference's bf16 rule: twice the matrix rate), the port's
``assign_precision`` makes the reference's step-by-step choices, its
storage widths are the reference's, and the pinned syc-12 plan (the
reference's precision gate: ``sycamore_like(4, 5, 12, seed=0)``, target
18, peak-mode slicing) keeps the reference's masks, |S| 5 at fp32 and 4
at ``fidelity_tol=0.05``.

Numerics.  Every bf16 route of the port rounds each real component of
its operands to bf16 at the load and accumulates the exact products in
fp32; a node every consumer of which reads bf16 is stored as bf16
(re, im) pairs, which is the same rounding done once.  For real operands
this is the reference's rounding, so the plain twins of K1-K3 match the
reference's bf16 ``ops`` at the kernels' tolerance.  A complex product is
the direct form, four real bf16 products (``Cr = ArBr - AiBi``, ``Ci =
ArBi + AiBr``), so the complex twins are held at the same tolerance to
that form built from the reference's real bf16 ``ops``.  The reference's
own complex bf16 products are Karatsuba's, which rounds ``Ar + Ai`` (not
``Ar`` and ``Ai``) for its third product: its ``auto`` amplitude carries
other rounding errors of the same size, so the port's is held to it at a
limit set between the two readings on the pinned syc-12 gate (the port's
``auto`` amplitude, and its unrounded fp32 one, against the reference's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.api import plan_compiled as ref_plan_compiled  # noqa: E402
from repro.core.api import plan_contraction as ref_plan_contraction  # noqa: E402
from repro.core.executor import simplify_network as ref_simplify  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.contract_gemm import tiled_matmul  # noqa: E402
from repro.lowering import precision as ref_precision  # noqa: E402
from repro.lowering import refiner as ref_refiner  # noqa: E402
from repro.lowering.partition import partition_tree as ref_partition  # noqa: E402
from repro.quantum import circuits as ref_circuits  # noqa: E402

from repro_torch.core import plan_compiled, plan_contraction  # noqa: E402
from repro_torch.core.executor import ContractionPlan, simplify_network  # noqa: E402
from repro_torch.kernels import contract_gemm as cg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import round16, to_pairs16, widen  # noqa: E402
from repro_torch.lowering import precision, refiner  # noqa: E402
from repro_torch.lowering.gemm_form import GemmForm, lower_step  # noqa: E402
from repro_torch.lowering.partition import partition_tree  # noqa: E402
from repro_torch.quantum import circuits, statevector  # noqa: E402
from test_torch_planner import REF_HW  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4  # the kernels' tolerance (tests/test_kernels.py)
AMP_RTOL, AMP_ATOL = 1e-4, 1e-5  # amplitudes (tests/test_megakernel.py)
# |port auto - reference auto| / |reference auto| on the syc-12 gate: the
# readings are 6.17e-3 for the port's auto amplitude and 9.29e-3 for its
# fp32 amplitude (no bf16 rounding at all), so an unrounded port fails
AMP_REF_LIMIT = 7.5e-3
SYC_TD = 18  # the reference's pinned syc-12 gate
GATE_TOL = 0.05
TOLS = (0.0, 1e-3, 5e-3, 0.02, 0.05, 0.5)
BACKEND_NAMES = {"pallas": "tiled", "pallas_fused": "fused"}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def syc():
    """The syc-12 network, planned by both packages in peak mode."""
    n = 20
    ref_tn, ref_arrays = ref_simplify(*ref_circuits.circuit_to_network(
        ref_circuits.sycamore_like(4, 5, 12, seed=0), bitstring="0" * n))
    tn, arrays = simplify_network(*circuits.circuit_to_network(
        circuits.sycamore_like(4, 5, 12, seed=0), bitstring="0" * n))
    tree_r, s_r, _ = ref_plan_contraction(ref_tn, SYC_TD, slicing_mode="peak")
    tree_p, s_p, _ = plan_contraction(tn, SYC_TD, slicing_mode="peak", hw=REF_HW)
    assert tree_p.children == tree_r.children and s_p == s_r
    return dict(ref_tn=ref_tn, ref_arrays=ref_arrays, tn=tn, arrays=arrays,
                tree_r=tree_r, tree_p=tree_p, smask=s_r)


def _schedules(syc, mode, tol):
    """(reference, port) schedules of the fp32 syc-12 plan after each
    package's assign_precision, epilogue steps weighted by 2^|S|."""
    tree_r, tree_p, smask = syc["tree_r"], syc["tree_p"], syc["smask"]
    ref_s = ref_refiner.refine_tree_schedule(tree_r, smask, fused=True)
    port_s = refiner.refine_tree_schedule(tree_p, smask, hw=REF_HW)
    inv_r = set(ref_partition(tree_r, smask).invariant_nodes)
    inv_p = set(partition_tree(tree_p, smask).invariant_nodes)
    epi_r = tuple(i for i, v in enumerate(tree_r.contract_order()) if v not in inv_r)
    epi_p = tuple(i for i, v in enumerate(tree_p.contract_order()) if v not in inv_p)
    assert epi_r == epi_p
    n_slices = 1 << bin(smask).count("1")
    ref_a = ref_precision.assign_precision(
        ref_s, mode=mode, fidelity_tol=tol, epilogue_positions=epi_r,
        n_slices=n_slices, fused=True)
    port_a = precision.assign_precision(
        port_s, mode=mode, fidelity_tol=tol, epilogue_positions=epi_p,
        n_slices=n_slices, hw=REF_HW)
    return ref_a, port_a


def _bf16_set(sched) -> set[int]:
    return {i for i, s in enumerate(sched.specs) if s.precision == "bf16"}


@pytest.mark.parametrize("mode,tol", [("auto", t) for t in TOLS] + [("bf16", None)])
def test_assign_precision_matches_reference(syc, mode, tol):
    """Step for step the same precision, backend and blocks as the
    reference, the same modeled times and certified error."""
    ref_a, port_a = _schedules(syc, mode, tol)
    assert len(ref_a.specs) == len(port_a.specs)
    for a, b in zip(ref_a.specs, port_a.specs):
        assert b.precision == a.precision
        assert b.backend == BACKEND_NAMES.get(a.backend, a.backend)
        assert (b.bm, b.bn, b.bk) == (a.bm, a.bn, a.bk)
        assert b.modeled_time_s == pytest.approx(a.modeled_time_s)
        assert b.transpose_bytes == a.transpose_bytes
    assert port_a.predicted_amp_error == pytest.approx(ref_a.predicted_amp_error)
    assert port_a.precision_counts() == ref_a.precision_counts()
    assert port_a.precision_mode == ref_a.precision_mode


def test_assignment_nested_and_monotone(syc):
    """The bf16 sets grow with the tolerance, each certified within its
    budget; tol 0 is the fp32 schedule; bf16 mode takes every eligible
    step."""
    prev: set[int] = set()
    for tol in TOLS:
        _, port_a = _schedules(syc, "auto", tol)
        cur = _bf16_set(port_a)
        assert prev <= cur, tol
        assert precision.predicted_fidelity_loss(port_a.predicted_amp_error) <= tol
        prev = cur
    _, forced = _schedules(syc, "bf16", None)
    assert _bf16_set(forced) >= prev
    _, zero = _schedules(syc, "auto", 0.0)
    fp32 = refiner.refine_tree_schedule(syc["tree_p"], syc["smask"], hw=REF_HW)
    assert zero.specs == fp32.specs


@pytest.mark.parametrize("mode,tol", [("auto", 0.05), ("auto", 0.5), ("bf16", None)])
def test_storage_itemsizes_match_reference(syc, mode, tol):
    ref_a, port_a = _schedules(syc, mode, tol)
    tree_r, tree_p = syc["tree_r"], syc["tree_p"]
    steps = tuple((*tree_p.children[v], v) for v in tree_p.contract_order())
    want = ref_precision.storage_itemsizes(steps, ref_a.specs, "complex64", tree_r.emask)
    got = precision.storage_itemsizes(steps, port_a.specs, torch.complex64, tree_p.emask)
    assert got == want and 4 in got.values()
    want_t = ref_precision.tree_storage_itemsizes(
        tree_r, syc["smask"], mode=mode, fidelity_tol=tol, fused=True)
    got_t = precision.tree_storage_itemsizes(
        tree_p, syc["smask"], mode=mode, fidelity_tol=tol, hw=REF_HW)
    assert got_t == want_t
    assert precision.tree_storage_itemsizes(tree_p, syc["smask"], mode="fp32") is None


def test_syc12_masks_and_slice_count(syc):
    """The pinned gate's planning: the reference's masks at fp32 and at
    tol 0.05, and |S| 5 -> 4 (bf16-stored nodes halve the certified
    peak, so peak-mode slicing prunes one index)."""
    masks = {}
    for mode, tol in (("fp32", None), ("auto", GATE_TOL)):
        _, s_r, rep_r = ref_plan_contraction(
            syc["ref_tn"], SYC_TD, slicing_mode="peak", precision=mode,
            fidelity_tol=tol)
        _, s_p, rep_p = plan_contraction(
            syc["tn"], SYC_TD, slicing_mode="peak", precision=mode,
            fidelity_tol=tol, hw=REF_HW)
        assert s_p == s_r, mode
        masks[mode] = (s_p, rep_p.num_sliced)
    assert masks["fp32"][1] == 5 and masks["auto"][1] == 4
    assert masks["auto"][0] & ~masks["fp32"][0] == 0  # prune-only


def _port_plan(syc, mode, tol):
    plan, report = plan_compiled(
        syc["tn"], SYC_TD, device="cpu", hw=REF_HW, slicing_mode="peak",
        precision=mode, fidelity_tol=tol)
    return plan, report


def test_report_matches_reference_plan(syc):
    """PlanReport's precision fields and dtype-true peaks are the
    reference's for the gate's auto plan."""
    _, rep_r = ref_plan_compiled(
        syc["ref_tn"], SYC_TD, backend="gemm", use_cache=False,
        slicing_mode="peak", precision="auto", fidelity_tol=GATE_TOL)
    _, rep_p = _port_plan(syc, "auto", GATE_TOL)
    assert rep_p.precision == rep_r.precision == "auto"
    assert rep_p.fidelity_tol == rep_r.fidelity_tol
    assert rep_p.precision_counts == rep_r.precision_counts
    assert rep_p.predicted_amp_error == pytest.approx(rep_r.predicted_amp_error)
    for f in ("num_sliced", "peak_bytes", "peak_bytes_hoisted", "buffer_slots"):
        assert getattr(rep_p, f) == getattr(rep_r, f), f


def test_tol_zero_is_the_fp32_plan(syc):
    """``fidelity_tol=0`` plans the fp32 schedule, unchanged, and its
    amplitude on the CPU is bitwise the fp32 plan's."""
    p32, _ = _port_plan(syc, "fp32", None)
    p0, r0 = _port_plan(syc, "auto", 0.0)
    assert p0.smask == p32.smask
    assert p0.schedule.specs == p32.schedule.specs
    assert not (r0.precision_counts or {}).get("bf16")
    assert not p0.store16
    assert torch.equal(p0.contract_all(syc["arrays"]), p32.contract_all(syc["arrays"]))


def _oracle_amplitude(plan, arrays) -> complex:
    """The port's bf16 rule in float64, step by step over the plan's own
    schedule: every operand of a bf16 step has each real component
    rounded to bf16, then the exact product (einsum in complex128)."""
    total = 0
    for sid in range(1 << plan.num_sliced):
        svals = plan.slice_values(sid)
        env = {}
        for i, a in enumerate(arrays):
            t = torch.from_numpy(np.asarray(a))
            for axis, spos in plan.leaf_specs[i]:
                t = t.select(axis, svals[spos])
            env[i] = t.to(torch.complex128)
        for spec, st in zip(plan.schedule.specs, plan.steps):
            a, b = env[st.lhs], env[st.rhs]
            if spec.precision == "bf16":
                a = round16(a.to(torch.complex64)).to(torch.complex128)
                b = round16(b.to(torch.complex64)).to(torch.complex128)
            env[st.out] = torch.einsum(st.expr, a, b)
        total = total + env[plan.root]
    return complex(total)


def _exact_casts(fn, *args):
    """``fn`` compiled by XLA with every bf16 cast rounded as written
    (as in tests/test_torch_lm.py)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.fixture(scope="module")
def auto_amplitudes(syc):
    plan, report = _port_plan(syc, "auto", GATE_TOL)
    got = complex(plan.contract_all(syc["arrays"]))
    ref_plan, ref_report = ref_plan_compiled(
        syc["ref_tn"], SYC_TD, backend="gemm", use_cache=False,
        slicing_mode="peak", precision="auto", fidelity_tol=GATE_TOL)
    arrays = [jnp.asarray(a) for a in syc["ref_arrays"]]
    want = complex(_exact_casts(
        lambda *xs: ref_plan.contract_all(list(xs), slice_batch=8, hoist=False),
        *arrays))
    exact = complex(statevector.amplitude(
        circuits.sycamore_like(4, 5, 12, seed=0), "0" * 20, device="cpu"))
    return dict(plan=plan, report=report, got=got, ref=want,
                ref_report=ref_report, exact=exact)


def test_auto_amplitude_matches_its_rule(syc, auto_amplitudes):
    """The auto plan's amplitude is the port's bf16 rule computed in
    float64 on the same schedule, at the amplitude tolerance."""
    r = auto_amplitudes
    assert (r["report"].precision_counts or {}).get("bf16", 0) > 0
    want = _oracle_amplitude(r["plan"], syc["arrays"])
    np.testing.assert_allclose(r["got"], want, rtol=AMP_RTOL, atol=AMP_ATOL)


def test_auto_amplitude_matches_reference(syc, auto_amplitudes):
    """Against the reference's auto amplitude (its rounding compiled as
    written) within ``AMP_REF_LIMIT``, which the port's fp32 amplitude
    exceeds, and both within the 0.05 budget of the statevector."""
    r = auto_amplitudes
    exact, ref = r["exact"], r["ref"]
    assert abs(r["got"] - exact) / abs(exact) <= GATE_TOL
    assert abs(ref - exact) / abs(exact) <= GATE_TOL
    assert abs(r["got"] - ref) <= AMP_REF_LIMIT * abs(ref)
    p32, _ = _port_plan(syc, "fp32", None)
    unrounded = complex(p32.contract_all(syc["arrays"]))
    assert abs(unrounded - ref) > AMP_REF_LIMIT * abs(ref)


def test_bf16_stored_node_round_trips(syc):
    """Nodes every consumer of which reads bf16 are held as bf16 (re, im)
    pairs in the executor's environment, and the amplitude is bitwise the
    one with every node held at full width: rounding at the store is the
    rounding each consumer applies."""
    from repro_torch.lowering import gemm_form

    plan, _ = _port_plan(syc, "auto", GATE_TOL)
    assert plan.store16
    seen = []
    apply, apply_chain = gemm_form.apply, gemm_form.apply_chain

    def spy(fn):
        def call(*args, out16=False):
            out = fn(*args, out16=out16)
            seen.append((out16, out.dtype))
            return out
        return call

    gemm_form.apply, gemm_form.apply_chain = spy(apply), spy(apply_chain)
    try:
        half = plan.contract_all(syc["arrays"])
    finally:
        gemm_form.apply, gemm_form.apply_chain = apply, apply_chain
    assert any(o for o, _ in seen)
    assert all((dt == torch.bfloat16) == o for o, dt in seen)
    full_plan, _ = _port_plan(syc, "auto", GATE_TOL)
    full_plan.store16 = frozenset()
    assert torch.equal(half, full_plan.contract_all(syc["arrays"]))


def test_storage_format_round_trip():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((3, 4)) + 1j * rng.standard_normal(
        (3, 4))).astype(np.complex64))
    p = to_pairs16(x)
    assert p.dtype == torch.bfloat16 and tuple(p.shape) == (3, 4, 2)
    assert torch.equal(widen(p, (3, 4)), round16(x))
    assert torch.equal(round16(widen(p, (3, 4))), widen(p, (3, 4)))
    r = torch.from_numpy(rng.standard_normal((5,)).astype(np.float32))
    assert torch.equal(widen(to_pairs16(r), (5,)), round16(r))


# ----------------------------------------------------------------------
# the plain twins of the bf16 routes
# ----------------------------------------------------------------------
def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _direct(product, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The complex product ``a . b`` in the direct form from the real
    ``product``: ``Cr = ArBr - AiBi``, ``Ci = ArBi + AiBr``."""
    ar, ai = (np.ascontiguousarray(x, np.float32) for x in (a.real, a.imag))
    br, bi = (np.ascontiguousarray(x, np.float32) for x in (b.real, b.imag))

    def p(x, y):
        return np.asarray(product(x, y), np.float32)

    return (p(ar, br) - p(ai, bi)) + 1j * (p(ar, bi) + p(ai, br))


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 384), (130, 70, 129)])
def test_tiled_bf16_plain_matches_reference(m, k, n):
    """K1's bf16 twin: the reference's tiled_matmul on bf16 inputs
    (interpret mode, as its own tests run it) for real operands; for
    complex ones the direct form of the reference's real bf16 products."""
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(ref_ops.matmul(a, b, bm=128, bn=128, bk=128, interpret=True,
                                     min_kernel_dim=64, precision="bf16"))
    got = cg.tiled_gemm(_t(a)[None], _t(b)[None], precision="bf16")[0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if m % 128 == 0 and k % 128 == 0 and n % 128 == 0:
        kern = np.asarray(tiled_matmul(jnp.asarray(a, jnp.bfloat16),
                                       jnp.asarray(b, jnp.bfloat16),
                                       bm=128, bn=128, bk=128, interpret=True))
        np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    ac, bc = _cplx(rng, (m, k)), _cplx(rng, (k, n))
    got = ops.matmul(_t(ac)[None], _t(bc)[None], precision="bf16",
                     min_kernel_dim=64)[0].numpy()
    want = _direct(lambda x, y: ref_ops.matmul(
        x, y, bm=128, bn=128, bk=128, interpret=True, min_kernel_dim=64,
        precision="bf16"), ac, bc)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _form(rng, nb, nm, nn, nk, size=4):
    labels = [f"i{j}" for j in range(nb + nm + nn + nk)]
    rng.shuffle(labels)
    bt, m = labels[:nb], labels[nb:nb + nm]
    n, k = labels[nb + nm:nb + nm + nn], labels[nb + nm + nn:]
    ia = list(rng.permutation(bt + m + k))
    ib = list(rng.permutation(bt + k + n))
    out = [x for x in ia if x not in k] + [x for x in ib if x not in k and x not in ia]
    return lower_step(ia, ib, out, lambda _: size)


@pytest.mark.parametrize("seed,nb,nm,nn,nk", [(0, 0, 3, 2, 2), (1, 1, 2, 2, 3),
                                              (2, 0, 4, 1, 2)])
def test_fused_bf16_plain_matches_reference(seed, nb, nm, nn, nk):
    """K2's bf16 twin against the reference's ops.fused_matmul at bf16
    (its Pallas kernel in interpret mode) on real operands, and on
    complex ones against the direct form of those real products;
    bf16-pair operands in, half-width output out, the same values."""
    rng = np.random.default_rng(seed)
    f = _form(rng, nb, nm, nn, nk)
    a = rng.standard_normal(f.a_shape).astype(np.float32)
    b = rng.standard_normal(f.b_shape).astype(np.float32)
    want = _ref_fused(f, "bf16")(a, b)
    got = ops.fused_matmul(_t(a), _t(b), f, precision="bf16").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ac, bc = _cplx(rng, f.a_shape), _cplx(rng, f.b_shape)
    want = _direct(_ref_fused(f, "bf16"), ac, bc)
    got = ops.fused_matmul(_t(ac), _t(bc), f, precision="bf16")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    half = ops.fused_matmul(to_pairs16(_t(ac)), to_pairs16(_t(bc)), f,
                            precision="bf16", out16=True)
    assert torch.equal(half, to_pairs16(got))


def _ref_fused(f, prec):
    """The reference's real ops.fused_matmul on step ``f`` at ``prec``
    (its Pallas kernel in interpret mode), output in ``inds_out`` order."""
    nb, nm = len(f.batch_shape), len(f.m_shape)
    nn, nk = len(f.n_shape), len(f.k_shape)

    def product(a, b):
        natural = np.asarray(ref_ops.fused_matmul(
            a, b, perm_a=f.perm_a, perm_b=f.perm_b, nb=nb, nm=nm, nn=nn, nk=nk,
            interpret=True, precision=prec))
        return np.transpose(natural, f.out_perm)

    return product


def _ref_chain(which):
    """A chain of the reference's small plan (as in tests/test_torch_kernels.py)."""
    from repro.core.executor import ContractionPlan as RefPlan

    tn, _ = ref_simplify(*ref_circuits.circuit_to_network(
        ref_circuits.sycamore_like(4, 4, 8, seed=0), bitstring="0" * 16))
    tree, smask, _ = ref_plan_contraction(tn, 10)
    plan = RefPlan(tree, smask, backend="gemm")
    chains = sorted(plan.chain_plan.chains, key=lambda c: -c.n_steps)
    ch = chains[which]
    forms = tuple(GemmForm(**dataclasses.asdict(plan.schedule.specs[p].form))
                  for p in ch.positions)
    return ch, forms


@pytest.mark.parametrize("which", [0, 1])
def test_chain_bf16_plain_matches_reference(which):
    """K3's twin with per-step precisions (every other step bf16) against
    the reference's fused_chain(precisions=) on real externals (its
    megakernel body in interpret mode), and on complex ones against the
    chain stepped through the direct form of the reference's real
    fused_matmul at each step's precision (carries in fp32, rounded by
    their consumer, as in the chain)."""
    ch, forms = _ref_chain(which)
    n = len(forms)
    prec = tuple("bf16" if t % 2 == 0 else "fp32" for t in range(n))
    rng = np.random.default_rng(which)
    shapes = [forms[0].a_shape, forms[0].b_shape] + [
        forms[t].b_shape if ch.carry_side[t] == "l" else forms[t].a_shape
        for t in range(1, n)
    ]
    real = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = np.asarray(ref_ops.fused_chain(
        [jnp.asarray(x) for x in real], forms=forms, carry_side=ch.carry_side,
        slot_ids=ch.slot_ids, slot_elems=ch.slot_elems, interpret=True,
        use_kernel=True, precisions=prec))
    got = ops.fused_chain([_t(x) for x in real], forms=forms,
                          carry_side=ch.carry_side, slot_ids=ch.slot_ids,
                          slot_elems=ch.slot_elems, precisions=prec).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    cplx = [_cplx(rng, s) for s in shapes]
    carry = None
    for t, f in enumerate(forms):
        if t == 0:
            x, y = cplx[0], cplx[1]
        else:
            x, y = ((carry, cplx[t + 1]) if ch.carry_side[t] == "l"
                    else (cplx[t + 1], carry))
        carry = _direct(_ref_fused(f, prec[t]), x, y)
    got = ops.fused_chain([_t(x) for x in cplx], forms=forms,
                          carry_side=ch.carry_side, slot_ids=ch.slot_ids,
                          slot_elems=ch.slot_elems, precisions=prec).numpy()
    np.testing.assert_allclose(got, carry, rtol=RTOL, atol=ATOL)


def test_modeled_step_time_bf16_rule():
    """bf16 on a kernel backend: the bf16 rate and half the operand
    bytes; the library backends keep their fp32 price."""
    f = lower_step(("a", "k"), ("k", "b"), ("a", "b"),
                   {"a": 4096, "b": 1024, "k": 512}.__getitem__)
    for backend in ("fused", "tiled"):
        t32, _ = refiner.modeled_step_time(f, torch.complex64, backend, 256, 256, 256, REF_HW)
        t16, _ = refiner.modeled_step_time(f, torch.complex64, backend, 256, 256, 256,
                                           REF_HW, precision="bf16")
        r32, _ = ref_refiner.modeled_step_time(f, "complex64", "pallas_fused"
                                               if backend == "fused" else "pallas",
                                               256, 256, 256)
        r16, _ = ref_refiner.modeled_step_time(f, "complex64", "pallas_fused"
                                               if backend == "fused" else "pallas",
                                               256, 256, 256, "bf16")
        assert (t32, t16) == pytest.approx((r32, r16))
        assert t16 < t32
    assert refiner.step_traffic_bytes(f, torch.complex64, "bf16") == \
        ref_refiner.step_traffic_bytes(f, "complex64", "bf16")
    assert refiner.operand_transpose_bytes(f, torch.complex64, "bf16") == \
        ref_refiner.operand_transpose_bytes(f, "complex64", "bf16")


def test_unknown_precision_is_refused():
    tn, _ = simplify_network(*circuits.circuit_to_network(
        circuits.sycamore_like(3, 3, 4), bitstring="0" * 9))
    with pytest.raises(ValueError, match="precision"):
        plan_compiled(tn, 6, device="cpu", precision="fp16")
    with pytest.raises(ValueError, match="precision"):
        cg.tiled_gemm(torch.zeros(1, 2, 2), torch.zeros(1, 2, 2), precision="tf32")


@pytest.mark.parametrize("mode,tol", [("auto", GATE_TOL), ("bf16", None)])
def test_chain_plan_matches_reference(syc, mode, tol):
    """The chains of a mixed-precision plan, their dtype-true slots and
    each slot's width (bf16 exactly when every interior it holds is
    consumed at bf16) are the reference's."""
    ref_plan, _ = ref_plan_compiled(
        syc["ref_tn"], SYC_TD, backend="gemm", use_cache=False,
        slicing_mode="peak", precision=mode, fidelity_tol=tol)
    plan, _ = _port_plan(syc, mode, tol)
    keep = ("segment", "positions", "nodes", "carry_side", "external_nodes",
            "out_node", "live_bytes", "slot_ids", "slot_elems", "slot_prec")
    assert [tuple(getattr(c, k) for k in keep) for c in plan.chain_plan.chains] == [
        tuple(getattr(c, k) for k in keep) for c in ref_plan.chain_plan.chains]
    specs = plan.schedule.specs
    for ch in plan.chain_plan.chains:
        want = ["bf16"] * len(ch.slot_elems)
        for t in range(ch.n_steps - 1):
            if specs[ch.positions[t + 1]].precision != "bf16":
                want[ch.slot_ids[t]] = "fp32"
        assert list(ch.slot_prec) == want


def test_plan_from_reference_carries_precisions(syc):
    """interop.plan_from_reference with the reference plan's per-step
    precisions gives the reference's schedule."""
    from repro_torch import interop

    ref_plan, _ = ref_plan_compiled(
        syc["ref_tn"], SYC_TD, backend="gemm", use_cache=False,
        slicing_mode="peak", precision="auto", fidelity_tol=GATE_TOL)
    tree = interop.tree_from_reference(syc["tn"], ref_plan.tree.children,
                                       ref_plan.tree.root)
    port = interop.plan_from_reference(
        tree, ref_plan.smask, device="cpu", hw=REF_HW,
        precisions=[s.precision for s in ref_plan.schedule.specs])
    assert [s.precision for s in port.schedule.specs] == [
        s.precision for s in ref_plan.schedule.specs]
    for a, b in zip(ref_plan.schedule.specs, port.schedule.specs):
        assert (b.bm, b.bn, b.bk) == (a.bm, a.bn, a.bk)
        assert b.backend == BACKEND_NAMES.get(a.backend, a.backend)
    assert port.memory_plan().peak_bytes_hoisted == ref_plan.memory_plan().peak_bytes_hoisted
    assert isinstance(port, ContractionPlan)
