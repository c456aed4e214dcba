"""The port's three contraction kernels, held against the JAX Pallas
kernels they replace.

The CUDA kernels run only on the card; here each kernel's plain PyTorch
version is held against the Pallas kernel (interpret mode) at small
shapes, the kernels' own addressing (the per-role offset tables) is
emulated in numpy, and a CUDA-device call is shown to raise rather than
fall back when no kernel library can be built.  Tolerances: rtol 1e-5,
atol 1e-4, as in ``tests/test_kernels.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.api import plan_contraction as ref_plan_contraction  # noqa: E402
from repro.core.executor import ContractionPlan as RefPlan  # noqa: E402
from repro.core.executor import simplify_network as ref_simplify  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.contract_gemm import (  # noqa: E402
    chain_reference,
    fused_chain_matmul,
    fused_transpose_matmul,
    tiled_matmul,
)
from repro.quantum import circuits as ref_circuits  # noqa: E402

from repro_torch.kernels import build, contract_gemm as cg, ops  # noqa: E402
from repro_torch.lowering.gemm_form import GemmForm, lower_step  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _random_form(rng, nb, nm, nn, nk, size=2):
    labels = [f"i{j}" for j in range(nb + nm + nn + nk)]
    rng.shuffle(labels)
    bt = labels[:nb]
    m = labels[nb:nb + nm]
    n = labels[nb + nm:nb + nm + nn]
    k = labels[nb + nm + nn:]
    ia = list(rng.permutation(bt + m + k))
    ib = list(rng.permutation(bt + k + n))
    # the executor's output convention: kept a indices, then new b ones
    out = [x for x in ia if x not in k] + [
        x for x in ib if x not in k and x not in ia
    ]
    return lower_step(ia, ib, out, lambda _: size)


FORM_CASES = [
    # seed, nb, nm, nn, nk
    (0, 0, 3, 2, 2),
    (1, 1, 2, 2, 3),
    (2, 0, 5, 1, 1),
    (3, 2, 1, 3, 2),
    (4, 0, 1, 1, 6),
]


# ----------------------------------------------------------------------
# K1
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 384), (128, 256, 256)])
def test_tiled_plain_matches_pallas(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(tiled_matmul(a, b, bm=128, bn=128, bk=128, interpret=True))
    got = cg.tiled_gemm(_t(a)[None], _t(b)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,k,n", [(8, 4, 8), (130, 70, 129), (64, 64, 64)])
def test_complex_matmul_matches_reference_ops(m, k, n):
    """Karatsuba wrapper, with the dot fallback below min_kernel_dim."""
    rng = np.random.default_rng(7)
    a = (rng.standard_normal((m, k)) + 1j * rng.standard_normal((m, k))).astype(np.complex64)
    b = (rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n))).astype(np.complex64)
    want = np.asarray(ref_ops.matmul(a, b, bm=128, bn=128, bk=128, interpret=True,
                                     min_kernel_dim=64))
    got = ops.matmul(_t(a), _t(b), min_kernel_dim=64).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# K2
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed,nb,nm,nn,nk", FORM_CASES)
def test_fused_plain_matches_pallas(seed, nb, nm, nn, nk):
    rng = np.random.default_rng(seed)
    f = _random_form(rng, nb, nm, nn, nk)
    a = rng.standard_normal(f.a_shape).astype(np.float32)
    b = rng.standard_normal(f.b_shape).astype(np.float32)
    natural = np.asarray(fused_transpose_matmul(
        a, b, perm_a=f.perm_a, perm_b=f.perm_b, nb=nb, nm=nm, nn=nn, nk=nk,
        bm=4, bn=4, bk=4, interpret=True,
    ))
    want = np.transpose(natural, f.out_perm)
    (got,) = cg.fused_gemm((_t(a),), (_t(b),), f)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,nb,nm,nn,nk", FORM_CASES[:3])
def test_complex_fused_matches_reference_ops(seed, nb, nm, nn, nk):
    rng = np.random.default_rng(seed + 10)
    f = _random_form(rng, nb, nm, nn, nk)

    def cplx(shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    a, b = cplx(f.a_shape), cplx(f.b_shape)
    natural = np.asarray(ref_ops.fused_matmul(
        a, b, perm_a=f.perm_a, perm_b=f.perm_b, nb=nb, nm=nm, nn=nn, nk=nk,
        bm=8, bn=8, bk=8, interpret=True,
    ))
    got = ops.fused_matmul(_t(a), _t(b), f).numpy()
    np.testing.assert_allclose(got, np.transpose(natural, f.out_perm), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.einsum(f.expr, a, b), rtol=1e-4, atol=1e-4)


def _full_role(desc, r):
    """Every offset of role word ``r`` of a step descriptor, as the
    kernel computes them: tab[hi + i // lo_n] + tab[lo + i % lo_n]."""
    hi, lo, lo_n = (int(x) for x in desc[r:r + 3])
    return lambda size: np.array(
        [desc[hi + i // lo_n] + desc[lo + i % lo_n] for i in range(size)],
        dtype=np.int64,
    )


@pytest.mark.parametrize("seed,nb,nm,nn,nk", FORM_CASES)
def test_descriptor_addressing_matches_plain(seed, nb, nm, nn, nk):
    """The fused and chain kernels address every operand element as a
    sum of per-role table lookups.  Emulating exactly that gather and
    scatter in numpy reproduces the plain version."""
    rng = np.random.default_rng(seed)
    f = _random_form(rng, nb, nm, nn, nk)
    d = cg.step_descriptor(f)
    B, M, N, K = (int(x) for x in d[:4])
    assert (B, M, N, K) == (f.B, f.M, f.N, f.K)
    ab, am, ak = (_full_role(d, r) for r in (4, 7, 10))
    bb, bk, bn = (_full_role(d, r) for r in (13, 16, 19))
    ob, om, on = (_full_role(d, r) for r in (22, 25, 28))
    a = rng.standard_normal(f.a_shape).astype(np.float32)
    b = rng.standard_normal(f.b_shape).astype(np.float32)
    ga = a.reshape(-1)[ab(B)[:, None, None] + am(M)[None, :, None] + ak(K)[None, None, :]]
    gb = b.reshape(-1)[bb(B)[:, None, None] + bk(K)[None, :, None] + bn(N)[None, None, :]]
    c = np.einsum("bmk,bkn->bmn", ga.astype(np.float64), gb.astype(np.float64))
    where = ob(B)[:, None, None] + om(M)[None, :, None] + on(N)[None, None, :]
    assert sorted(where.reshape(-1).tolist()) == list(range(B * M * N))
    out = np.empty(B * M * N)
    out[where.reshape(-1)] = c.reshape(-1)
    (want,) = cg.fused_gemm_plain((_t(a),), (_t(b),), f)
    np.testing.assert_allclose(out.reshape(f.out_shape), want.numpy(), rtol=RTOL, atol=ATOL)


def test_role_tables_split_large_roles():
    """A role with more entries than the lo table holds splits into
    (hi, lo) lookups that still enumerate every offset once."""
    dims = [2] * 14
    strides = list(np.random.default_rng(0).permutation([1 << i for i in range(14)]))
    hi, lo, lo_n = cg.role_tables(dims, strides)
    assert lo_n == 4096 and hi.size == 4 and lo.size == 4096
    full = (hi[:, None] + lo[None, :]).reshape(-1)
    np.testing.assert_array_equal(full, cg._offsets(dims, strides))


# ----------------------------------------------------------------------
# K3, on chains taken from a real small plan
# ----------------------------------------------------------------------
def _reference_chains():
    circ = ref_circuits.sycamore_like(4, 4, 10, seed=0)
    tn, _ = ref_simplify(*ref_circuits.circuit_to_network(circ, bitstring="0" * 16))
    tree, S, _ = ref_plan_contraction(tn, 10)
    plan = RefPlan(tree, S, backend="gemm")
    chains = sorted(plan.chain_plan.chains, key=lambda c: -c.n_steps)
    return plan, [chains[0], chains[-1]]


_REF_PLAN, _REF_CHAINS = _reference_chains()


def _external_shapes(forms, carry_side):
    shapes = [forms[0].a_shape, forms[0].b_shape]
    for t in range(1, len(forms)):
        shapes.append(forms[t].b_shape if carry_side[t] == "l" else forms[t].a_shape)
    return shapes


def _external_scales(forms):
    """Per-external scale that keeps every chain carry O(1): each step
    sums K products, so its external operand is scaled by 1/sqrt(K)."""
    k0 = forms[0].K ** -0.25
    return [k0, k0] + [f.K ** -0.5 for f in forms[1:]]


@pytest.mark.parametrize("which", range(len(_REF_CHAINS)))
def test_chain_plain_matches_pallas_and_reference(which):
    ch = _REF_CHAINS[which]
    ref_forms = tuple(_REF_PLAN.schedule.specs[p].form for p in ch.positions)
    forms = tuple(GemmForm(**dataclasses.asdict(f)) for f in ref_forms)
    rng = np.random.default_rng(which)
    comps = []
    for shape, sc in zip(_external_shapes(forms, ch.carry_side), _external_scales(forms)):
        comps += [(sc * rng.standard_normal(shape)).astype(np.float32) for _ in range(2)]
    kern = fused_chain_matmul(
        *[jnp.asarray(c) for c in comps], forms=ref_forms,
        carry_side=ch.carry_side, slot_ids=ch.slot_ids,
        slot_elems=ch.slot_elems, complex_mode=True, interpret=True,
    )
    oracle = chain_reference(
        [jnp.asarray(c) for c in comps], forms=ref_forms,
        carry_side=ch.carry_side, complex_mode=True,
    )
    got = cg.chain_gemm(
        [_t(c) for c in comps], forms, ch.carry_side, ch.slot_ids,
        ch.slot_elems, complex_mode=True,
    )
    for g, k, o in zip(got, kern, oracle):
        np.testing.assert_allclose(g.numpy(), np.asarray(k), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(o), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", [1])
def test_fused_chain_wrapper_matches_reference_ops(which):
    ch = _REF_CHAINS[which]
    ref_forms = tuple(_REF_PLAN.schedule.specs[p].form for p in ch.positions)
    forms = tuple(GemmForm(**dataclasses.asdict(f)) for f in ref_forms)
    rng = np.random.default_rng(20 + which)
    operands = [
        (sc * (rng.standard_normal(s) + 1j * rng.standard_normal(s))).astype(np.complex64)
        for s, sc in zip(_external_shapes(forms, ch.carry_side), _external_scales(forms))
    ]
    want = np.asarray(ref_ops.fused_chain(
        operands, forms=ref_forms, carry_side=ch.carry_side,
        slot_ids=ch.slot_ids, slot_elems=ch.slot_elems,
        use_kernel=True, interpret=True,
    ))
    got = ops.fused_chain(
        [_t(o) for o in operands], forms=forms, carry_side=ch.carry_side,
        slot_ids=ch.slot_ids, slot_elems=ch.slot_elems,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_chain_slot_overflow_is_refused():
    ch = _REF_CHAINS[0]
    forms = tuple(GemmForm(**dataclasses.asdict(_REF_PLAN.schedule.specs[p].form))
                  for p in ch.positions)
    comps = [torch.zeros(s) for s in _external_shapes(forms, ch.carry_side)]
    with pytest.raises(ValueError, match="overflows"):
        cg.chain_gemm(comps, forms, ch.carry_side, ch.slot_ids,
                      tuple(1 for _ in ch.slot_elems))


# ----------------------------------------------------------------------
# no fallback: a CUDA tensor launches its kernel or raises
# ----------------------------------------------------------------------
def _calls():
    f = _random_form(np.random.default_rng(0), 0, 2, 2, 2)
    ch = _REF_CHAINS[0]
    forms = tuple(GemmForm(**dataclasses.asdict(_REF_PLAN.schedule.specs[p].form))
                  for p in ch.positions)
    ext = [torch.zeros(s) for s in _external_shapes(forms, ch.carry_side)]
    return {
        "tiled_gemm": lambda: cg.tiled_gemm(torch.zeros(1, 4, 4), torch.zeros(1, 4, 4)),
        "fused_gemm": lambda: cg.fused_gemm(
            (torch.zeros(f.a_shape),), (torch.zeros(f.b_shape),), f),
        "chain_gemm": lambda: cg.chain_gemm(
            ext, forms, ch.carry_side, ch.slot_ids, ch.slot_elems),
    }


@pytest.mark.parametrize("name", ["tiled_gemm", "fused_gemm", "chain_gemm"])
def test_cuda_call_without_library_raises(name, monkeypatch, tmp_path):
    """With the device check answering "CUDA" and no kernel library to
    build, the wrapper raises; it never runs the plain version."""
    call = _calls()[name]
    monkeypatch.setattr(cg, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(cg, "fused_gemm_plain", None)
    monkeypatch.setattr(cg, "tiled_gemm_plain", None)
    monkeypatch.setattr(cg, "chain_gemm_plain", None)
    before = dict(cg.LAUNCHES)
    with pytest.raises((RuntimeError, OSError)):
        call()
    assert cg.LAUNCHES == before


def test_unsupported_device_is_refused():
    a = torch.empty(1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        cg.tiled_gemm(a, a)


def test_cpu_calls_launch_nothing():
    cg.reset_launches()
    for call in _calls().values():
        call()
    assert set(cg.LAUNCHES.values()) == {0}


def test_kernels_take_fp32_planes_only():
    with pytest.raises(TypeError):
        cg.tiled_gemm(torch.zeros(1, 2, 2, dtype=torch.float64),
                      torch.zeros(1, 2, 2, dtype=torch.float64))


def test_chain_launcher_takes_cuda_planes_only():
    """The launcher is the host half of the kernel path; CPU planes take
    ``chain_gemm``'s plain version instead."""
    ch = _REF_CHAINS[0]
    forms = tuple(GemmForm(**dataclasses.asdict(_REF_PLAN.schedule.specs[p].form))
                  for p in ch.positions)
    ext = [torch.zeros(s) for s in _external_shapes(forms, ch.carry_side)]
    with pytest.raises(ValueError, match="CUDA"):
        cg.chain_gemm_launcher(ext, forms, ch.carry_side, ch.slot_ids,
                               ch.slot_elems)
