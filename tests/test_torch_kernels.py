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
import math

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
from repro_torch.kernels.ref import permute_reshape  # noqa: E402
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


# ----------------------------------------------------------------------
# K2's gather maps and orientation, K3's packed launch state
# ----------------------------------------------------------------------
def _unswizzle(offsets: np.ndarray, n: int | None = None) -> np.ndarray:
    """The slots of swizzled byte offsets (the inverse of
    ``cg.swizzle_offset`` over a tile of ``n`` slots, default
    ``offsets.size``)."""
    n = offsets.size if n is None else n
    inv = np.empty(n, dtype=np.int64)
    inv[cg.swizzle_offset(np.arange(n)) // 4] = np.arange(n)
    return inv[offsets // 4]


def _uniform_reads(plan, BM, BN):
    """Each operand's (rel, slot, rows) per element as K2's producers read
    a uniform plan: chunk t + 256 c at crel[t] + crel[256 c], swizzled
    offset csw[t] ^ csw[256 c], its four k at the chunk's kj offsets."""
    bk = cg.FUSED_BK
    m = plan.maps.astype(np.int64)
    na, nb = BM * bk, BN * bk
    kjs = m[2 * (na + nb) + BM + BN:]
    out = []
    for off, n, R, kj in ((0, na, BM, kjs[:4]), (2 * na, nb, BN, kjs[4:])):
        nc = n // 4
        crel = m[off:off + nc].reshape(-1, 256)
        csw = m[off + n:off + n + nc].reshape(-1, 256)
        rel = (crel[:1] + crel[:, :1]).reshape(-1)
        first = _unswizzle((csw[:1] ^ csw[:, :1]).reshape(-1), n)
        out.append(((rel[:, None] + kj[None, :]).reshape(-1),
                    (first[:, None] + np.arange(4)).reshape(-1), R))
    return out


def _oriented_operands(f, a, b):
    """The operands as K2 reads them: (rows op, cols op), each (B, R, K)
    with K fastest, from permute_reshape of the native tensors."""
    a2 = permute_reshape(a, f.perm_a, (f.B, f.M, f.K))
    b2 = permute_reshape(b, f.perm_b, (f.B, f.K, f.N)).transpose(1, 2)
    return (b2, a2) if f.N > f.M else (a2, b2)


def _gather_maps(f):
    """Each oriented operand's map from gather_map: (rel, slot, rows)."""
    _, _, _, N, _, roles = cg.oriented_roles(f)
    BM, BN = cg.fused_tile(N)
    rel_a, slot_a, _ = cg.gather_map(roles[1], roles[2], BM)
    rel_b, slot_b, _ = cg.gather_map(roles[5], roles[4], BN)
    return (rel_a, slot_a, BM), (rel_b, slot_b, BN)


def _check_map_tiles(op_offsets, rel, slot, R, n_rows, K, B, tiles,
                     ascending=True):
    """Scatter each tile's map entries (base + rel) into (row, k) slots
    and compare with the operand's tile of native offsets
    (``op_offsets(bt, rows, ks)``), zero-padded as -1."""
    bk = cg.FUSED_BK
    ok = rel >= 0
    if ascending:
        assert np.all(np.diff(rel[ok]) > 0) and not ok[ok.sum():].any()
    assert sorted(slot.tolist()) == list(range(R * bk))
    for bt, t, kt in tiles:
        rows = np.arange(t * R, min((t + 1) * R, n_rows))
        ks = np.arange(kt * bk, min((kt + 1) * bk, K))
        want = np.full((R, bk), -1, dtype=np.int64)
        want[:rows.size, :ks.size] = op_offsets(bt, rows, ks)
        got = np.full(R * bk, -1, dtype=np.int64)
        got[slot[ok]] = want[0, 0] + rel[ok]
        np.testing.assert_array_equal(got.reshape(R, bk), want)


def _all_tiles(B, n_rows, R, K):
    bk = cg.FUSED_BK
    return [(bt, t, kt) for bt in range(B) for t in range(-(-n_rows // R))
            for kt in range(-(-K // bk))]


MAP_CASES = FORM_CASES + [
    (5, 0, 9, 3, 7),   # M = 512, K = 128: several row and k tiles
    (6, 1, 3, 8, 6),   # N > M: the operands swap, batch 2
    (7, 0, 8, 7, 6),   # N = 128: the 64 x 128 tile
    (10, 0, 9, 6, 6),  # whole 128 x 64 tiles: the uniform gather
]


@pytest.mark.parametrize("seed,nb,nm,nn,nk", MAP_CASES)
def test_gather_map_reproduces_permute_reshape_tile(seed, nb, nm, nn, nk):
    """K2's map, one per operand and the same for every tile of a binary
    form: base + rel scattered into the (row, k) slots is
    permute_reshape's tile of native offsets, and the entries ascend.
    Forms whose tiles are whole run the uniform gather, which reads the
    map split per producer thread; the others run the general one."""
    f = _random_form(np.random.default_rng(seed), nb, nm, nn, nk)
    plan = cg.fused_plan(f)
    BM, BN = cg.fused_tile(min(f.M, f.N))
    assert plan.swap == (f.N > f.M) and plan.wide == (BN == 128)
    whole = max(f.M, f.N) % BM == 0 and min(f.M, f.N) % BN == 0 and f.K % 32 == 0
    assert plan.uniform == whole
    a = torch.arange(math.prod(f.a_shape)).reshape(f.a_shape)
    b = torch.arange(math.prod(f.b_shape)).reshape(f.b_shape)
    ops_ = _oriented_operands(f, a, b)
    maps = [(_gather_maps(f), True)] + ([(_uniform_reads(plan, BM, BN), False)] if whole else [])
    for op_maps, ascending in maps:
        for op, (rel, slot, R) in zip(ops_, op_maps):
            n_rows = op.shape[1]
            _check_map_tiles(
                lambda bt, rows, ks: op[bt][rows][:, ks].numpy(), rel, slot, R,
                n_rows, f.K, f.B, _all_tiles(f.B, n_rows, R, f.K), ascending)


def test_gather_map_general_form_keeps_an_order_only():
    """Axes of 3: a 128-row tile is no product of trailing axes, so the
    map gives only the order of the slots, and the kernel addresses them
    through per-tile tables."""
    f = _random_form(np.random.default_rng(8), 0, 5, 2, 4, size=3)
    plan = cg.fused_plan(f)
    assert not plan.uniform
    BM, BN = cg.fused_tile(min(f.M, f.N))
    bk = cg.FUSED_BK
    m = plan.maps
    na, nb = BM * bk, BN * bk
    for rel, slot, R in ((m[:na], m[na:2 * na], BM),
                         (m[2 * na:2 * na + nb], m[2 * na + nb:2 * (na + nb)], BN)):
        assert (rel == 0).all()
        assert sorted(slot.tolist()) == list(range(R * bk))


def _amp30_plan():
    from repro_torch.core import plan_compiled
    from repro_torch.core.executor import simplify_network
    from repro_torch.quantum import circuits

    circ = circuits.sycamore_like(5, 6, 14, seed=0)
    tn, _ = simplify_network(*circuits.circuit_to_network(circ, bitstring="0" * 30))
    plan, _ = plan_compiled(tn, 28, device="cpu")
    return plan


_AMP30 = []


def _amp30_fused_forms():
    if not _AMP30:
        _AMP30.append(_amp30_plan())
    return [s.form for s in _AMP30[0].schedule.specs if s.backend == "fused"]


def _native_offsets(shape, perm, splits, bt, rows, ks):
    """permute_reshape's index map written out: the native offset of
    role element (bt, row, k) of an operand of native ``shape`` whose
    axes ``perm`` orders as (batch, rows, k) with ``splits`` axes each."""
    nb, nr, _ = splits
    role_dims = [shape[p] for p in perm]
    b_idx = np.unravel_index(bt, role_dims[:nb]) if nb else ()
    r_idx = np.unravel_index(rows, role_dims[nb:nb + nr])
    k_idx = np.unravel_index(ks, role_dims[nb + nr:])
    coords = [None] * len(shape)
    for j, p in enumerate(perm):
        if j < nb:
            coords[p] = np.full((rows.size, ks.size), b_idx[j])
        elif j < nb + nr:
            coords[p] = np.broadcast_to(r_idx[j - nb][:, None], (rows.size, ks.size))
        else:
            coords[p] = np.broadcast_to(k_idx[j - nb - nr][None, :], (rows.size, ks.size))
    return np.ravel_multi_index(coords, shape)


@pytest.mark.parametrize("which", range(3))
def test_gather_map_amp30_fused_forms(which):
    """The three fused steps of the 30-qubit plan (the largest A has 28
    binary axes, 2^28 elements): uniform maps, A read in runs of 1024
    contiguous elements, and the first, a middle and the last tile of
    each operand reproduced (the offsets computed by index arithmetic,
    as the operand is too large to materialise here)."""
    f = _amp30_fused_forms()[which]
    plan = cg.fused_plan(f)
    assert plan.uniform and not plan.swap
    BM, BN = cg.fused_tile(f.N)
    (rel_a, slot_a, _), (rel_b, slot_b, _) = _gather_maps(f)
    nb, nm, nk = len(f.batch_shape), len(f.m_shape), len(f.k_shape)
    nn = len(f.n_shape)
    pb = f.perm_b[:nb] + f.perm_b[nb + nk:] + f.perm_b[nb:nb + nk]  # (batch, n, k)
    for shape, perm, splits, rel, slot, R, n_rows in (
        (f.a_shape, f.perm_a, (nb, nm, nk), rel_a, slot_a, BM, f.M),
        (f.b_shape, pb, (nb, nn, nk), rel_b, slot_b, BN, f.N),
    ):
        tiles = _all_tiles(f.B, n_rows, R, f.K)
        _check_map_tiles(
            lambda bt, rows, ks: _native_offsets(shape, perm, splits, bt, rows, ks),
            rel, slot, R, n_rows, f.K, f.B, [tiles[0], tiles[len(tiles) // 2], tiles[-1]])
    for (shape, perm, splits, n_rows), (rel, slot, R) in zip(
            ((f.a_shape, f.perm_a, (nb, nm, nk), f.M), (f.b_shape, pb, (nb, nn, nk), f.N)),
            _uniform_reads(plan, BM, BN)):
        tiles = _all_tiles(f.B, n_rows, R, f.K)
        _check_map_tiles(
            lambda bt, rows, ks: _native_offsets(shape, perm, splits, bt, rows, ks),
            rel, slot, R, n_rows, f.K, f.B, [tiles[0], tiles[-1]], ascending=False)
    if which == 0:  # the largest step: 4 runs of 1024 elements per A tile
        runs = np.flatnonzero(np.diff(rel_a) != 1).size + 1
        assert runs == 4


@pytest.mark.parametrize("seed,nb,nm,nn,nk", FORM_CASES[3:])
def test_complex_fused_wrapper_returns_complex64(seed, nb, nm, nn, nk):
    """ops.fused_matmul keeps complex64 end to end on the CPU (the card
    reads it in place) and equals the reference's ops.fused_matmul."""
    rng = np.random.default_rng(seed + 30)
    f = _random_form(rng, nb, nm, nn, nk)

    def cplx(shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    a, b = cplx(f.a_shape), cplx(f.b_shape)
    want = np.asarray(ref_ops.fused_matmul(
        a, b, perm_a=f.perm_a, perm_b=f.perm_b, nb=nb, nm=nm, nn=nn, nk=nk,
        bm=8, bn=8, bk=8, interpret=True,
    ))
    got = ops.fused_matmul(_t(a), _t(b), f)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.transpose(want, f.out_perm),
                               rtol=RTOL, atol=ATOL)


def _chain_args(which):
    ch = _REF_CHAINS[which]
    forms = tuple(GemmForm(**dataclasses.asdict(_REF_PLAN.schedule.specs[p].form))
                  for p in ch.positions)
    return forms, ch.carry_side, ch.slot_ids, ch.slot_elems


def _chain_operands(which, seed):
    forms, carry_side, _, _ = _chain_args(which)
    rng = np.random.default_rng(seed)
    return [
        (sc * (rng.standard_normal(s) + 1j * rng.standard_normal(s))).astype(np.complex64)
        for s, sc in zip(_external_shapes(forms, carry_side), _external_scales(forms))
    ]


def test_complex_chain_wrapper_returns_complex64():
    """ops.fused_chain on complex64 externals returns complex64 equal to
    the reference's ops.fused_chain (the longest chain of the plan)."""
    forms, carry_side, slot_ids, slot_elems = _chain_args(0)
    ref_forms = tuple(_REF_PLAN.schedule.specs[p].form for p in _REF_CHAINS[0].positions)
    operands = _chain_operands(0, 40)
    want = np.asarray(ref_ops.fused_chain(
        operands, forms=ref_forms, carry_side=carry_side, slot_ids=slot_ids,
        slot_elems=slot_elems, use_kernel=True, interpret=True,
    ))
    got = ops.fused_chain([_t(o) for o in operands], forms=forms,
                          carry_side=carry_side, slot_ids=slot_ids,
                          slot_elems=slot_elems)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_chain_launch_state_is_cached_per_chain():
    """The same chain takes its launch state from the cache; another
    chain, or another cluster size, builds its own."""
    a = _chain_args(0)
    first = cg.chain_state(*a, True, "cpu")
    assert cg.chain_state(*a, True, "cpu") is first
    assert cg.chain_state(*_chain_args(1), True, "cpu") is not first
    assert cg.chain_state(*a, True, "cpu", cluster=2) is not first
    assert cg.chain_state(*a, False, "cpu") is not first
    assert first.work.dtype == torch.complex64
    assert first.work.numel() == sum(a[3])


def _emulate_chain(state, externals):
    """K3 from its packed words alone, in numpy: each step's A, B and
    output offsets read from the tables the way the kernel reads them
    (hi[t] + lo[i], or full[t * extent + i])."""
    work = np.zeros(state.work.numel(), dtype=np.complex128)
    out = np.zeros(math.prod(state.out_shape), dtype=np.complex128)
    for p, tab, ext, _ in state.segments:
        w = tab.numpy().astype(np.int64)
        assert w.size == p.tab_words and w.size % 4 == 0 and w[0] == p.nsteps
        for t in range(p.nsteps):
            h = cg._C_HDR + t * cg._C_SWORDS
            B, M, N, K, tm, tn, tiles, asrc, bsrc, cdst = w[h:h + 10]
            assert (tm, tn, tiles) == (-(-M // 64), -(-N // 64), B * tm * tn)
            extents = cg._C_EXTENTS

            def offs(r, size):
                hi, lo, full = w[h + 10 + 3 * r:h + 13 + 3 * r]
                i = np.arange(size)
                tt, ii = i // extents[r], i % extents[r]
                return w[hi + tt * full + ii] if full else w[hi + tt] + w[lo + ii]

            def src(s):
                return externals[ext[s]].reshape(-1) if s >= 0 else work[-s - 1:]

            A = src(asrc)[offs(0, B)[:, None, None] + offs(1, M)[None, :, None]
                          + offs(2, K)[None, None, :]]
            Bm = src(bsrc)[offs(3, B)[:, None, None] + offs(4, K)[None, :, None]
                           + offs(5, N)[None, None, :]]
            where = (offs(6, B)[:, None, None] + offs(7, M)[None, :, None]
                     + offs(8, N)[None, None, :])
            dst = out if cdst < 0 else work[cdst:]
            dst[where] = np.einsum("bmk,bkn->bmn", A, Bm)
    return out.reshape(state.out_shape)


@pytest.mark.parametrize("which,max_chain", [(0, 32), (1, 32), (0, 2)])
def test_chain_packed_tables_emulated_match_plain(which, max_chain, monkeypatch):
    """K3's host packing: the words and 32-bit tables one launch stages
    in shared memory reproduce the plain chain when read as the kernel
    reads them, also when the chain is cut into several launches whose
    carries cross in the workspace."""
    monkeypatch.setattr(cg, "MAX_CHAIN", max_chain)
    monkeypatch.setattr(cg, "_CHAINS", {})
    forms, carry_side, slot_ids, slot_elems = _chain_args(which)
    state = cg.chain_state(forms, carry_side, slot_ids, slot_elems, True, "cpu")
    n_launch = -(-len(forms) // max_chain)
    assert len(state.segments) == n_launch
    operands = _chain_operands(which, 50 + which)
    got = _emulate_chain(state, operands)
    comps = [c for o in operands for c in (_t(o.real.copy()), _t(o.imag.copy()))]
    want = cg.chain_gemm_plain(comps, forms, carry_side, True)
    np.testing.assert_allclose(got, want[0].numpy() + 1j * want[1].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_swizzle_offsets_match_the_layout():
    """The host's swizzled byte offsets (K2's uniform maps hold slots as
    them) fill the tile once, and place (row, k) where TMA's 128-byte
    swizzle would: 16-byte chunk k // 4 of row ``row`` XOR row % 8."""
    slots = np.arange(128 * cg.FUSED_BK)
    off = cg.swizzle_offset(slots)
    np.testing.assert_array_equal(_unswizzle(off), slots)
    assert sorted(off.tolist()) == list(range(0, 4 * slots.size, 4))
    row, k = slots // 32, slots % 32
    np.testing.assert_array_equal(off // 128, row)
    np.testing.assert_array_equal((off % 128) // 16, (k // 4) ^ (row % 8))


# ----------------------------------------------------------------------
# the in-place wrappers' host side, with the launch done by the plain
# version: shapes, orientation, widths and flags as the kernel gets them
# ----------------------------------------------------------------------
def _fake_launch(calls):
    def launch(lib, tiled, form, a, b, out, precision, cplx, a16, b16, c16):
        assert (a.dtype == torch.bfloat16) == a16 and (b.dtype == torch.bfloat16) == b16
        assert a.is_contiguous() and b.is_contiguous()
        planes = lambda x, shape: (cg.widen(x, shape).real, cg.widen(x, shape).imag) \
            if cplx else (cg.widen(x, shape),)
        res = cg.fused_gemm_plain(planes(a, form.a_shape), planes(b, form.b_shape),
                                  form, precision)
        res = torch.complex(*res) if cplx else res[0]
        out.copy_(cg.to_pairs16(res) if c16 else res)
        calls.append((tiled, precision, a16, b16, c16))
        return 0
    return launch


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("half", [False, True])
def test_in_place_wrappers_host_side(precision, half, monkeypatch):
    """tiled_gemm (GEMM order: its operands reshaped to the split form),
    tiled_gemm_step and fused_gemm_c64 hand the kernel contiguous
    operands of the form's shapes and the width flags, count one launch,
    and return the output in the caller's shape."""
    calls = []
    monkeypatch.setattr(cg, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(cg, "load_library", lambda name: None)
    monkeypatch.setattr(cg, "check", lambda lib, rc, what: None)
    monkeypatch.setattr(cg, "_device_plan", lambda form, dev: (cg.fused_plan(form), None, None))
    monkeypatch.setattr(cg, "_launch_inplace", _fake_launch(calls))
    rng = np.random.default_rng(5)
    a = _t((rng.standard_normal((2, 256, 96)) + 1j * rng.standard_normal((2, 256, 96)))
           .astype(np.complex64))
    b = _t((rng.standard_normal((2, 96, 128)) + 1j * rng.standard_normal((2, 96, 128)))
           .astype(np.complex64))
    x, y = (cg.to_pairs16(a), cg.to_pairs16(b)) if half else (a, b)
    # a half-width output is rounded to bf16: one ulp where the two sums
    # round apart
    rtol = 2.0 ** -7 if half else RTOL
    cg.reset_launches()
    got = cg.tiled_gemm(x, y, precision=precision, out16=half)
    want = cg.tiled_gemm_plain(cg.widen(x, a.shape), cg.widen(y, b.shape), precision)
    assert tuple(cg.widen(got, (2, 256, 128)).shape) == (2, 256, 128)
    np.testing.assert_allclose(cg.widen(got, (2, 256, 128)).numpy(),
                               (cg.widen(cg.to_pairs16(want), (2, 256, 128)) if half
                                else want).numpy(), rtol=rtol, atol=ATOL)
    f = _random_form(np.random.default_rng(1), 1, 2, 2, 3)
    an = _t(rng.standard_normal(f.a_shape).astype(np.float32))
    bn = _t(rng.standard_normal(f.b_shape).astype(np.float32))
    xn, yn = (cg.to_pairs16(an), cg.to_pairs16(bn)) if half else (an, bn)
    for fn in (cg.tiled_gemm_step, cg.fused_gemm_c64):
        out = fn(xn, yn, f, precision=precision, out16=half)
        (want,) = cg.fused_gemm_plain((cg.widen(xn, f.a_shape),),
                                      (cg.widen(yn, f.b_shape),), f, precision)
        np.testing.assert_allclose(cg.widen(out, f.out_shape).numpy(),
                                   (cg.widen(cg.to_pairs16(want), f.out_shape) if half
                                    else want).numpy(), rtol=rtol, atol=ATOL)
    assert [c[0] for c in calls] == [1, 1, 0]
    assert all(c[2:] == (half, half, half) for c in calls)
    assert cg.LAUNCHES["tiled_gemm"] == 2 and cg.LAUNCHES["fused_gemm"] == 1
    assert cg.BF16_LAUNCHES["tiled_gemm"] == (2 if precision == "bf16" else 0)
