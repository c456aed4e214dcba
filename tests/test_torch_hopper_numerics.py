"""The arithmetic of the two wgmma kernels, emulated on the CPU and held
against the JAX Pallas kernels they replace before the card runs them.

The wgmma kernels split each fp32 element into TF32 hi and lo parts in
their producers (``cvt.rna``; :func:`tf32_split` below is the same rule
in tensor code) and sum ``a_hi.b_hi + a_hi.b_lo + a_lo.b_hi`` in fp32.
Each TF32 product is exact in fp32, so ``torch.matmul`` on the parts is
the kernels' arithmetic up to the order of the sum.

K1 (``tiled_gemm``) is K2's kernel body on the GEMM in GEMM order
(``contract_gemm.gemm_form``), so ``_k2_emulated`` on that form is K1's
arithmetic; held against ``tiled_matmul`` (interpret mode) within the
card's ``RTOL, ATOL = 1e-5, 1e-4``.

K2 (``fused_gemm_c64``) gathers each tile of the oriented step through
its map, splits every element into TF32 hi and lo parts, and sums
each 32-wide k-tile's products (complex direct form, three TF32 products
per real product) into a fresh partial that is added to the fp32
accumulator; ``_k2_emulated`` does exactly that from the host's own
descriptor and maps, and is held against the Pallas
``fused_transpose_matmul`` (interpret mode; through the reference's
``ops.fused_matmul`` for complex operands) within ``RTOL, ATOL``.

K4's bf16 kernel (``flash_attention``) scales the fp32 scores after the
product (into the log2 domain, with ``p = 2^(x - m)``) and rounds the
probabilities to bf16 before ``P @ V``.  A test-only copy of the plain
loop does the same and is held against the
Pallas ``flash_attention`` (interpret mode) within the card's
``FLASH_TOL = 1e-2`` of max|reference|.

K5's wgmma route (``ssd_intra_chunk``) computes C·Bᵀ once per (group,
chunk) as 3xTF32, takes the masked scores from it by select before the
hi/lo split, folds ``dec_j`` into xdt's rows so that Bᵀ serves every
head, takes the cumsum as a warp scan, and sums each 32-wide k-tile into
a fresh partial; ``_k5_emulated`` does the same and is held against the
Pallas ``ssd_intra_chunk`` (interpret mode) within ``K5_TOL = 1e-5`` of
max|reference| (3xTF32 keeps ~22 bits a product; the rest is summation
order).  The permuted k order that lets the scores go to ``wgmma`` as
register A fragments is checked slot by slot.
"""

import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.contract_gemm import (  # noqa: E402
    fused_transpose_matmul,
    tiled_matmul,
)
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.mamba2_ssd import ssd_intra_chunk as jax_ssd_chunk  # noqa: E402

from repro_torch.kernels import contract_gemm as cg  # noqa: E402
from repro_torch.lowering.gemm_form import lower_step  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4  # tests/test_torch_cuda.py, chip_smoke.KERNEL_TOL
FLASH_TOL = 1e-2  # chip_smoke.FLASH_TOL: bf16 output rounding alone is 2^-8
K5_TOL = 1e-5  # of max|reference|: 3xTF32 and another summation order


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """TF32 rounding by arithmetic, independent of the bit trick: nearest
    multiple of 2^(e-10) for 2^e <= |x| < 2^(e+1), ties away from 0."""
    x = x.astype(np.float64)
    e = np.floor(np.log2(np.abs(x)))
    ulp = np.exp2(e - 10)
    return (np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp).astype(np.float32)


_TF32_HALF = 1 << 12
_TF32_MASK = -(1 << 13)  # 0xFFFFE000 as int32


def tf32_split(x: torch.Tensor) -> torch.Tensor:
    """The producers' split of fp32 ``x``: ``(2, *x.shape)`` holding
    ``x_hi = tf32(x)`` and ``x_lo = tf32(x - x_hi)``.  ``tf32`` rounds to
    10 explicit mantissa bits, to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` does: an integer add of half the dropped field,
    then a mask of the 13 dropped bits."""
    out = torch.empty((2, *x.shape), dtype=torch.float32)
    hi, lo = out[0], out[1]
    hi_bits, lo_bits = hi.view(torch.int32), lo.view(torch.int32)
    torch.add(x.contiguous().view(torch.int32), _TF32_HALF, out=hi_bits)
    hi_bits.bitwise_and_(_TF32_MASK)
    torch.sub(x, hi, out=lo)  # exact: hi holds x's leading 11 bits
    lo_bits.add_(_TF32_HALF).bitwise_and_(_TF32_MASK)
    return out


# ------------------------------------------------------------ TF32 split
def test_tf32_split_rounds_to_nearest_ties_away():
    """x_hi is cvt.rna.tf32.f32 of x, and x_lo that of x - x_hi: the bit
    trick the emulations below use against rounding by arithmetic."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-20, 20, 4096)))
    x = x.astype(np.float32)
    # exact ties: 11 significant bits and a half in the 12th
    ties = (np.arange(1, 257, dtype=np.float32) * 2 + 1) * np.float32(2.0**-11)
    x = np.concatenate([x, ties + 1.0, -(ties + 1.0)]).astype(np.float32)
    hi, lo = tf32_split(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(hi, _rna_tf32(x))
    keep = x != hi  # an x that is a TF32 value leaves lo = 0
    np.testing.assert_array_equal(lo[keep], _rna_tf32(x[keep] - hi[keep]))
    assert not lo[~keep].any()


@pytest.mark.parametrize("shape,transpose", [
    ((3, 40, 33), False),
    ((2, 17, 64), False),
    ((2, 45, 30), True),    # a transposed view
])
def test_tf32_split_reconstructs_and_pads(shape, transpose):
    """hi + lo is x to half a TF32 ulp of lo, both parts TF32 values;
    a tile's padding (zeros) splits to zeros."""
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if transpose:
        x = x.transpose(1, 2)
    x = torch.nn.functional.pad(x, (0, 3))
    planes = tf32_split(x)
    assert planes.shape == (2, *x.shape) and planes.is_contiguous()
    hi, lo = planes[0], planes[1]
    # both parts are TF32 values, and the padding is zero
    assert not (planes.view(torch.int32) & 0x1FFF).any()
    assert not planes[..., -3:].any()
    # hi + lo is x up to the rounding of lo, half a TF32 ulp of lo
    ulp = torch.exp2(torch.floor(torch.log2(lo.abs().clamp_min(1e-38))) - 10)
    assert ((hi.double() + lo.double() - x.double()).abs() <= ulp / 2).all()


# ------------------------------------------------------------------- K1
@pytest.mark.parametrize("B,M,N", [(1, 200, 136), (2, 75, 260)])
def test_3xtf32_matches_pallas_tiled_matmul(B, M, N):
    """K1's arithmetic (K2's body on the GEMM's form), K = 1024 and
    ragged M/N, against the Pallas kernel on zero-padded operands (as
    the reference's ops.matmul pads)."""
    K, blk = 1024, 128
    rng = np.random.default_rng(M + N)
    a = rng.standard_normal((B, M, K)).astype(np.float32)
    b = rng.standard_normal((B, K, N)).astype(np.float32)
    f = cg.gemm_form(B, M, N, K)
    got = _k2_emulated(a.reshape(f.a_shape), b.reshape(f.b_shape), f).reshape(B, M, N)
    mp, np_ = -(-M // blk) * blk, -(-N // blk) * blk
    for i in range(B):
        pa = np.zeros((mp, K), np.float32)
        pb = np.zeros((K, np_), np.float32)
        pa[:M], pb[:, :N] = a[i], b[i]
        want = np.asarray(tiled_matmul(pa, pb, bm=blk, bn=blk, bk=blk,
                                       interpret=True))[:M, :N]
        np.testing.assert_allclose(got[i], want, rtol=RTOL, atol=ATOL)


def test_tf32_alone_misses_the_tolerance():
    """The split is what keeps fp32 accuracy: one TF32 product (hi.hi)
    leaves the card's tolerance at K = 1024."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((1, 64, 1024)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 1024, 64)).astype(np.float32))
    ap, bp = tf32_split(a), tf32_split(b)
    one = ap[0] @ bp[0]
    three = (ap[1] @ bp[0] + ap[0] @ bp[1]) + one
    want = (a.double() @ b.double()).float()
    assert not torch.allclose(one, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(three, want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------- K2

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


def _role_offsets(desc, r, size):
    """Offsets of role word ``r`` of a K2 descriptor, as the kernel's
    role_off computes them."""
    hi, lo, lo_n = (int(x) for x in desc[r:r + 3])
    i = np.arange(size)
    return desc[hi + i // lo_n] + desc[lo + i % lo_n]


def _split(x: np.ndarray):
    """TF32 (hi, lo) of a real tile, as the producer's cvt.rna pair."""
    hi, lo = tf32_split(torch.from_numpy(np.ascontiguousarray(x, np.float32)))
    return hi, lo


def _k2_emulated(a: np.ndarray, b: np.ndarray, form) -> np.ndarray:
    """K2's arithmetic on the CPU from the host's descriptor and maps:
    the oriented operands (swapped when N > M), each tile gathered
    through its map (or the per-tile tables of a general form), TF32
    hi/lo parts, the complex direct form with three TF32 products per
    real product, one fresh fp32 partial per 32-wide k-tile added to
    the accumulator, the output scattered through its role tables."""
    plan = cg.fused_plan(form)
    d = plan.desc
    B, M, N, K = (int(x) for x in d[:4])
    BM, BN = cg.fused_tile(N)
    bk = cg.FUSED_BK
    x, y = (b, a) if plan.swap else (a, b)
    xf, yf = x.reshape(-1), y.reshape(-1)
    na, nb = BM * bk, BN * bk
    mp = plan.maps.astype(np.int64)
    if plan.uniform:  # the chunk maps, as the producers read them
        maps = [(rel, slot) for rel, slot, _ in _uniform_reads(plan, BM, BN)]
    else:
        maps = ((mp[:na], mp[na:2 * na]),
                (mp[2 * na:2 * na + nb], mp[2 * na + nb:2 * (na + nb)]))
    o_row = mp[2 * (na + nb):2 * (na + nb) + BM]
    o_col = mp[2 * (na + nb) + BM:2 * (na + nb) + BM + BN]
    ab, am, ak, bb, bk_, bn, ob, om, on = (
        _role_offsets(d, r, n) for r, n in zip(range(4, 31, 3), (B, M, K, B, K, N, B, M, N)))
    cplx = np.iscomplexobj(a)
    out = np.zeros(B * M * N, dtype=np.complex64 if cplx else np.float32)

    def gather(src, rel, slot, R, rows, ks):
        t = np.zeros(R * bk, dtype=src.dtype)
        if plan.uniform:  # whole tiles: every entry inside the operand
            t[slot] = src[rows[0] + ks[0] + rel]
        else:
            r, k = slot // bk, slot % bk
            ok = (r < rows.size) & (k < ks.size)
            t[slot[ok]] = src[rows[r[ok]] + ks[k[ok]]]
        return t.reshape(R, bk)

    def mm(p, q):  # p (R, bk) . q (C, bk)^T in fp32
        return p @ q.T

    for bt, mt, nt in itertools.product(range(B), range(-(-M // BM)), range(-(-N // BN))):
        rows_a = ab[bt] + am[mt * BM:(mt + 1) * BM]
        rows_b = bb[bt] + bn[nt * BN:(nt + 1) * BN]
        acc_r = torch.zeros(BM, BN)
        acc_i = torch.zeros(BM, BN)
        for k0 in range(0, K, bk):
            ta = gather(xf, *maps[0], BM, rows_a, ak[k0:k0 + bk])
            tb = gather(yf, *maps[1], BN, rows_b, bk_[k0:k0 + bk])
            arh, arl = _split(ta.real)
            brh, brl = _split(tb.real)
            if cplx:
                aih, ail = _split(ta.imag)
                bih, bil = _split(tb.imag)
                pr = (mm(arl, brh) + mm(arh, brl) - mm(ail, bih) - mm(aih, bil)
                      - mm(aih, bih) + mm(arh, brh))
                pi = (mm(arl, bih) + mm(arh, bil) + mm(ail, brh) + mm(aih, brl)
                      + mm(aih, brh) + mm(arh, bih))
                acc_i += pi
            else:
                pr = mm(arl, brh) + mm(arh, brl) + mm(arh, brh)
            acc_r += pr
        m = np.arange(mt * BM, min((mt + 1) * BM, M))
        n = np.arange(nt * BN, min((nt + 1) * BN, N))
        if plan.uniform:  # the tile's base plus tile-local offsets
            base = ob[bt] + om[mt * BM] + on[nt * BN]
            where = base + o_row[m - mt * BM][:, None] + o_col[n - nt * BN][None, :]
        else:
            where = ob[bt] + om[m][:, None] + on[n][None, :]
        val = acc_r[:m.size, :n.size].numpy()
        if cplx:
            val = val + 1j * acc_i[:m.size, :n.size].numpy()
        out[where] = val
    return out.reshape(form.out_shape)


def _form(seed, nb, nm, nn, nk, size=2):
    rng = np.random.default_rng(seed)
    labels = [f"i{j}" for j in range(nb + nm + nn + nk)]
    rng.shuffle(labels)
    bt, m = labels[:nb], labels[nb:nb + nm]
    n, k = labels[nb + nm:nb + nm + nn], labels[nb + nm + nn:]
    ia = list(rng.permutation(bt + m + k))
    ib = list(rng.permutation(bt + k + n))
    out = [x for x in ia if x not in k] + [x for x in ib if x not in k and x not in ia]
    return lower_step(ia, ib, out, lambda _: size)


K2_CASES = [
    # seed, nb, nm, nn, nk, size
    (0, 0, 3, 2, 2, 2),    # one tile, K = 4
    (1, 1, 2, 2, 3, 2),    # batch 2
    (5, 0, 9, 3, 7, 2),    # 4 row tiles, 4 k-tiles
    (6, 1, 3, 8, 6, 2),    # N > M: the operands swap
    (7, 0, 8, 7, 6, 2),    # N = 128: the 64 x 128 tile (uniform gather)
    (10, 0, 9, 6, 6, 2),   # whole 128 x 64 tiles (uniform gather)
    (8, 0, 5, 2, 4, 3),    # axes of 3: per-tile tables, K = 81
]


@pytest.mark.parametrize("seed,nb,nm,nn,nk,size", K2_CASES)
def test_k2_complex_arithmetic_matches_pallas(seed, nb, nm, nn, nk, size):
    f = _form(seed, nb, nm, nn, nk, size)
    rng = np.random.default_rng(seed + 100)

    def cplx(shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    a, b = cplx(f.a_shape), cplx(f.b_shape)
    got = _k2_emulated(a, b, f)
    blk = dict(bm=128, bn=128, bk=32) if size == 2 else dict(bm=27, bn=9, bk=27)
    natural = np.asarray(ref_ops.fused_matmul(
        a, b, perm_a=f.perm_a, perm_b=f.perm_b, nb=nb, nm=nm, nn=nn, nk=nk,
        interpret=True, **blk))
    np.testing.assert_allclose(got, np.transpose(natural, f.out_perm), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.einsum(f.expr, a.astype(np.complex128),
                                              b.astype(np.complex128)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,nb,nm,nn,nk,size", [K2_CASES[2], K2_CASES[3]])
def test_k2_real_route_matches_pallas(seed, nb, nm, nn, nk, size):
    f = _form(seed, nb, nm, nn, nk, size)
    rng = np.random.default_rng(seed + 200)
    a = rng.standard_normal(f.a_shape).astype(np.float32)
    b = rng.standard_normal(f.b_shape).astype(np.float32)
    got = _k2_emulated(a, b, f)
    natural = np.asarray(fused_transpose_matmul(
        a, b, perm_a=f.perm_a, perm_b=f.perm_b, nb=nb, nm=nm, nn=nn, nk=nk,
        bm=128, bn=128, bk=32, interpret=True))
    np.testing.assert_allclose(got, np.transpose(natural, f.out_perm), rtol=RTOL, atol=ATOL)


def test_k2_single_tf32_product_misses_the_tolerance():
    """The three-product split is what keeps fp32 accuracy in K2 too:
    hi.hi alone leaves the tolerance at K = 1024."""
    f = _form(9, 0, 6, 6, 10)
    rng = np.random.default_rng(9)
    a = rng.standard_normal(f.a_shape).astype(np.float32)
    b = rng.standard_normal(f.b_shape).astype(np.float32)
    a2 = torch.from_numpy(a).permute(f.perm_a).reshape(f.M, f.K)
    b2 = torch.from_numpy(b).permute(f.perm_b).reshape(f.K, f.N)
    hi = tf32_split(a2)[0] @ tf32_split(b2)[0]
    want = (a2.double() @ b2.double()).numpy()
    assert not np.allclose(hi.numpy(), want, rtol=RTOL, atol=ATOL)
    natural = _k2_emulated(a, b, f)
    got = torch.from_numpy(natural).permute(
        [f.out_perm.index(i) for i in range(len(f.out_perm))]).reshape(f.M, f.N)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------- K4
def _flash_bf16_emulated(q, k, v, *, causal, q_offset, tile=128):
    """The bf16 kernel's numerics on the plain loop: scale (times
    log2(e)) after the product, p = 2^(x - m), P rounded to bf16 before
    P @ V, l over fp32 p; the kernel's 128-row, 128-key tiles."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    group = bh // k.shape[0]
    scale = math.log2(math.e) / math.sqrt(d)  # sm_scale into the log2 domain
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    out = torch.empty_like(q)
    for q0 in range(0, sq, tile):
        rows = min(tile, sq - q0)
        n_kt = -(-sk // tile)
        if causal:
            n_kt = min(n_kt, -(-(q_offset + q0 + rows) // tile))
        acc = torch.zeros(bh, rows, d)
        m_i = torch.full((bh, rows), -1e30)
        l_i = torch.zeros(bh, rows)
        qpos = q_offset + q0 + torch.arange(rows)
        for t in range(n_kt):
            k0 = t * tile
            s = (qf[:, q0:q0 + rows] @ kf[:, k0:k0 + tile].transpose(1, 2)) * scale
            kpos = k0 + torch.arange(s.shape[2])
            if causal:
                s = torch.where(qpos[:, None] >= kpos[None, :], s, -1e30)
            m_new = torch.maximum(m_i, s.amax(dim=2))
            p = torch.exp2(s - m_new[..., None])
            alpha = torch.exp2(m_i - m_new)
            l_i = alpha * l_i + p.sum(dim=2)
            acc = acc * alpha[..., None] + (
                p.to(torch.bfloat16).float() @ vf[:, k0:k0 + tile])
            m_i = m_new
        out[:, q0:q0 + rows] = (acc / l_i.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out


@pytest.mark.parametrize("bh,group,sq,sk,q_offset,causal", [
    (2, 1, 512, 512, 0, True),     # the serve shape's sequence and head dim
    (4, 2, 128, 512, 384, True),   # a chunk at q_offset, GQA
    (2, 1, 256, 256, 0, False),
])
def test_flash_bf16_numerics_match_pallas(bh, group, sq, sk, q_offset, causal):
    d = 128
    rng = np.random.default_rng(sq + sk + q_offset)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh // group, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh // group, sk, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = _flash_bf16_emulated(tq, tk, tv, causal=causal, q_offset=q_offset)
    rep = np.repeat
    want = np.asarray(jax_flash(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(rep(k, group, axis=0), jnp.bfloat16),
        jnp.asarray(rep(v, group, axis=0), jnp.bfloat16), bq=128, bk=128,
        causal=causal, q_offset=q_offset, interpret=True), np.float32)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert got.dtype == torch.bfloat16
    assert err <= FLASH_TOL


# ------------------------------------------------------------------- K5
def _prod3(a: torch.Tensor, b: torch.Tensor, split: bool = True) -> torch.Tensor:
    """a @ b as the wgmma kernels sum it: per 32-wide k-tile a fresh
    partial of three TF32 products (lo.hi + hi.lo + hi.hi), the partials
    added in fp32; ``split=False`` keeps hi.hi alone."""
    out = None
    for k0 in range(0, a.shape[-1], 32):
        ah, al = tf32_split(a[..., k0:k0 + 32])
        bh, bl = tf32_split(b[..., k0:k0 + 32, :])
        part = (al @ bh + ah @ bl) + ah @ bh if split else ah @ bh
        out = part if out is None else out + part
    return out


def _warp_cumsum(a: np.ndarray) -> np.ndarray:
    """The kernel's cumsum over L = 64: lane l holds a[2l], a[2l+1]; a
    Hillis-Steele scan of the pair sums over 32 lanes, in fp32."""
    a0, a1 = a[..., 0::2], a[..., 1::2]
    run = a0 + a1
    for off in (1, 2, 4, 8, 16):
        shifted = np.zeros_like(run)
        shifted[..., off:] = run[..., :-off]
        run = run + shifted
    excl = np.zeros_like(run)
    excl[..., 1:] = run[..., :-1]
    c0 = excl + a0
    out = np.empty_like(a)
    out[..., 0::2], out[..., 1::2] = c0, c0 + a1
    return out


def _k5_emulated(x, dt, a, b, c, split=True):
    """The wgmma route's dataflow on the CPU: x (BH, C, L, D), b and c
    (G, C, L, S), numpy fp32."""
    hpg = x.shape[0] // b.shape[0]
    L = x.shape[2]
    tb, tc = torch.from_numpy(b), torch.from_numpy(c)
    cbt = _prod3(tc, tb.transpose(-1, -2), split)  # once per (group, chunk)
    cum = torch.from_numpy(_warp_cumsum(a))
    dec = torch.exp(cum[..., -1:] - cum)
    lower = torch.ones(L, L, dtype=torch.bool).tril()
    # the select comes before the split: exp may be inf above the diagonal
    scores = torch.where(
        lower, cbt.repeat_interleave(hpg, 0) * torch.exp(
            cum[..., :, None] - cum[..., None, :]), torch.zeros(()))
    xdt = torch.from_numpy(x) * torch.from_numpy(dt)[..., None]
    y = _prod3(scores, xdt, split)
    bt = tb.transpose(-1, -2).repeat_interleave(hpg, 0)  # shared by heads
    st = _prod3(bt, dec[..., None] * xdt, split)  # dec folded into xdt
    return y, st


def _k5_inputs(seed, BH, G, C, D, S, lo, hi):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, C, 64, D)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, (BH, C, 64)).astype(np.float32)
    a = -rng.uniform(lo, hi, (BH, C, 64)).astype(np.float32)
    b = rng.standard_normal((G, C, 64, S)).astype(np.float32)
    c = rng.standard_normal((G, C, 64, S)).astype(np.float32)
    return x, dt, a, b, c


def _k5_reference(x, dt, a, b, c):
    hpg = x.shape[0] // b.shape[0]
    rep = (np.repeat(b, hpg, 0), np.repeat(c, hpg, 0))
    return [np.asarray(t) for t in jax_ssd_chunk(
        *map(jnp.asarray, (x, dt, a, *rep)), interpret=True)]


@pytest.mark.parametrize("BH,G,C,D,S,lo,hi", [
    (24, 1, 2, 64, 128, 0.01, 0.5),   # the mamba2-130m cell: 24 heads, one group
    (4, 2, 2, 64, 64, 5.0, 10.0),     # decay overflow above the diagonal
])
def test_k5_wgmma_arithmetic_matches_pallas(BH, G, C, D, S, lo, hi):
    x, dt, a, b, c = _k5_inputs(BH + S, BH, G, C, D, S, lo, hi)
    got = _k5_emulated(x, dt, a, b, c)
    for g, w in zip(got, _k5_reference(x, dt, a, b, c)):
        assert torch.isfinite(g).all()
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= K5_TOL, err


def test_k5_single_tf32_product_misses_the_tolerance():
    """Without the lo planes the route would leave K5_TOL by far."""
    x, dt, a, b, c = _k5_inputs(7, 24, 1, 1, 64, 128, 0.01, 0.5)
    want = _k5_reference(x, dt, a, b, c)
    one = _k5_emulated(x, dt, a, b, c, split=False)
    err = max(np.abs(g.numpy() - w).max() / np.abs(w).max()
              for g, w in zip(one, want))
    assert err > 10 * K5_TOL


def test_k5_register_fragments_follow_the_permuted_k():
    """The y warpgroup builds wgmma's A fragment from the C·Bᵀ
    accumulator: for thread (warp w, lane) and k8 step kk it holds v[r] =
    score(row r0 + 8 (r % 2), j + r // 2), j = 8 kk + 2 (lane % 4).  A
    fragment register r is (row r0 + 8 (r % 2), k slot lane % 4 + 4 (r //
    2)) of mma's m16n8k8 tf32 layout, and the producers store j at slot p
    of each 8-block as 2 p (p < 4) or 2 (p - 4) + 1 (slot_j in the
    source): the two must name the same j, every slot exactly once."""
    def slot_j(ch, k):  # csrc/mamba2_ssd.cu: chunk ch of 4 slots, k < 4
        return 8 * (ch >> 1) + (ch & 1) + 2 * k

    for kk in range(8):
        seen = set()
        for w, lane in itertools.product(range(4), range(32)):
            q, r0 = lane % 4, 16 * w + lane // 4
            j = 8 * kk + 2 * q
            for r in range(4):
                row_v, j_v = r0 + 8 * (r % 2), j + r // 2  # what v[r] holds
                row_a, slot = r0 + 8 * (r % 2), q + 4 * (r // 2)  # A's reg r
                p = 8 * kk + slot
                assert row_v == row_a
                assert slot_j(p // 4, p % 4) == j_v
                seen.add((row_a, p))
        assert len(seen) == 64 * 8
