"""The arithmetic of the two wgmma kernels, emulated on the CPU and held
against the JAX Pallas kernels they replace before the card runs them.

K1 (``tiled_gemm``) multiplies fp32 matrices as 3xTF32: each operand is
split into TF32 hi and lo planes by the wrapper (``contract_gemm.
tf32_planes``, plain tensor code that runs here too), and the kernel
sums ``a_hi.b_hi + a_hi.b_lo + a_lo.b_hi`` in fp32.  Each TF32 product
is exact in fp32, so ``torch.matmul`` on the planes is the kernel's
arithmetic up to the order of the sum.  Held against ``tiled_matmul``
(interpret mode) within the card's ``RTOL, ATOL = 1e-5, 1e-4``.

K4's bf16 kernel (``flash_attention``) scales the fp32 scores after the
product (into the log2 domain, with ``p = 2^(x - m)``) and rounds the
probabilities to bf16 before ``P @ V``.  A test-only copy of the plain
loop does the same and is held against the
Pallas ``flash_attention`` (interpret mode) within the card's
``FLASH_TOL = 1e-2`` of max|reference|.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.contract_gemm import tiled_matmul  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402

from repro_torch.kernels import contract_gemm as cg  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4  # tests/test_torch_cuda.py, chip_smoke.KERNEL_TOL
FLASH_TOL = 1e-2  # chip_smoke.FLASH_TOL: bf16 output rounding alone is 2^-8


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """TF32 rounding by arithmetic, independent of the bit trick: nearest
    multiple of 2^(e-10) for 2^e <= |x| < 2^(e+1), ties away from 0."""
    x = x.astype(np.float64)
    e = np.floor(np.log2(np.abs(x)))
    ulp = np.exp2(e - 10)
    return (np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp).astype(np.float32)


# ------------------------------------------------------------------- K1
def test_tf32_split_rounds_to_nearest_ties_away():
    """x_hi is cvt.rna.tf32.f32 of x, and x_lo that of x - x_hi."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-20, 20, 4096)))
    x = x.astype(np.float32)
    # exact ties: 11 significant bits and a half in the 12th
    ties = (np.arange(1, 257, dtype=np.float32) * 2 + 1) * np.float32(2.0**-11)
    x = np.concatenate([x, ties + 1.0, -(ties + 1.0)]).astype(np.float32)
    hi, lo = cg.tf32_split(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(hi, _rna_tf32(x))
    keep = x != hi  # an x that is a TF32 value leaves lo = 0
    np.testing.assert_array_equal(lo[keep], _rna_tf32(x[keep] - hi[keep]))
    assert not lo[~keep].any()


@pytest.mark.parametrize("shape,transpose", [
    ((3, 40, 33), False),   # K padded 33 -> 36
    ((2, 17, 64), False),   # K already a multiple of 4
    ((2, 45, 30), True),    # a transposed view, as Bt is made
])
def test_tf32_split_reconstructs_and_pads(shape, transpose):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if transpose:
        x = x.transpose(1, 2)
    k = x.shape[-1]
    planes = cg.tf32_split(x)
    kp = -(-k // 4) * 4
    assert planes.shape == (2, *x.shape[:-1], kp) and planes.is_contiguous()
    hi, lo = planes[0, ..., :k], planes[1, ..., :k]
    # both parts are TF32 values, and the padding is zero
    assert not (planes.view(torch.int32) & 0x1FFF).any()
    assert not planes[..., k:].any()
    # hi + lo is x up to the rounding of lo, half a TF32 ulp of lo
    ulp = torch.exp2(torch.floor(torch.log2(lo.abs().clamp_min(1e-38))) - 10)
    assert ((hi.double() + lo.double() - x.double()).abs() <= ulp / 2).all()


@pytest.mark.parametrize("B,M,N", [(1, 200, 136), (2, 75, 260)])
def test_3xtf32_matches_pallas_tiled_matmul(B, M, N):
    """The kernel's arithmetic on the wrapper's own planes, K = 1024 and
    ragged M/N, against the Pallas kernel on zero-padded operands (as
    the reference's ops.matmul pads)."""
    K, blk = 1024, 128
    rng = np.random.default_rng(M + N)
    a = rng.standard_normal((B, M, K)).astype(np.float32)
    b = rng.standard_normal((B, K, N)).astype(np.float32)
    ap, bp = cg.tf32_planes(torch.from_numpy(a), torch.from_numpy(b))
    a_hi, a_lo = ap[0], ap[1]
    bt_hi, bt_lo = bp[0].transpose(1, 2), bp[1].transpose(1, 2)
    got = (a_lo @ bt_hi + a_hi @ bt_lo) + a_hi @ bt_hi
    mp, np_ = -(-M // blk) * blk, -(-N // blk) * blk
    for i in range(B):
        pa = np.zeros((mp, K), np.float32)
        pb = np.zeros((K, np_), np.float32)
        pa[:M], pb[:, :N] = a[i], b[i]
        want = np.asarray(tiled_matmul(pa, pb, bm=blk, bn=blk, bk=blk,
                                       interpret=True))[:M, :N]
        np.testing.assert_allclose(got[i].numpy(), want, rtol=RTOL, atol=ATOL)


def test_tf32_alone_misses_the_tolerance():
    """The split is what keeps fp32 accuracy: one TF32 product (hi.hi)
    leaves the card's tolerance at K = 1024."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((1, 64, 1024)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 1024, 64)).astype(np.float32))
    ap, bp = cg.tf32_planes(a, b)
    one = ap[0] @ bp[0].transpose(1, 2)
    three = (ap[1] @ bp[0].transpose(1, 2) + ap[0] @ bp[1].transpose(1, 2)) + one
    want = (a.double() @ b.double()).float()
    assert not torch.allclose(one, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(three, want, rtol=RTOL, atol=ATOL)


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
