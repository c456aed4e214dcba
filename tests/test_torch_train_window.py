"""The sliding window in K4's backward (the hybrid's training path), held
against the JAX package on the CPU.

The reference differentiates its jnp ``blockwise_attention`` (its Pallas
kernel has no backward); here the plain version of K4's backward, which
the wrapper runs on CPU tensors, is held against ``jax.vjp`` of it with
the same ``window``, and against float64 autograd of the plain forward.
The backward kernels themselves run only on the card
(``tests/test_torch_cuda.py``).  Inputs are drawn with numpy from fixed
seeds.

Tolerances: fp32 gradients within 1e-5 of each gradient's max|value|
(another tiling of the same sums); float64 within 1e-10 (the explicit
formulas against autograd of the same function).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jL  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-5


def _heads(x):
    """(B, S, H, d) numpy -> (B·H, S, d) fp32 tensor, the kernel's layout."""
    B, S, H, d = x.shape
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(B * H, S, d)))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


# (sq, sk, q_offset, window): windows of one key, of a tile, of 100 (no
# multiple of 64), and one as long as the keys; query chunks at an offset
CASES = [
    (128, 128, 0, 1),
    (128, 128, 0, 64),
    (192, 192, 0, 100),
    (64, 192, 128, 100),
    (128, 256, 128, 64),
    (128, 128, 0, 128),
    (64, 128, 64, 300),
]


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("sq,sk,q_offset,window", CASES)
def test_windowed_bwd_plain_matches_reference_vjp(sq, sk, q_offset, window,
                                                  group):
    """dq, dk, dv of the plain backward (from the plain forward's output
    and logsumexp) against ``jax.vjp`` of the reference's windowed
    ``blockwise_attention``, causal, GQA group 1 and 4."""
    rng = np.random.default_rng(sq + sk + q_offset + window + group)
    B, H, d = 2, 4, 16
    q = rng.normal(size=(B, sq, H, d)).astype(np.float32)
    k = rng.normal(size=(B, sk, H // group, d)).astype(np.float32)
    v = rng.normal(size=(B, sk, H // group, d)).astype(np.float32)
    do = rng.normal(size=(B, sq, H, d)).astype(np.float32)
    want_o, vjp = jax.vjp(
        lambda *t: jL.blockwise_attention(*t, causal=True, q_offset=q_offset,
                                          window=window),
        *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(w).transpose(0, 2, 1, 3).reshape(-1, w.shape[1], d)
            for w in vjp(jnp.asarray(do))]
    qt, kt, vt, dot = map(_heads, (q, k, v, do))
    o, lse = fa.flash_attention_plain(qt, kt, vt, causal=True,
                                      q_offset=q_offset, window=window,
                                      return_lse=True)
    assert _rel(o, np.asarray(want_o).transpose(0, 2, 1, 3).reshape(
        B * H, sq, d)) <= TOL
    fa.reset_launches()
    got = fa.flash_attention_bwd(qt, kt, vt, o, lse, dot, causal=True,
                                 q_offset=q_offset, window=window)
    assert set(fa.LAUNCHES.values()) == {0}
    assert set(fa.BWD_WINDOW_ROUTES.values()) == {0}
    plain = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, causal=True,
                                         q_offset=q_offset, window=window)
    # at window 1 each query's softmax has one key, so dS, dq and dk are
    # 0 but for rounding on both sides: there they are held to TOL of
    # max|dv|
    dv_scale = float(np.abs(want[2]).max())
    for name, g, p, w in zip("qkv", got, plain, want):
        assert torch.equal(g, p), name
        if window == 1 and name != "v":
            err = float(np.abs(g.double().numpy() - w).max()) / dv_scale
        else:
            err = _rel(g, w)
        assert err <= TOL, (name, err)


@pytest.mark.parametrize("sq,sk,q_offset,window,group", [
    (64, 64, 0, 5, 1),
    (128, 128, 0, 70, 2),
    (64, 192, 128, 100, 4),
])
def test_windowed_bwd_plain_gradcheck(sq, sk, q_offset, window, group):
    """The windowed explicit formulas against autograd of the plain
    forward in float64 (both take only the band)."""
    g = torch.Generator().manual_seed(sq + window)
    q = torch.randn(4, sq, 8, generator=g, dtype=torch.float64)
    k = torch.randn(4 // group, sk, 8, generator=g, dtype=torch.float64)
    v = torch.randn(4 // group, sk, 8, generator=g, dtype=torch.float64)
    ins = tuple(t.clone().requires_grad_() for t in (q, k, v))
    kw = dict(causal=True, q_offset=q_offset, window=window)
    o = fa.flash_attention_plain(*ins, **kw)
    do = torch.randn(o.shape, generator=g, dtype=torch.float64)
    want = torch.autograd.grad(o, ins, do)
    o2, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd_plain(q, k, v, o2, lse, do, **kw)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-10)


def test_windowed_bwd_skips_what_the_band_hides():
    """Keys wholly before every query's window get exactly zero dk and
    dv, and a window as long as the keys gives the causal gradients."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 256, 16, generator=g) for _ in range(4))
    o, lse = fa.flash_attention_plain(q[:, 192:], k, v, q_offset=192,
                                      window=64, return_lse=True)
    dq, dk, dv = fa.flash_attention_bwd_plain(q[:, 192:], k, v, o, lse,
                                              do[:, 192:], q_offset=192,
                                              window=64)
    # query 192 sees keys 129..192: keys 0..128 are outside every band
    assert not dk[:, :129].any() and not dv[:, :129].any()
    assert dk[:, 129:].abs().amax(-1).gt(0).all()
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    full = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    long = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, window=256)
    for x, y in zip(long, full):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_windowed_attention_under_autograd():
    """``ops.attention`` with a window trains: the gradient through
    FlashAttentionFn (plain versions on the CPU) is autograd's of the
    plain forward."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(1, 128, 4, 8, generator=g, requires_grad=True)
    k = torch.randn(1, 128, 2, 8, generator=g, requires_grad=True)
    v = torch.randn(1, 128, 2, 8, generator=g, requires_grad=True)
    out = ops.attention(q, k, v, window=40)
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    heads = [t.detach().transpose(1, 2).reshape(-1, 128, 8).requires_grad_()
             for t in (q, k, v)]
    plain = fa.flash_attention_plain(*heads, window=40)
    want = torch.autograd.grad(plain.square().sum(), heads)
    for x, w in zip(got, want):
        torch.testing.assert_close(
            x.transpose(1, 2).reshape(w.shape), w, rtol=1e-5, atol=1e-6)

