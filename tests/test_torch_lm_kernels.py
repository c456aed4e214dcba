"""The port's LM kernels (flash attention K4, Mamba-2 SSD chunk K5) and
their ops wrappers, held against the JAX package on the same inputs;
and their backward passes (the training path), held against float64
``gradcheck`` of the plain forwards and against ``jax.vjp`` of the
reference's jnp functions, which the reference differentiates (its
Pallas kernels have no backward).  The backward kernels themselves run
only on the card (``tests/test_torch_cuda.py``, which imports no JAX).

The CUDA kernels run only on the card; here the wrappers take their
plain PyTorch versions (CPU tensors) and are held against the Pallas
kernels in interpret mode, as ``tests/test_kernels.py`` runs them.
Inputs are drawn with numpy from fixed seeds.  Tolerances are the JAX
suite's: attention rtol/atol 2e-4 through ``ops.attention``, the bare
kernel 1e-4 in fp32 and 3e-2 in bf16, the SSD scan 2e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.mamba2_ssd import ssd_intra_chunk as jax_ssd_chunk  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("sq,sk,h,hkv,d", [
    (256, 256, 4, 4, 64),
    (256, 256, 8, 2, 64),   # GQA
    (128, 512, 4, 1, 32),   # MQA chunk with q_offset
])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_reference(sq, sk, h, hkv, d, causal):
    rng = np.random.default_rng(sq + sk + h + hkv + d + causal)
    q = rng.normal(size=(2, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(2, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(2, sk, hkv, d)).astype(np.float32)
    off = sk - sq if causal and sk > sq else 0
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, q_offset=off, bq=128, bk=128)
    fa.reset_launches()
    got = ops.attention(_t(q), _t(k), _t(v), causal=causal, q_offset=off)
    assert fa.LAUNCHES["flash_attention"] == 0  # CPU: the plain version
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("sq,sk,off", [(1, 96, 95), (100, 100, 0), (64, 64, 0)])
def test_attention_reference_dispatch(sq, sk, off):
    """Decode and ragged shapes take the naive reference on both sides."""
    rng = np.random.default_rng(sq)
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, sk, 2, 16)).astype(np.float32)
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, q_offset=off)
    got = ops.attention(_t(q), _t(k), _t(v), causal=True, q_offset=off)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_kernel(dtype, causal):
    rng = np.random.default_rng(7)
    shape = (16, 128, 32)  # kernel layout: (batch·heads, seq, head_dim)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jax_flash(jnp.asarray(q, jd), jnp.asarray(k, jd),
                     jnp.asarray(v, jd), bq=128, bk=128, causal=causal,
                     interpret=True)
    got = fa.flash_attention_plain(_t(q, td), _t(k, td), _t(v, td),
                                   causal=causal)
    assert got.dtype == td
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("group,q_offset,sq,sk", [
    (1, 0, 256, 256), (4, 0, 128, 128), (2, 128, 128, 256), (4, 256, 128, 384),
    # llama4-scout-17b-a16e's 40 q heads on 8 kv heads, qwen2-vl-72b's 64
    # on 8
    (5, 0, 128, 128), (5, 128, 128, 256), (8, 0, 128, 128),
])
def test_flash_gqa_index_matches_head_repeat(group, q_offset, sq, sk):
    """Query head bh reads kv head bh // group: the same function as the
    Pallas kernel on head-repeated k/v, with its q_offset (two kv heads
    at group 5)."""
    rng = np.random.default_rng(group + q_offset)
    bh, d = (8 if 8 % group == 0 else 2 * group), 32
    q = rng.normal(size=(bh, sq, d)).astype(np.float32)
    k = rng.normal(size=(bh // group, sk, d)).astype(np.float32)
    v = rng.normal(size=(bh // group, sk, d)).astype(np.float32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(np.repeat(k, group, 0)),
                     jnp.asarray(np.repeat(v, group, 0)), bq=128, bk=128,
                     causal=True, q_offset=q_offset, interpret=True)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=True,
                             q_offset=q_offset)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_flash_ragged_lengths_match_naive_reference():
    """Ragged lengths (sq, sk not tile multiples): the kernel's wrapper
    refuses them on every device, and ``ops.attention`` sends them to the
    naive reference, which matches the JAX package's."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 70, 3, 24)).astype(np.float32)
    k = rng.normal(size=(1, 150, 3, 24)).astype(np.float32)
    v = rng.normal(size=(1, 150, 3, 24)).astype(np.float32)
    for causal, off in ((True, 80), (False, 0)):
        with pytest.raises(ValueError):
            fa.flash_attention(*(_t(x[0].transpose(1, 0, 2)) for x in (q, k, v)),
                               causal=causal, q_offset=off)
        want = jref.attention_ref(
            *(jnp.asarray(x[0].transpose(1, 0, 2)) for x in (q, k, v)),
            causal=causal, q_offset=off)
        fa.reset_launches()
        got = ops.attention(_t(q), _t(k), _t(v), causal=causal, q_offset=off)
        assert fa.LAUNCHES["flash_attention"] == 0
        np.testing.assert_allclose(_np(got[0].transpose(0, 1)),
                                   np.asarray(want), rtol=1e-4, atol=1e-4)


def test_attention_ref_matches_reference():
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(4, 40, 16)).astype(np.float32) for _ in range(3))
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True)
    got = ref.attention_ref(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------- SSD
def _ssd_inputs(rng, BH, T, D, S, groups=None):
    G = groups or BH
    x = rng.normal(size=(BH, T, D)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, size=(BH, T)).astype(np.float32)
    a = -rng.uniform(0.01, 0.5, size=(BH, T)).astype(np.float32)
    b = rng.normal(size=(G, T, S)).astype(np.float32)
    c = rng.normal(size=(G, T, S)).astype(np.float32)
    return x, dt, a, b, c


@pytest.mark.parametrize("T,D,S,chunk", [(64, 16, 8, 16), (128, 32, 16, 32),
                                         (96, 8, 4, 32), (64, 16, 8, 64)])
def test_ssd_scan_matches_reference(T, D, S, chunk):
    rng = np.random.default_rng(T + D + S + chunk)
    x, dt, a, b, c = _ssd_inputs(rng, 3, T, D, S)
    want_y, want_h = ref_ops.ssd_scan(*map(jnp.asarray, (x, dt, a, b, c)),
                                      chunk=chunk, interpret=True)
    ssd.reset_launches()
    y, h = ops.ssd_scan(*map(_t, (x, dt, a, b, c)), chunk=chunk)
    assert ssd.LAUNCHES["ssd_chunk"] == 0
    np.testing.assert_allclose(_np(y), np.asarray(want_y), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(h), np.asarray(want_h), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("T,chunk", [(64, 16), (50, 16)])
def test_ssd_scan_with_initial_state(T, chunk):
    """``state0`` carried in, on the chunked path and on a ragged T (the
    sequential reference)."""
    rng = np.random.default_rng(T)
    x, dt, a, b, c = _ssd_inputs(rng, 2, T, 8, 4)
    h0 = rng.normal(size=(2, 4, 8)).astype(np.float32)
    want_y, want_h = ref_ops.ssd_scan(*map(jnp.asarray, (x, dt, a, b, c)),
                                      chunk=chunk, state0=jnp.asarray(h0),
                                      interpret=True)
    y, h = ops.ssd_scan(*map(_t, (x, dt, a, b, c)), chunk=chunk,
                        state0=_t(h0))
    np.testing.assert_allclose(_np(y), np.asarray(want_y), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(h), np.asarray(want_h), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("T", [64, 40])
def test_ssd_scan_head_free_groups(T):
    """B/C with one group per batch row (the model's head-free B/C): the
    reference's function on B/C repeated per head."""
    rng = np.random.default_rng(5)
    B, H = 2, 3
    x, dt, a, b, c = _ssd_inputs(rng, B * H, T, 8, 4, groups=B)
    want_y, want_h = ref_ops.ssd_scan(
        *map(jnp.asarray, (x, dt, a, np.repeat(b, H, 0), np.repeat(c, H, 0))),
        chunk=16, interpret=True)
    y, h = ops.ssd_scan(*map(_t, (x, dt, a, b, c)), chunk=16)
    np.testing.assert_allclose(_np(y), np.asarray(want_y), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(h), np.asarray(want_h), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("lo,hi", [(0.01, 0.5), (5.0, 10.0)])
def test_ssd_chunk_plain_matches_pallas_kernel(lo, hi):
    """The intra-chunk function itself, also where exp(cum_a[i] - cum_a[j])
    overflows above the diagonal (log decays of -5..-10 over 32 steps):
    both mask with a select, so neither gives NaN."""
    rng = np.random.default_rng(int(hi))
    BH, C, L, D, S = 3, 2, 32, 8, 4
    x = rng.normal(size=(BH, C, L, D)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, size=(BH, C, L)).astype(np.float32)
    a = -rng.uniform(lo, hi, size=(BH, C, L)).astype(np.float32)
    b = rng.normal(size=(BH, C, L, S)).astype(np.float32)
    c = rng.normal(size=(BH, C, L, S)).astype(np.float32)
    want = jax_ssd_chunk(*map(jnp.asarray, (x, dt, a, b, c)), interpret=True)
    got = ssd.ssd_intra_chunk(*map(_t, (x, dt, a, b, c)))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_ssd_scan_ref_matches_reference():
    rng = np.random.default_rng(2)
    x, dt, a, b, c = _ssd_inputs(rng, 2, 20, 4, 3)
    want = jref.ssd_scan_ref(*map(jnp.asarray, (x, dt, a, b, c)))
    got = ref.ssd_scan_ref(*map(_t, (x, dt, a, b, c)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- wrapper contract
def _lm_calls():
    z = torch.zeros
    return {
        "flash_attention": (fa, lambda: fa.flash_attention(
            z(4, 64, 16), z(2, 64, 16), z(2, 64, 16))),
        "ssd_chunk": (ssd, lambda: ssd.ssd_intra_chunk(
            z(4, 2, 16, 8), z(4, 2, 16), z(4, 2, 16), z(2, 2, 16, 4),
            z(2, 2, 16, 4))),
    }


@pytest.mark.parametrize("name", ["flash_attention", "ssd_chunk"])
def test_cuda_call_without_library_raises(name, monkeypatch, tmp_path):
    """With the device check answering "CUDA" and no kernel library to
    build, the wrapper raises; it never runs the plain version."""
    mod, call = _lm_calls()[name]
    monkeypatch.setattr(mod, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(fa, "flash_attention_plain", None)
    monkeypatch.setattr(ssd, "ssd_intra_chunk_plain", None)
    before = dict(mod.LAUNCHES)
    with pytest.raises((RuntimeError, OSError)):
        call()
    assert mod.LAUNCHES == before


def test_cpu_calls_launch_nothing():
    for mod, call in _lm_calls().values():
        mod.reset_launches()
        call()
        assert set(mod.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("bad", ["dtype", "heads", "rank", "ragged_q",
                                 "ragged_k", "head_dim", "bf16_head_dim"])
def test_flash_refuses_what_it_does_not_take(bad):
    q = torch.zeros(4, 64, 16)
    k = torch.zeros(2, 64, 16)
    if bad == "dtype":  # fp64 runs the plain version, on the CPU only
        with pytest.raises(TypeError):
            fa.flash_attention(q.half(), k.half(), k.half())
        with pytest.raises(TypeError):
            fa.flash_attention(q, k.bfloat16(), k.bfloat16())
    elif bad == "heads":
        with pytest.raises(ValueError):
            fa.flash_attention(q, torch.zeros(3, 64, 16), torch.zeros(3, 64, 16))
    elif bad == "ragged_q":
        with pytest.raises(ValueError):
            fa.flash_attention(q[:, :63], k, k)
    elif bad == "ragged_k":
        with pytest.raises(ValueError):
            fa.flash_attention(q, k[:, :40], k[:, :40])
    elif bad == "head_dim":
        with pytest.raises(ValueError):
            fa.flash_attention(torch.zeros(4, 64, 136), torch.zeros(2, 64, 136),
                               torch.zeros(2, 64, 136))
    elif bad == "bf16_head_dim":  # TMA's 16-byte rows: d % 8 in bf16
        z = torch.zeros(2, 64, 20, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            fa.flash_attention(torch.zeros(4, 64, 20, dtype=torch.bfloat16), z, z)
    else:
        with pytest.raises(ValueError):
            fa.flash_attention(q[0], k[0], k[0])


def test_fp64_runs_the_plain_versions_on_the_cpu():
    """On the CPU K4's and K5's entry points take fp64 (the model's fp64
    oracle) and give their plain versions' values in fp64."""
    g = torch.Generator().manual_seed(3)

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    q, k, v, do = r(4, 64, 16), r(2, 64, 16), r(2, 64, 16), r(4, 64, 16)
    kw = dict(causal=True, window=24)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    want = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert o.dtype == lse.dtype == torch.float64
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    for got, w in zip(fa.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                      fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)):
        assert got.dtype == torch.float64 and torch.equal(got, w)
    x, dt, a = r(4, 2, 16, 8), r(4, 2, 16).abs(), -r(4, 2, 16).abs()
    b, c = r(2, 2, 16, 4), r(2, 2, 16, 4)
    for got, w in zip(ssd.ssd_intra_chunk(x, dt, a, b, c),
                      ssd.ssd_intra_chunk_plain(x, dt, a, b, c)):
        assert got.dtype == torch.float64 and torch.equal(got, w)
    gy, gst = r(4, 2, 16, 8), r(4, 2, 4, 8)
    for got, w in zip(ssd.ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst),
                      ssd.ssd_intra_chunk_bwd_plain(x, dt, a, b, c, gy, gst)):
        assert got.dtype == torch.float64 and torch.equal(got, w)


def test_ssd_chunk_refuses_mismatched_groups():
    z = torch.zeros
    with pytest.raises(ValueError):
        ssd.ssd_intra_chunk(z(4, 2, 16, 8), z(4, 2, 16), z(4, 2, 16),
                            z(3, 2, 16, 4), z(3, 2, 16, 4))
    with pytest.raises(TypeError):
        ssd.ssd_intra_chunk(z(4, 2, 16, 8).double(), z(4, 2, 16), z(4, 2, 16),
                            z(2, 2, 16, 4), z(2, 2, 16, 4))


@pytest.mark.parametrize("L,D,S,route", [
    (64, 64, 128, "wgmma"),   # mamba2-130m
    (64, 128, 64, "wgmma"),
    (64, 192, 128, "wgmma"),
    (32, 64, 128, "simt"),    # another chunk length
    (128, 64, 128, "simt"),
    (64, 32, 128, "simt"),    # head dim not a multiple of 64
    (64, 64, 256, "simt"),    # state beyond two 64-row tiles
    (64, 64, 32, "simt"),
    (32, 16, 8, "simt"),      # the tests' small cells
])
def test_ssd_route_rule(L, D, S, route):
    assert ssd.ssd_route(L, D, S) == route


@pytest.mark.parametrize("heads,chunks,sms,hb", [
    (24, 32, 132, 6),     # serve: 4 groups x 8 chunks, 24 heads -> 128 blocks
    (1, 768, 132, 1),     # G == BH: one head a group
    (10, 32, 132, 3),     # 3 does not divide 10: blocks of 3, 3, 3, 1
    (24, 200, 132, 24),   # the pairs alone fill a wave: all heads a block
    (3, 1, 132, 1),
    (24, 32, 66, 12),
])
def test_ssd_heads_per_block(heads, chunks, sms, hb):
    assert ssd.heads_per_block(heads, chunks, sms) == hb
    blocks = chunks * -(-heads // hb)
    assert blocks <= max(sms, chunks)
    if hb > 1:  # one head fewer a block would leave the wave
        assert chunks * -(-heads // (hb - 1)) > sms


def test_ssd_chunk_route_argument():
    """``route=`` forces a kernel; the wgmma kernel refuses shapes outside
    its rule, an unknown route is refused, and on the CPU the plain
    version runs whatever the route and launches nothing."""
    z = torch.zeros
    small = (z(4, 2, 16, 8), z(4, 2, 16), z(4, 2, 16), z(2, 2, 16, 4),
             z(2, 2, 16, 4))
    with pytest.raises(ValueError):
        ssd.ssd_intra_chunk(*small, route="wgmma")
    with pytest.raises(ValueError):
        ssd.ssd_intra_chunk(*small, route="tensor")
    ssd.reset_launches()
    cell = (z(2, 1, 64, 64), z(2, 1, 64), z(2, 1, 64), z(1, 1, 64, 128),
            z(1, 1, 64, 128))
    for route in (None, "wgmma", "simt"):
        y, st = ssd.ssd_intra_chunk(*cell, route=route)
        assert y.shape == (2, 1, 64, 64) and st.shape == (2, 1, 128, 64)
    assert ssd.LAUNCHES["ssd_chunk"] == 0
    assert set(ssd.SSD_ROUTES.values()) == {0}


def test_all_sources_have_a_library():
    assert set(build.LIBRARIES) == {"gemm", "flash_attention", "mamba2_ssd"}
    for src in build.LIBRARIES.values():
        assert src.exists()
        assert "repro_error_string" in src.read_text()


@pytest.mark.parametrize("name,headers", [
    ("gemm", ["hopper.cuh"]),
    ("flash_attention", ["hopper.cuh"]),
    ("mamba2_ssd", ["hopper.cuh"]),
])
def test_library_sources_list_included_headers(name, headers):
    srcs = build.sources(name)
    assert srcs[0] == build.LIBRARIES[name]
    assert [p.name for p in srcs[1:]] == headers


@pytest.mark.parametrize("name", ["gemm", "flash_attention", "mamba2_ssd"])
def test_editing_a_header_renames_the_library(name, monkeypatch, tmp_path):
    """The library's name hashes every header its source includes, so an
    edited hopper.cuh is never served by a stale build; a header it does
    not include leaves the name alone."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "LIBRARIES", {
        n: csrc / p.name for n, p in build.LIBRARIES.items()})
    before = build._out_path(name)
    unused = csrc / "unused.cuh"  # included by no source
    unused.write_text("#pragma once\n")
    assert before == build._out_path(name)
    unused.write_text("#pragma once\n// edited\n")
    assert before == build._out_path(name)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = build._out_path(name)
    assert after != before and after.parent == before.parent


# ------------------------------------------------------------- backward
class _PlainFlash(torch.autograd.Function):
    """The plain forward under the plain backward's formulas."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                          q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        causal, q_offset = ctx.args
        return (*fa.flash_attention_bwd_plain(*ctx.saved_tensors, do,
                                              causal=causal,
                                              q_offset=q_offset), None, None)


class _PlainSSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a, b, c):
        ctx.save_for_backward(x, dt, a, b, c)
        return ssd.ssd_intra_chunk_plain(x, dt, a, b, c)

    @staticmethod
    def backward(ctx, gy, gst):
        return ssd.ssd_intra_chunk_bwd_plain(*ctx.saved_tensors, gy, gst)


@pytest.mark.parametrize("bh,group,sq,sk,causal,q_offset", [
    (4, 1, 64, 64, True, 0),
    (4, 4, 64, 128, True, 64),    # GQA group 4, causal with q_offset
    (4, 2, 128, 64, False, 0),    # full attention
    (8, 4, 128, 192, True, 64),   # two query tiles, q_offset
])
def test_flash_bwd_plain_gradcheck(bh, group, sq, sk, causal, q_offset):
    """The explicit backward formulas against float64 finite differences
    of the plain forward (gradcheck), and against autograd of it."""
    g = torch.Generator().manual_seed(bh + sq + sk)
    q = torch.randn(bh, sq, 4, generator=g, dtype=torch.float64)
    k = torch.randn(bh // group, sk, 4, generator=g, dtype=torch.float64)
    v = torch.randn(bh // group, sk, 4, generator=g, dtype=torch.float64)
    ins = tuple(t.requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda *t: _PlainFlash.apply(*t, causal, q_offset), ins, fast_mode=True)
    o = fa.flash_attention_plain(*ins, causal=causal, q_offset=q_offset)
    do = torch.randn(o.shape, generator=g, dtype=torch.float64)
    want = torch.autograd.grad(o, ins, do)
    o2, lse = fa.flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                       causal=causal, q_offset=q_offset,
                                       return_lse=True)
    got = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o2,
                                       lse, do, causal=causal, q_offset=q_offset)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("group,sq,sk,q_offset", [
    (5, 128, 128, 0), (5, 64, 192, 128), (8, 128, 128, 0)])
def test_flash_bwd_plain_matches_reference_on_repeated_heads(group, sq, sk,
                                                             q_offset):
    """The plain backward at llama4-scout-17b-a16e's GQA group (5) and
    qwen2-vl-72b's (8), two kv heads, against ``jax.vjp`` of the
    reference's ``blockwise_attention`` on head-repeated k/v (its dK/dV
    summed over each group by the repeat's vjp), the same numpy inputs:
    rtol 1e-5."""
    rng = np.random.default_rng(group + sq + q_offset)
    kv, d = 2, 32
    q = rng.normal(size=(1, sq, kv * group, d)).astype(np.float32)
    k = rng.normal(size=(1, sk, kv, d)).astype(np.float32)
    v = rng.normal(size=(1, sk, kv, d)).astype(np.float32)
    do = rng.normal(size=(1, sq, kv * group, d)).astype(np.float32)

    def repeated(q, k, v):
        return jL.blockwise_attention(q, jnp.repeat(k, group, axis=2),
                                      jnp.repeat(v, group, axis=2),
                                      causal=True, q_offset=q_offset)

    want_o, vjp = jax.vjp(repeated, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))

    def heads(x):  # (1, S, H, d) -> (H, S, d): head h is row h
        return _t(np.ascontiguousarray(x[0].transpose(1, 0, 2)))

    o, lse = fa.flash_attention_plain(heads(q), heads(k), heads(v),
                                      causal=True, q_offset=q_offset,
                                      return_lse=True)
    got = fa.flash_attention_bwd_plain(heads(q), heads(k), heads(v), o, lse,
                                       heads(do), causal=True,
                                       q_offset=q_offset)
    np.testing.assert_allclose(_np(o), _np(heads(np.asarray(want_o))),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(heads(np.asarray(w))),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("G,lo,hi", [(4, 0.01, 0.5), (1, 0.01, 0.5), (2, 0.5, 2.0)])
def test_ssd_bwd_plain_gradcheck(G, lo, hi):
    """The explicit K5 backward against float64 finite differences of the
    plain forward, 4 B/C groups of one head, one group of 4, and 2 of 2."""
    g = torch.Generator().manual_seed(G)
    BH, C, L, D, S = 4, 2, 6, 3, 2
    x = torch.randn(BH, C, L, D, generator=g, dtype=torch.float64)
    dt = 0.1 + 0.9 * torch.rand(BH, C, L, generator=g, dtype=torch.float64)
    a = -(lo + (hi - lo) * torch.rand(BH, C, L, generator=g, dtype=torch.float64))
    b = torch.randn(G, C, L, S, generator=g, dtype=torch.float64)
    c = torch.randn(G, C, L, S, generator=g, dtype=torch.float64)
    ins = tuple(t.requires_grad_() for t in (x, dt, a, b, c))
    assert torch.autograd.gradcheck(_PlainSSD.apply, ins, fast_mode=True)
    y, st = ssd.ssd_intra_chunk_plain(*ins)
    gy, gst = torch.randn_like(y), torch.randn_like(st)
    want = torch.autograd.grad((y, st), ins, (gy, gst))
    got = ssd.ssd_intra_chunk_bwd_plain(*(t.detach() for t in ins), gy, gst)
    for p_, w in zip(got, want):
        torch.testing.assert_close(p_, w, rtol=1e-10, atol=1e-10)


def test_ssd_strong_decay_gives_finite_plain_grads():
    """Decays of -5..-10 a step overflow exp(cum_i - cum_j) above the
    diagonal: the plain forward's autograd and the plain backward take
    exp only of selected entries, so every gradient is finite (a select
    after exp would give 0 · inf = NaN), and the two agree."""
    rng = np.random.default_rng(9)
    BH, C, L, D, S = 3, 2, 32, 8, 4
    x, dt, a, b, c = (
        _t(rng.normal(size=(BH, C, L, D))), _t(rng.uniform(0.1, 1.0, (BH, C, L))),
        _t(-rng.uniform(5.0, 10.0, (BH, C, L))), _t(rng.normal(size=(BH, C, L, S))),
        _t(rng.normal(size=(BH, C, L, S))))
    ins = tuple(t.requires_grad_() for t in (x, dt, a, b, c))
    y, st = ssd.ssd_intra_chunk_plain(*ins)
    gy, gst = torch.ones_like(y), torch.ones_like(st)
    auto = torch.autograd.grad((y, st), ins, (gy, gst))
    plain = ssd.ssd_intra_chunk_bwd_plain(*(t.detach() for t in ins), gy, gst)
    for p_, w in zip(plain, auto):
        assert torch.isfinite(p_).all() and torch.isfinite(w).all()
        torch.testing.assert_close(p_, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sq,sk,h,hkv,d,causal", [
    (128, 128, 4, 4, 16, True),
    (256, 256, 8, 2, 32, True),    # GQA, two query tiles of the reference
    (128, 256, 4, 1, 16, True),    # MQA chunk with q_offset
    (128, 512, 4, 2, 16, False),   # full attention (see below)
])
def test_attention_vjp_matches_reference(sq, sk, h, hkv, d, causal):
    """``ops.attention`` under autograd (FlashAttentionFn; on the CPU the
    plain forward and backward) against ``jax.vjp`` of the reference
    model's ``blockwise_attention``, rtol/atol 2e-4.  Full attention runs
    at sk = 512, its key block: at other lengths the reference pads the
    keys with zeros and, unmasked without causality, attends to them
    (kept as found, ROADMAP.md queue 3; its models are causal)."""
    rng = np.random.default_rng(sq + sk + h + d)
    q = rng.normal(size=(2, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(2, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(2, sk, hkv, d)).astype(np.float32)
    do = rng.normal(size=(2, sq, h, d)).astype(np.float32)
    off = sk - sq if causal else 0
    want_o, vjp = jax.vjp(
        lambda *t: jL.blockwise_attention(*t, causal=causal, q_offset=off),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    ins = [_t(x).requires_grad_() for x in (q, k, v)]
    fa.reset_launches()
    o = ops.attention(*ins, causal=causal, q_offset=off)
    o.backward(_t(do))
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    np.testing.assert_allclose(_np(o.detach()), np.asarray(want_o), rtol=2e-4,
                               atol=2e-4)
    for t, w in zip(ins, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("T,H,Dh,N,chunk", [(128, 3, 8, 4, 64), (64, 2, 16, 8, 16)])
def test_ssd_scan_vjp_matches_reference(T, H, Dh, N, chunk):
    """``ops.ssd_scan`` under autograd (SSDIntraChunkFn for the chunks,
    plain PyTorch for the inter-chunk recurrence) against ``jax.vjp`` of
    the reference model's ``_ssd_chunked_jnp`` (head-free B/C), with an
    initial state, rtol/atol 2e-4."""
    rng = np.random.default_rng(T + H)
    B = 2
    xh = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, (B, T, H)).astype(np.float32)
    a = -rng.uniform(0.01, 0.5, (B, T, H)).astype(np.float32)
    b = rng.normal(size=(B, T, N)).astype(np.float32)
    c = rng.normal(size=(B, T, N)).astype(np.float32)
    s0 = rng.normal(size=(B, H, N, Dh)).astype(np.float32)
    gy = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    gh = rng.normal(size=(B, H, N, Dh)).astype(np.float32)
    (want_y, want_h), vjp = jax.vjp(
        lambda *t: jL._ssd_chunked_jnp(*t[:5], chunk, t[5]),
        *map(jnp.asarray, (xh, dt, a, b, c, s0)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    ins = [_t(x).requires_grad_() for x in (xh, dt, a, b, c, s0)]
    ssd.reset_launches()
    y, h = L._ssd_chunked(*ins[:5], chunk, ins[5])
    torch.autograd.backward((y, h), (_t(gy), _t(gh)))
    assert ssd.LAUNCHES == {"ssd_chunk": 0, "ssd_chunk_bwd": 0}
    np.testing.assert_allclose(_np(y.detach()), np.asarray(want_y), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(_np(h.detach()), np.asarray(want_h), rtol=2e-4,
                               atol=2e-4)
    for t, w in zip(ins, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("op", ["attention", "ssd_scan"])
def test_forward_is_the_same_with_and_without_autograd(op):
    """Serving (inference mode, no gradient wanted) and training call the
    same autograd function: the outputs are bitwise the same, and only
    the training call records a backward."""
    rng = np.random.default_rng(11)
    if op == "attention":
        shapes = [(1, 128, 4, 16), (1, 128, 2, 16), (1, 128, 2, 16)]
        fn = ops.attention
    else:
        shapes = [(4, 128, 8), (4, 128), (4, 128), (2, 128, 4), (2, 128, 4)]
        fn = ops.ssd_scan
    ins = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if op == "ssd_scan":
        ins[2] = -np.abs(ins[2]) * 0.1
    with torch.inference_mode():
        served = fn(*map(_t, ins))
    trained = fn(*(_t(x).requires_grad_() for x in ins))
    served = served if isinstance(served, tuple) else (served,)
    trained = trained if isinstance(trained, tuple) else (trained,)
    for s, t in zip(served, trained):
        assert s.grad_fn is None and t.grad_fn is not None
        assert torch.equal(s, t.detach())


@pytest.mark.parametrize("name", ["flash_attention_bwd", "ssd_chunk_bwd",
                                  "flash_attention_bwd:mma",
                                  "ssd_chunk_bwd:wgmma"])
def test_backward_cuda_call_without_library_raises(name, monkeypatch, tmp_path):
    """With the device check answering "CUDA" and no kernel library to
    build, the backward wrappers raise on every route (fp32 K4 and small
    K5 cells take simt; bf16 K4 takes mma, a mamba2 cell wgmma); they
    never run the plain version."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    z = torch.zeros
    if name.startswith("flash_attention_bwd"):
        t = torch.bfloat16 if name.endswith(":mma") else torch.float32
        mod, call = fa, lambda: fa.flash_attention_bwd(
            z(4, 64, 16, dtype=t), z(2, 64, 16, dtype=t), z(2, 64, 16, dtype=t),
            z(4, 64, 16, dtype=t), z(4, 64), z(4, 64, 16, dtype=t))
        monkeypatch.setattr(fa, "flash_attention_bwd_plain", None)
        routes = fa.BWD_ROUTES
    else:
        BH, G, C, L, D, S = ((4, 2, 2, 64, 64, 64) if name.endswith(":wgmma")
                             else (4, 2, 2, 16, 8, 4))
        mod, call = ssd, lambda: ssd.ssd_intra_chunk_bwd(
            z(BH, C, L, D), z(BH, C, L), z(BH, C, L), z(G, C, L, S),
            z(G, C, L, S), z(BH, C, L, D), z(BH, C, S, D))
        monkeypatch.setattr(ssd, "ssd_intra_chunk_bwd_plain", None)
        routes = ssd.SSD_BWD_ROUTES
    monkeypatch.setattr(mod, "on_cpu", lambda *t: False)
    before, routes_before = dict(mod.LAUNCHES), dict(routes)
    with pytest.raises((RuntimeError, OSError)):
        call()
    assert mod.LAUNCHES == before and routes == routes_before


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "simt"),
                                         (torch.float64, None)])
def test_flash_bwd_route_rule(dtype, route):
    """K4's backward routes by dtype, as its forward: bf16 to the tensor
    cores, fp32 to FFMA; any other type is refused."""
    if route is None:
        with pytest.raises(TypeError):
            fa.bwd_route(dtype)
    else:
        assert fa.bwd_route(dtype) == route


@pytest.mark.parametrize("bad", ["mma_on_fp32", "unknown", "head_dim",
                                 "bf16_head_dim", "ragged"])
def test_flash_bwd_refuses_what_it_does_not_take(bad):
    """The backward takes the forward's shape rules (``_check_tiles``)
    and refuses a route its inputs do not take, before any launch."""
    def call(dtype=torch.float32, d=16, s=64, route=None):
        z = lambda *shape: torch.zeros(*shape, dtype=dtype)  # noqa: E731
        return fa.flash_attention_bwd(z(4, s, d), z(2, s, d), z(2, s, d),
                                      z(4, s, d), torch.zeros(4, s),
                                      z(4, s, d), route=route)
    fa.reset_launches()
    with pytest.raises(ValueError):
        if bad == "mma_on_fp32":
            call(route="mma")
        elif bad == "unknown":
            call(route="tensor")
        elif bad == "head_dim":
            call(d=136)
        elif bad == "bf16_head_dim":  # TMA's and cp.async's 16-byte rows
            call(dtype=torch.bfloat16, d=20)
        else:
            call(s=96)
    assert set(fa.LAUNCHES.values()) == {0}
    assert set(fa.BWD_ROUTES.values()) == {0}


def test_flash_bwd_route_argument_on_cpu():
    """On the CPU every route runs the plain version and launches
    nothing."""
    g = torch.Generator().manual_seed(0)
    q, o, do = (torch.randn(4, 64, 16, generator=g).bfloat16() for _ in range(3))
    k, v = (torch.randn(2, 64, 16, generator=g).bfloat16() for _ in range(2))
    lse = torch.randn(4, 64, generator=g)
    fa.reset_launches()
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for route in (None, "mma", "simt"):
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, route=route)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert set(fa.LAUNCHES.values()) == {0}
    assert set(fa.BWD_ROUTES.values()) == {0}


@pytest.mark.parametrize("route,bh,sq,sk,d,want", [
    # qwen3-4b's training shape: the mma route keeps dK/dV in registers
    ("mma", 64, 512, 512, 128, {"dsum": (64, 512)}),
    ("simt", 64, 512, 512, 128, {"dsum": (64, 512), "dk_part": (64, 512, 128),
                                 "dv_part": (64, 512, 128)}),
    ("mma", 4, 128, 384, 32, {"dsum": (4, 128)}),
    ("simt", 4, 128, 384, 32, {"dsum": (4, 128), "dk_part": (4, 384, 32),
                               "dv_part": (4, 384, 32)}),
])
def test_flash_bwd_workspace(route, bh, sq, sk, d, want):
    """The fp32 scratch each route of K4's backward allocates: no per-head
    dK/dV shares on the mma route."""
    assert fa.bwd_workspace(route, bh, sq, sk, d) == want


def test_flash_bwd_workspace_refuses_unknown_route():
    with pytest.raises(ValueError):
        fa.bwd_workspace("wgmma", 4, 64, 64, 16)


@pytest.mark.parametrize("route,BH,G,C,S,hb,want", [
    # mamba2-130m's training shape: 24 heads a group, 6 a block -> 4
    # shares per (group, chunk) on the wgmma route, 24 on the simt route
    ("wgmma", 96, 4, 8, 128, 6, (32, 4, 64, 128)),
    ("simt", 96, 4, 8, 128, 1, (96, 8, 64, 128)),
    ("wgmma", 96, 4, 8, 128, 24, None),   # one block a group: no shares
    ("wgmma", 40, 4, 8, 128, 3, (32, 4, 64, 128)),  # 10 heads: 3, 3, 3, 1
    ("simt", 6, 6, 3, 128, 1, None),      # one head a group: no shares
    ("wgmma", 6, 6, 3, 64, 1, None),
])
def test_ssd_bwd_workspace(route, BH, G, C, S, hb, want):
    """The gB/gC shares each route of K5's backward allocates (L = 64)."""
    got = ssd.bwd_workspace(route, BH, G, C, 64, S, hb)
    if want is None:
        assert got == {}
    else:
        assert got == {"gb_part": want, "gc_part": want}


def test_ssd_bwd_block_shares_at_the_training_shape():
    """At mamba2-130m's training shape (4 groups of 24 heads, 8 chunks, on
    132 SMs) the wgmma backward takes the forward's blocks: 6 heads a
    block, 128 blocks, 4 shares per (group, chunk) against 24 heads'."""
    hb = ssd.heads_per_block(24, 4 * 8, 132)
    assert hb == 6
    shares = ssd.bwd_workspace("wgmma", 96, 4, 8, 64, 128, hb)["gb_part"]
    assert shares[0] * shares[1] == 128 and shares[1] == 4
    per_head = ssd.bwd_workspace("simt", 96, 4, 8, 64, 128)["gb_part"]
    assert per_head[0] // 4 == 24


def test_ssd_bwd_workspace_refuses_unknown_route():
    with pytest.raises(ValueError):
        ssd.bwd_workspace("mma", 4, 2, 2, 64, 64)


def test_ssd_bwd_route_argument():
    """K5's backward routes by ``ssd_route`` (the forward's rule); the
    wgmma route refuses shapes outside it, an unknown route is refused,
    and on the CPU the plain version runs whatever the route and nothing
    is launched."""
    z = torch.zeros
    small = (z(4, 2, 16, 8), z(4, 2, 16), z(4, 2, 16), z(2, 2, 16, 4),
             z(2, 2, 16, 4), z(4, 2, 16, 8), z(4, 2, 4, 8))
    with pytest.raises(ValueError):
        ssd.ssd_intra_chunk_bwd(*small, route="wgmma")
    with pytest.raises(ValueError):
        ssd.ssd_intra_chunk_bwd(*small, route="tensor")
    ssd.reset_launches()
    rng = np.random.default_rng(0)
    cell = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 1, 64, 64), (2, 1, 64), (2, 1, 64), (1, 1, 64, 64),
                      (1, 1, 64, 64), (2, 1, 64, 64), (2, 1, 64, 64))]
    cell[1] = cell[1].abs()
    cell[2] = -0.1 * cell[2].abs()
    want = ssd.ssd_intra_chunk_bwd_plain(*cell)
    for route in (None, "wgmma", "simt"):
        got = ssd.ssd_intra_chunk_bwd(*cell, route=route)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert ssd.LAUNCHES["ssd_chunk_bwd"] == 0
    assert set(ssd.SSD_BWD_ROUTES.values()) == {0}
