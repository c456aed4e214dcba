"""The CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU (the kernels have no CPU mode): they are
marked ``cuda`` and skip without one.  The file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import plan_compiled, simulate_amplitude  # noqa: E402
from repro_torch.core.executor import simplify_network  # noqa: E402
from repro_torch.hardware import H100_SXM  # noqa: E402
from repro_torch.kernels import contract_gemm as cg  # noqa: E402
from repro_torch.lowering.gemm_form import lower_step  # noqa: E402
from repro_torch.quantum import circuits, statevector  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
SMALL_HW = dataclasses.replace(
    H100_SXM, name="small", tile=4, block_candidates=(4, 8),
    einsum_flops_floor=64.0, chain_budget_bytes=1 << 16,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _random_form(rng, nb, nm, nn, nk, size):
    labels = [f"i{j}" for j in range(nb + nm + nn + nk)]
    rng.shuffle(labels)
    bt, m = labels[:nb], labels[nb:nb + nm]
    n, k = labels[nb + nm:nb + nm + nn], labels[nb + nm + nn:]
    ia = list(rng.permutation(bt + m + k))
    ib = list(rng.permutation(bt + k + n))
    out = [x for x in ia if x not in k] + [
        x for x in ib if x not in k and x not in ia
    ]
    return lower_step(ia, ib, out, lambda _: size)


@pytest.mark.parametrize("B,M,N,K", [
    (1, 100, 70, 33), (3, 64, 128, 16), (1, 1, 1, 1),
    (2, 300, 130, 45),     # ragged M/N, K not a multiple of 32 (nor of 4)
    (3, 129, 257, 1000),   # one row/column past a 128 tile, batch 3
    (1, 256, 385, 1024),   # the path's K
    (4, 64, 3, 7),         # odd N: the epilogue's scalar stores
])
def test_tiled_gemm_on_card(dev, B, M, N, K):
    g = torch.Generator().manual_seed(B + M + N + K)
    a = torch.randn(B, M, K, generator=g).to(dev)
    b = torch.randn(B, K, N, generator=g).to(dev)
    before = cg.LAUNCHES["tiled_gemm"]
    got = cg.tiled_gemm(a, b)
    assert cg.LAUNCHES["tiled_gemm"] == before + 1
    torch.testing.assert_close(got, cg.tiled_gemm_plain(a, b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,nb,nm,nn,nk,planes", [
    (0, 0, 3, 2, 2, 1), (1, 1, 2, 2, 3, 2), (2, 0, 5, 1, 1, 2),
    (3, 2, 1, 3, 2, 1), (4, 0, 1, 1, 6, 2),
])
def test_fused_gemm_on_card(dev, seed, nb, nm, nn, nk, planes):
    rng = np.random.default_rng(seed)
    f = _random_form(rng, nb, nm, nn, nk, size=4)

    def rnd(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    a = tuple(rnd(f.a_shape) for _ in range(planes))
    b = tuple(rnd(f.b_shape) for _ in range(planes))
    got = cg.fused_gemm(a, b, f)
    for x, y in zip(got, cg.fused_gemm_plain(a, b, f)):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


def test_chain_gemm_on_card(dev):
    """Every chain of a real plan, kernel against plain."""
    tn, _ = simplify_network(*circuits.circuit_to_network(
        circuits.sycamore_like(4, 4, 8), bitstring="0" * 16))
    plan, _ = plan_compiled(tn, 10, hw=SMALL_HW, device=dev)
    rng = np.random.default_rng(0)
    assert plan.chain_plan.chains
    for ch in plan.chain_plan.chains:
        forms = tuple(plan.schedule.specs[p].form for p in ch.positions)
        shapes = [forms[0].a_shape, forms[0].b_shape] + [
            forms[t].b_shape if ch.carry_side[t] == "l" else forms[t].a_shape
            for t in range(1, len(forms))
        ]
        scales = [forms[0].K ** -0.25] * 2 + [f.K ** -0.5 for f in forms[1:]]
        comps = [
            torch.from_numpy((sc * rng.standard_normal(s)).astype(np.float32)).to(dev)
            for s, sc in zip(shapes, scales) for _ in range(2)
        ]
        got = cg.chain_gemm(comps, forms, ch.carry_side, ch.slot_ids,
                            ch.slot_elems, complex_mode=True)
        want = cg.chain_gemm_plain(comps, forms, ch.carry_side, True)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


def test_chain_launcher_relaunches_the_same_chain(dev):
    """The prebuilt launcher (the smoke's kernel-alone timing) launches
    the chain again with the same arguments and gives chain_gemm's
    result every time."""
    tn, _ = simplify_network(*circuits.circuit_to_network(
        circuits.sycamore_like(4, 4, 8), bitstring="0" * 16))
    plan, _ = plan_compiled(tn, 10, hw=SMALL_HW, device=dev)
    ch = max(plan.chain_plan.chains, key=lambda c: c.n_steps)
    forms = tuple(plan.schedule.specs[p].form for p in ch.positions)
    shapes = [forms[0].a_shape, forms[0].b_shape] + [
        forms[t].b_shape if ch.carry_side[t] == "l" else forms[t].a_shape
        for t in range(1, len(forms))
    ]
    g = torch.Generator().manual_seed(0)
    comps = [torch.randn(s, generator=g).to(dev) for s in shapes for _ in range(2)]
    args = (comps, forms, ch.carry_side, ch.slot_ids, ch.slot_elems)
    want = cg.chain_gemm(*args, complex_mode=True)
    launch, outs = cg.chain_gemm_launcher(*args, complex_mode=True)
    before = cg.LAUNCHES["chain_gemm"]
    for _ in range(3):
        launch()
        for x, y in zip(outs, want):
            torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
    assert cg.LAUNCHES["chain_gemm"] > before


K2_CARD_CASES = [
    # seed, nb, nm, nn, nk, size
    (20, 0, 3, 2, 2, 3),   # axes of 3: M 27, N 9, K 9 (general gather)
    (21, 2, 2, 2, 3, 2),   # batch 4
    (22, 0, 2, 4, 3, 3),   # N > M: the operands swap; K = 27
    (23, 0, 9, 6, 6, 2),   # whole 128 x 64 tiles (uniform gather), 8 tiles
    (24, 1, 8, 7, 5, 2),   # N = 128 (the 64 x 128 tile), batch 2, K = 32
    (25, 0, 7, 8, 6, 2),   # N > M, whole tiles: swapped, 64 x 128, uniform
    (26, 0, 5, 3, 2, 5),   # axes of 5: ragged M 3125, N 125, K 25
]


def _rand(rng, shape, dtype, dev):
    x = rng.standard_normal(shape)
    if dtype == torch.complex64:
        x = x + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x.astype(np.complex64 if dtype == torch.complex64
                                     else np.float32)).to(dev)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.float32])
@pytest.mark.parametrize("seed,nb,nm,nn,nk,size", K2_CARD_CASES)
def test_fused_gemm_c64_on_card(dev, seed, nb, nm, nn, nk, size, dtype):
    """K2 on complex64 read in place (and on fp32, its real route), one
    launch, against its plain version."""
    rng = np.random.default_rng(seed)
    f = _random_form(rng, nb, nm, nn, nk, size)
    a, b = _rand(rng, f.a_shape, dtype, dev), _rand(rng, f.b_shape, dtype, dev)
    before = cg.LAUNCHES["fused_gemm"]
    got = cg.fused_gemm_c64(a, b, f)
    assert cg.LAUNCHES["fused_gemm"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == f.out_shape
    if dtype == torch.complex64:
        re, im = cg.fused_gemm_plain((a.real, a.imag), (b.real, b.imag), f)
        want = torch.complex(re, im)
    else:
        (want,) = cg.fused_gemm_plain((a,), (b,), f)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _amp30_plan(dev):
    tn, _ = simplify_network(*circuits.circuit_to_network(
        circuits.sycamore_like(5, 6, 14, seed=0), bitstring="0" * 30))
    plan, _ = plan_compiled(tn, 28, device=dev)
    return plan


def test_fused_gemm_amp30_forms_on_card(dev):
    """The three fused steps of the 30-qubit plan, complex64 in place,
    each through the uniform (coalesced) gather."""
    plan = _amp30_plan(dev)
    forms = [s.form for s in plan.schedule.specs if s.backend == "fused"]
    assert len(forms) == 3
    g = torch.Generator().manual_seed(3)
    for f in forms:
        a = torch.complex(torch.randn(f.a_shape, generator=g),
                          torch.randn(f.a_shape, generator=g)).to(dev)
        b = torch.complex(torch.randn(f.b_shape, generator=g),
                          torch.randn(f.b_shape, generator=g)).to(dev)
        before = cg.FUSED_ROUTES["uniform"]
        got = cg.fused_gemm_c64(a, b, f)
        assert cg.FUSED_ROUTES["uniform"] == before + 1
        re, im = cg.fused_gemm_plain((a.real, a.imag), (b.real, b.imag), f)
        err = (got - torch.complex(re, im)).abs().max() / torch.complex(re, im).abs().max()
        assert float(err) <= 1e-4
        del a, b, got, re, im


def _epilogue_chain(plan):
    specs = plan.schedule.specs
    chains = plan.chain_plan.segment_chains("epilogue") or list(plan.chain_plan.chains)
    ch = max(chains, key=lambda c: (c.n_steps, sum(specs[p].form.flops for p in c.positions)))
    return ch, tuple(specs[p].form for p in ch.positions)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_chain_amp30_chain_each_cluster_size(dev, cluster):
    """The longest epilogue chain of the 30-qubit plan (the one the smoke
    times) at every cluster size: the same result, within 1e-4 of the
    plain chain, in one launch."""
    ch, forms = _epilogue_chain(_amp30_plan(dev))
    assert ch.n_steps >= 5
    rng = np.random.default_rng(cluster)
    shapes = [forms[0].a_shape, forms[0].b_shape] + [
        forms[t].b_shape if ch.carry_side[t] == "l" else forms[t].a_shape
        for t in range(1, len(forms))
    ]
    scales = [forms[0].K ** -0.25] * 2 + [f.K ** -0.5 for f in forms[1:]]
    ext = [sc * _rand(rng, s, torch.complex64, dev) for s, sc in zip(shapes, scales)]
    before = cg.LAUNCHES["chain_gemm"]
    got = cg.chain_gemm_c64(ext, forms, ch.carry_side, ch.slot_ids, ch.slot_elems,
                            cluster=cluster)
    assert cg.LAUNCHES["chain_gemm"] == before + 1
    comps = [c for e in ext for c in (e.real.contiguous(), e.imag.contiguous())]
    re, im = cg.chain_gemm_plain(comps, forms, ch.carry_side, True)
    want = torch.complex(re, im)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def test_complex_wrappers_launch_one_kernel(dev):
    """ops.fused_matmul and ops.fused_chain on complex64 each launch one
    kernel and nothing else (no plane copies, no memsets)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    rng = np.random.default_rng(7)
    f = _random_form(rng, 0, 9, 6, 6, 2)
    a = _rand(rng, f.a_shape, torch.complex64, dev)
    b = _rand(rng, f.b_shape, torch.complex64, dev)
    tn, _ = simplify_network(*circuits.circuit_to_network(
        circuits.sycamore_like(4, 4, 8), bitstring="0" * 16))
    plan, _ = plan_compiled(tn, 10, hw=SMALL_HW, device=dev)
    ch = max(plan.chain_plan.chains, key=lambda c: c.n_steps)
    forms = tuple(plan.schedule.specs[p].form for p in ch.positions)
    shapes = [forms[0].a_shape, forms[0].b_shape] + [
        forms[t].b_shape if ch.carry_side[t] == "l" else forms[t].a_shape
        for t in range(1, len(forms))
    ]
    ext = [_rand(rng, s, torch.complex64, dev) for s in shapes]
    kw = dict(forms=forms, carry_side=ch.carry_side, slot_ids=ch.slot_ids,
              slot_elems=ch.slot_elems)
    calls = {"fused_gemm": lambda: ops.fused_matmul(a, b, f),
             "chain_gemm": lambda: ops.fused_chain(ext, **kw)}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize()
        assert out.dtype == torch.complex64
        device_events = [e.name for e in prof.events()
                         if e.device_type == DeviceType.CUDA]
        assert len(device_events) == 1 and name in device_events[0], device_events


@pytest.mark.parametrize("fused,chain_budget,kernel", [
    (True, 1 << 16, "chain_gemm"),
    (True, 1, "fused_gemm"),
    (False, 1, "tiled_gemm"),
])
def test_amplitude_on_card(dev, fused, chain_budget, kernel):
    """A 16-qubit amplitude through each kernel (a one-byte chain budget
    plans no chains, so the fused or tiled steps launch their own
    kernels) against the statevector on the card."""
    hw = dataclasses.replace(SMALL_HW, chain_budget_bytes=chain_budget)
    c = circuits.sycamore_like(4, 4, 8)
    cg.reset_launches()
    res = simulate_amplitude(c, "0" * 16, target_dim=10, hw=hw, fused=fused)
    assert cg.LAUNCHES[kernel] > 0
    want = statevector.amplitude(c, "0" * 16)
    np.testing.assert_allclose(res.value, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ bf16 routes
def _rel_plain(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _pairs(x):
    return cg.to_pairs16(x)


@pytest.mark.parametrize("cplx", [True, False])
@pytest.mark.parametrize("B,M,N,K", [
    (1, 256, 128, 96),    # whole tiles: the uniform gather
    (2, 130, 70, 45),     # ragged everywhere, K odd: per-tile tables
    (1, 1024, 512, 256),  # N > 64: the 64 x 128 tile; two bf16 stages
])
def test_tiled_gemm_bf16_route_on_card(dev, cplx, B, M, N, K):
    """K1's bf16 route (bf16 inputs, fp32 accumulation) against its plain
    twin, rounding first, within 1e-5 of max|plain|, in one launch."""
    rng = np.random.default_rng(M + N + K)
    dtype = torch.complex64 if cplx else torch.float32
    a, b = _rand(rng, (B, M, K), dtype, dev), _rand(rng, (B, K, N), dtype, dev)
    before = cg.LAUNCHES["tiled_gemm"]
    got = cg.tiled_gemm(a, b, precision="bf16")
    assert cg.LAUNCHES["tiled_gemm"] == before + 1
    assert _rel_plain(got, cg.tiled_gemm_plain(a, b, "bf16")) <= 1e-5


@pytest.mark.parametrize("B,M,N,K", [(1, 256, 128, 96), (2, 130, 70, 45),
                                     (1, 2048, 64, 512)])
def test_tiled_gemm_complex_in_place_on_card(dev, B, M, N, K):
    """K1 on complex64 read in place (direct form, 3xTF32) against what
    the Karatsuba wrapper of earlier versions computed: three real K1
    products on separate planes."""
    rng = np.random.default_rng(B * M + K)
    a = _rand(rng, (B, M, K), torch.complex64, dev)
    b = _rand(rng, (B, K, N), torch.complex64, dev)
    ar, ai = a.real.contiguous(), a.imag.contiguous()
    br, bi = b.real.contiguous(), b.imag.contiguous()
    p1, p2 = cg.tiled_gemm(ar, br), cg.tiled_gemm(ai, bi)
    p3 = cg.tiled_gemm(ar + ai, br + bi)
    karatsuba = torch.complex(p1 - p2, p3 - p1 - p2)
    before = cg.LAUNCHES["tiled_gemm"]
    got = cg.tiled_gemm(a, b)
    assert cg.LAUNCHES["tiled_gemm"] == before + 1
    assert got.dtype == torch.complex64
    torch.testing.assert_close(got, karatsuba, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got, torch.matmul(a, b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.float32])
@pytest.mark.parametrize("seed,nb,nm,nn,nk,size", K2_CARD_CASES)
def test_fused_gemm_bf16_route_on_card(dev, seed, nb, nm, nn, nk, size, dtype):
    """K2's bf16 route against its plain twin within 1e-5 of max|plain|;
    with the operands held as bf16 (pairs) and the output written as
    bf16 the result is that output's rounding."""
    rng = np.random.default_rng(seed)
    f = _random_form(rng, nb, nm, nn, nk, size)
    a, b = _rand(rng, f.a_shape, dtype, dev), _rand(rng, f.b_shape, dtype, dev)
    want = cg.fused_gemm_c64(a.cpu(), b.cpu(), f, precision="bf16").to(dev)
    got = cg.fused_gemm_c64(a, b, f, precision="bf16")
    assert got.dtype == dtype
    assert _rel_plain(got, want) <= 1e-5
    half = cg.fused_gemm_c64(_pairs(a), _pairs(b), f, precision="bf16", out16=True)
    assert half.dtype == torch.bfloat16
    assert torch.equal(cg.widen(half, f.out_shape), cg.widen(_pairs(got), f.out_shape))


def test_chain_bf16_steps_on_card(dev):
    """K3 with per-step precisions (every other step bf16), bf16 slots
    where the consumer reads bf16, a half-width external and a bf16
    output, against its plain twin: each step on the kernel's own carry
    within 1e-5, the whole chain within a bf16 ulp (2^-8)."""
    plan = _amp30_plan(dev)
    ch, forms = _epilogue_chain(plan)
    n = len(forms)
    prec = tuple("bf16" if t % 2 == 0 else "fp32" for t in range(n))
    slot_prec = ["fp32"] * len(ch.slot_elems)
    for t in range(n - 1):
        if prec[t + 1] == "bf16":
            slot_prec[ch.slot_ids[t]] = "bf16"
    for t in range(n - 1):
        if prec[t + 1] != "bf16":
            slot_prec[ch.slot_ids[t]] = "fp32"
    rng = np.random.default_rng(11)
    shapes = [forms[0].a_shape, forms[0].b_shape] + [
        forms[t].b_shape if ch.carry_side[t] == "l" else forms[t].a_shape
        for t in range(1, n)
    ]
    scales = [forms[0].K ** -0.25] * 2 + [f.K ** -0.5 for f in forms[1:]]
    ext = [sc * _rand(rng, s, torch.complex64, dev) for s, sc in zip(shapes, scales)]
    ext[0] = _pairs(ext[0])  # step 0 reads bf16: its external held so
    kw = dict(precisions=prec, slot_prec=tuple(slot_prec))
    # step by step, each on the kernel's own carry (the chain's first t
    # steps): only the order of the sum differs
    carry = None
    for t, f in enumerate(forms):
        got = cg.chain_gemm_c64(ext[:t + 2], forms[:t + 1], ch.carry_side[:t + 1],
                                ch.slot_ids[:t], ch.slot_elems,
                                precisions=prec[:t + 1], slot_prec=tuple(slot_prec))
        if t == 0:
            a, b = ext[0], ext[1]
        else:
            a, b = (carry, ext[t + 1]) if ch.carry_side[t] == "l" else (ext[t + 1], carry)
        want = cg.fused_gemm_c64(cg.widen(a, f.a_shape).cpu(), cg.widen(b, f.b_shape).cpu(),
                                 f, precision=prec[t]).to(dev)
        assert _rel_plain(got, want) <= 1e-5, t
        carry = got
    # the whole chain: a carry rounded to bf16 may land one ulp apart
    got = cg.chain_gemm_c64(ext, forms, ch.carry_side, ch.slot_ids, ch.slot_elems, **kw)
    want = cg.chain_gemm_c64([e.cpu() for e in ext], forms, ch.carry_side,
                             ch.slot_ids, ch.slot_elems, **kw).to(dev)
    assert _rel_plain(got, want) <= 2.0 ** -8
    half = cg.chain_gemm_c64(ext, forms, ch.carry_side, ch.slot_ids, ch.slot_elems,
                             out16=True, **kw)
    assert torch.equal(cg.widen(half, forms[-1].out_shape),
                       cg.widen(_pairs(got), forms[-1].out_shape))


def test_step_peaks_within_plan_on_card(dev):
    """Each dispatch of one epilogue slice of a 20-qubit plan, fp32 and
    auto, allocates no more than the lifetime plan's live set at that
    step (plus 1 MiB of allocator rounding)."""
    from repro_torch.launch.memory_steps import measure

    c = circuits.sycamore_like(4, 5, 10, seed=0)
    for precision in ("fp32", "auto"):
        rec = measure(torch, c, 20, 12, precision=precision)
        worst = max(r["excess"] for r in rec["records"])
        assert worst <= 1 << 20, rec["worst"][:3]


# ------------------------------------------------------------ LM kernels
def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,group,sq,sk,d,causal,q_offset", [
    (8, 1, 128, 128, 64, True, 0),
    (16, 4, 256, 256, 128, True, 0),    # GQA by index
    (4, 2, 128, 384, 32, True, 256),    # chunk with q_offset
    (6, 3, 64, 192, 24, False, 0),      # head dim not a multiple of 16, full
    (2, 1, 64, 64, 8, True, 0),         # the smallest head dim dispatched
    (8, 4, 192, 448, 128, True, 256),   # 64-row tails of the 128 tiles
    (4, 1, 320, 320, 128, True, 0),     # sq % 128 == 64, q_offset 0
    (8, 4, 512, 512, 128, True, 0),     # qwen3-4b's group and head dim
    (4, 1, 64, 1024, 96, True, 960),    # sq < sk, two partial d panels
    (4, 4, 128, 256, 128, False, 0),    # full attention, group 4
])
def test_flash_attention_on_card(dev, dtype, bh, group, sq, sk, d, causal,
                                 q_offset):
    """K4 against its plain version.  fp32: 1e-4 relative to max|plain|
    (another summation order); bf16: 1e-2 (the output's bf16 rounding
    alone is 2^-8)."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(bh + sq + sk + d)
    q = torch.randn(bh, sq, d, generator=g).to(dev, dtype)
    k = torch.randn(bh // group, sk, d, generator=g).to(dev, dtype)
    v = torch.randn(bh // group, sk, d, generator=g).to(dev, dtype)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rel(got, want) <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("lib,kernel,hgmma", [
    ("gemm", "tiled_gemm_kernel", True),  # K1: 3xTF32 and bf16
    ("gemm", "fused_gemm_kernel", True),
    ("flash_attention", "flash_attention_wgmma_kernel", True),
    ("flash_attention", "flash_attention_kernel", False),  # fp32: FFMA
    ("mamba2_ssd", "ssd_chunk_wgmma_kernel", True),
    ("mamba2_ssd", "ssd_chunk_kernel", False),  # the simt route: FFMA
])
def test_wgmma_kernels_issue_hgmma(dev, lib, kernel, hgmma):
    """K1 (each instantiation, the bf16 route's among them), K2 (each instantiation, the bf16
    route's too), K4's bf16 kernel and K5's wgmma kernel run on the
    tensor cores: their SASS holds HGMMA (wgmma); K4's
    fp32 kernel and K5's simt kernel stay on the CUDA cores."""
    from repro_torch.kernels import build

    found = build.kernels_with(lib, kernel, "HGMMA")
    assert found, f"{kernel} not in the {lib} library"
    assert set(found.values()) == {hgmma}, found


@pytest.mark.parametrize("BH,G,C,L,D,S,lo,hi,route,force", [
    (6, 6, 3, 64, 64, 128, 0.01, 0.5, "wgmma", None),  # mamba2-130m cell, G == BH
    (8, 2, 2, 32, 16, 8, 0.01, 0.5, "simt", None),     # head-free groups
    (3, 3, 2, 32, 8, 4, 5.0, 10.0, "simt", None),      # decay overflow above the diagonal
    (24, 1, 8, 64, 64, 128, 0.01, 0.5, "wgmma", None),  # the serve cell: 24 heads, one group
    (40, 4, 8, 64, 64, 128, 0.01, 0.5, "wgmma", None),  # 10 heads a group, 3 a block
    (4, 2, 2, 64, 64, 64, 5.0, 10.0, "wgmma", None),    # overflow at L = 64, S = 64
    (8, 2, 2, 64, 128, 128, 0.01, 0.5, "wgmma", None),  # two head-dim tiles
    (6, 6, 3, 64, 64, 128, 0.01, 0.5, "simt", "simt"),  # the serve shape, forced
])
def test_ssd_chunk_on_card(dev, BH, G, C, L, D, S, lo, hi, route, force):
    """K5 against its plain version, 1e-4 relative (fp32, another
    summation order; 3xTF32 on the wgmma route), through the route the
    shape rule (or ``force``) gives."""
    from repro_torch.kernels import mamba2_ssd as ssd

    rng = np.random.default_rng(BH + L)

    def rnd(shape, sample=rng.standard_normal):
        return torch.from_numpy(np.asarray(sample(size=shape), np.float32)).to(dev)

    x = rnd((BH, C, L, D))
    dt = rnd((BH, C, L), lambda size: rng.uniform(0.1, 1.0, size))
    a = rnd((BH, C, L), lambda size: -rng.uniform(lo, hi, size))
    b, c = rnd((G, C, L, S)), rnd((G, C, L, S))
    before, routes = ssd.LAUNCHES["ssd_chunk"], dict(ssd.SSD_ROUTES)
    got = ssd.ssd_intra_chunk(x, dt, a, b, c, route=force)
    assert ssd.LAUNCHES["ssd_chunk"] == before + 1
    assert ssd.SSD_ROUTES[route] == routes[route] + 1
    want = ssd.ssd_intra_chunk_plain(x, dt, a, b, c)
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        assert torch.isfinite(g_).all()
        assert _rel(g_, w) <= 1e-4


@pytest.mark.parametrize("arch,kernel", [
    ("qwen3-4b", "flash_attention"), ("mamba2-130m", "ssd_chunk"),
])
def test_prefill_on_card_matches_cpu(dev, arch, kernel):
    """The smoke model's prefill through the kernels against the same
    weights and tokens on the CPU (plain versions), bf16: 3e-2 of
    max|logit|."""
    from repro_torch.configs import get_config, smoke_shrink
    from repro_torch.kernels import flash_attention as fa, mamba2_ssd as ssd
    from repro_torch.models import build_model

    cfg = smoke_shrink(get_config(arch))
    model = build_model(cfg, seed=0, device=dev)
    params = {k: v.detach().cpu() for k, v in model.top.tensors().items()}
    params["layers"] = [{k: v.detach().cpu() for k, v in lp.tensors().items()}
                        for lp in model.layers]
    cpu_model = build_model(cfg, params, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(1))
    mod = fa if kernel == "flash_attention" else ssd
    mod.reset_launches()
    _, logits = model.prefill(tokens.to(dev))
    assert mod.LAUNCHES[kernel] == cfg.num_layers
    _, want = cpu_model.prefill(tokens)
    assert _rel(logits.cpu(), want) <= 3e-2


def test_sharded_resumable_multihost_on_card(dev, tmp_path):
    """The slice runners on the card: contract_sharded on one device sums
    in run_all's order (bitwise); listing the card twice, a failed and
    resumed contract_resumable, and contract_multihost with a claim store
    agree with it to the fp32 order of the sums."""
    from repro_torch.core.distributed import (SliceRangeCheckpoint,
                                              contract_resumable,
                                              contract_sharded)
    from repro_torch.distributed import contract_multihost

    c = circuits.random_1d_circuit(9, 8, seed=7)
    tn, arrays = simplify_network(*circuits.circuit_to_network(
        c, bitstring="011010010"))
    plan, _ = plan_compiled(tn, 5, hw=SMALL_HW, use_cache=False)
    n = 1 << plan.num_sliced
    assert n >= 16
    want = plan.contract_all(arrays)
    assert torch.equal(contract_sharded(plan, arrays, [dev]), want)
    scale = float(want.abs().max())
    twice = contract_sharded(plan, arrays, [dev, dev], slice_batch=3)
    assert float((twice - want).abs().max()) <= 1e-6 * scale
    state = SliceRangeCheckpoint(n, set(), np.zeros((), np.complex64))
    with pytest.raises(RuntimeError, match="simulated failure"):
        contract_resumable(plan, arrays, chunk=4, state=state, fail_on={8})
    value, state = contract_resumable(plan, arrays, chunk=3, state=state)
    assert state.done_ids() == set(range(n))
    assert abs(complex(value) - complex(want.cpu())) <= 1e-6 * scale
    res = contract_multihost(plan, arrays, slice_batch=2,
                             checkpoint_dir=str(tmp_path / "run"))
    assert res.complete and res.executed_slices == n
    assert abs(complex(res.value) - complex(want.cpu())) <= 1e-6 * scale
