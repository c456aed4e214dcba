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
    (64, 1, 512, 512, 128, True, 0),    # deepseek-moe-16b's serve prefill (MHA)
    (256, 8, 512, 512, 128, True, 0),   # qwen2-vl-72b's serve prefill, group 8
    (160, 5, 512, 512, 128, True, 0),   # llama4-scout-17b-a16e's, group 5
    (10, 5, 128, 384, 64, True, 256),   # group 5, chunk with q_offset
    (64, 1, 512, 512, 64, False, 0),    # seamless-m4t-medium's encoder
    (64, 1, 512, 1024, 64, False, 0),   # its cross-attention, sq != sk
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [112, 128])
@pytest.mark.parametrize("bh,group,sq,sk,q_offset,window", [
    (8, 2, 512, 512, 0, 64),          # a window of 64 at s 512
    (2, 1, 8192, 8192, 0, 4096),      # zamba2-7b's window at its prompt
    (4, 2, 256, 1024, 768, 300),      # a chunk with q_offset, window off the tiles
])
def test_flash_attention_window_on_card(dev, dtype, d, bh, group, sq, sk,
                                        q_offset, window):
    """K4's forward kernels with a sliding window against the plain
    version, at zamba2-7b's head dim 112 (the bf16 kernel's second
    64-column panel half filled by TMA's zeros) and at 128: fp32 1e-4 of
    max|plain|, bf16 1e-2 (the output's rounding alone is 2^-8); each
    launch counted as windowed on its dtype's kernel."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(bh + sq + d + window)
    q = torch.randn(bh, sq, d, generator=g).to(dev, dtype)
    k = torch.randn(bh // group, sk, d, generator=g).to(dev, dtype)
    v = torch.randn(bh // group, sk, d, generator=g).to(dev, dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    before = dict(fa.WINDOW_ROUTES)
    got = fa.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                             window=window)
    assert fa.WINDOW_ROUTES[route] == before[route] + 1
    want = fa.flash_attention_plain(q, k, v, causal=True, q_offset=q_offset,
                                    window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("lib,kernel,hgmma", [
    ("gemm", "tiled_gemm_kernel", True),  # K1: 3xTF32 and bf16
    ("gemm", "fused_gemm_kernel", True),
    ("flash_attention", "flash_attention_wgmma_kernel", True),
    ("flash_attention", "flash_attention_kernel", False),  # fp32: FFMA
    ("mamba2_ssd", "ssd_chunk_wgmma_kernel", True),
    ("mamba2_ssd", "ssd_chunk_kernel", False),  # the simt route: FFMA
    ("mamba2_ssd", "ssd_chunk_bwd_wgmma_kernel", True),  # K5 bwd, wgmma route
    ("mamba2_ssd", "ssd_chunk_bwd_kernel", False),  # its simt route
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


@pytest.mark.parametrize("kernel,hmma", [
    ("fa_bwd_mma_kernel", True),   # K4 bwd, bf16 route: mma.sync
    ("fa_bwd_dkdv_kernel", False),  # its simt route: FFMA
    ("fa_bwd_dq_kernel", False),
])
def test_mma_kernels_issue_hmma(dev, kernel, hmma):
    """K4's bf16 backward runs its products on the tensor cores through
    mma.sync (HMMA in every instantiation's SASS); the simt route's
    kernels stay on the CUDA cores."""
    from repro_torch.kernels import build

    found = build.kernels_with("flash_attention", kernel, "HMMA")
    assert found, f"{kernel} not in the flash_attention library"
    assert set(found.values()) == {hmma}, found


@pytest.mark.parametrize("BH,G,C,L,D,S,lo,hi,route,force", [
    (6, 6, 3, 64, 64, 128, 0.01, 0.5, "wgmma", None),  # mamba2-130m cell, G == BH
    (8, 2, 2, 32, 16, 8, 0.01, 0.5, "simt", None),     # head-free groups
    (3, 3, 2, 32, 8, 4, 5.0, 10.0, "simt", None),      # decay overflow above the diagonal
    (24, 1, 8, 64, 64, 128, 0.01, 0.5, "wgmma", None),  # the serve cell: 24 heads, one group
    (40, 4, 8, 64, 64, 128, 0.01, 0.5, "wgmma", None),  # 10 heads a group, 3 a block
    (4, 2, 2, 64, 64, 64, 5.0, 10.0, "wgmma", None),    # overflow at L = 64, S = 64
    (8, 2, 2, 64, 128, 128, 0.01, 0.5, "wgmma", None),  # two head-dim tiles
    (6, 6, 3, 64, 64, 128, 0.01, 0.5, "simt", "simt"),  # the serve shape, forced
    # zamba2-7b at 8192 tokens: 112 heads in one B/C group, state 64,
    # 128 chunks (one block takes the whole group)
    (112, 1, 128, 64, 64, 64, 0.01, 0.5, "wgmma", None),
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


FLASH_BWD_CASES = [
    (8, 1, 128, 128, 64, True, 0),
    (16, 4, 256, 256, 128, True, 0),    # GQA: dK/dV summed over 4 heads
    (4, 2, 128, 384, 32, True, 256),    # chunk with q_offset
    (6, 3, 64, 192, 24, False, 0),      # full attention, odd head dim
    (8, 4, 512, 512, 128, True, 0),     # qwen3-4b's group and head dim
    (4, 1, 64, 256, 16, True, 0),       # keys no query sees: zero dK/dV
    (64, 1, 512, 512, 64, False, 0),    # seamless-m4t-medium's encoder
    (64, 1, 512, 1024, 64, False, 0),   # its cross-attention, sq != sk
    (128, 8, 512, 512, 128, True, 0),   # qwen2-vl-72b's training, group 8
    (40, 5, 512, 512, 128, True, 0),    # llama4-scout-17b-a16e's group 5
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,group,sq,sk,d,causal,q_offset", FLASH_BWD_CASES)
def test_flash_attention_bwd_on_card(dev, dtype, bh, group, sq, sk, d, causal,
                                     q_offset):
    """K4's forward logsumexp and its backward kernels against the plain
    versions on the same inputs (the kernel forward's o and lse): fp32
    1e-4 of max|plain| (another summation order), bf16 2e-2 (bf16
    outputs, 2^-8 each); two runs give the same bits (no atomics)."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(bh + sq + sk + d + 1)
    q = torch.randn(bh, sq, d, generator=g).to(dev, dtype)
    k = torch.randn(bh // group, sk, d, generator=g).to(dev, dtype)
    v = torch.randn(bh // group, sk, d, generator=g).to(dev, dtype)
    do = torch.randn(bh, sq, d, generator=g).to(dev, dtype)
    o, lse = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                return_lse=True)
    _, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                           q_offset=q_offset, return_lse=True)
    before = fa.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 q_offset=q_offset)
    assert fa.LAUNCHES["flash_attention_bwd"] == before + 1
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   q_offset=q_offset)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        q_offset=q_offset)
    torch.cuda.synchronize()
    assert float((lse - want_lse).abs().max()) <= 1e-3
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for x, y, z in zip(got, want, again):
        assert x.dtype == dtype and torch.isfinite(x).all()
        assert _rel(x, y) <= tol
        assert torch.equal(x, z)


@pytest.mark.parametrize("route", ["mma", "simt"])
@pytest.mark.parametrize("bh,group,sq,sk,d,causal,q_offset", FLASH_BWD_CASES)
def test_flash_attention_bwd_routes_on_card(dev, route, bh, group, sq, sk, d,
                                            causal, q_offset):
    """Each route of K4's bf16 backward (the tensor-core one the dtype
    rule picks, and the FFMA one forced) against the plain version on the
    same inputs, 2e-2 of max|plain| (bf16 outputs, and P, dS rounded to
    bf16 as operands on the mma route); the launch is counted on its
    route, and two runs give the same bits."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(bh + sq + sk + d + 2)
    q = torch.randn(bh, sq, d, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(bh // group, sk, d, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(bh // group, sk, d, generator=g).to(dev, torch.bfloat16)
    do = torch.randn(bh, sq, d, generator=g).to(dev, torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                return_lse=True)
    force = None if route == fa.bwd_route(torch.bfloat16) else route
    before = dict(fa.BWD_ROUTES)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 q_offset=q_offset, route=force)
    assert fa.BWD_ROUTES[route] == before[route] + 1
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   q_offset=q_offset, route=force)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        q_offset=q_offset)
    torch.cuda.synchronize()
    for x, y, z in zip(got, want, again):
        assert x.dtype == torch.bfloat16 and torch.isfinite(x).all()
        assert _rel(x, y) <= 2e-2
        assert torch.equal(x, z)


FLASH_BWD_WINDOW_CASES = [
    (8, 1, 256, 256, 0, 100),      # a window no multiple of 64
    (8, 4, 192, 320, 128, 64),     # GQA group 4, q_offset, a tile's window
    (4, 2, 256, 256, 0, 1),        # one key a query: dq is 0
    (4, 1, 128, 128, 0, 500),      # a window longer than the keys
    (4, 1, 64, 256, 192, 70),      # keys no band reaches: zero dK/dV
]


@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("route", ["mma", "simt"])
@pytest.mark.parametrize("bh,group,sq,sk,q_offset,window",
                         FLASH_BWD_WINDOW_CASES)
def test_flash_attention_bwd_window_on_card(dev, route, d, bh, group, sq, sk,
                                            q_offset, window):
    """K4's backward with a sliding window, each route against the plain
    version on the same inputs (the kernel forward's o and lse): mma on
    bf16 2e-2 of max|plain| (bf16 outputs, P and dS bf16 operands), simt
    on fp32 1e-4 (another summation order); the launch is counted as
    windowed on its route, and two runs give the same bits.  d 112 is
    zamba2-7b's head dim (the mma route's 128-column tiles, zero-filled
    past it)."""
    from repro_torch.kernels import flash_attention as fa

    dtype = torch.bfloat16 if route == "mma" else torch.float32
    g = torch.Generator().manual_seed(bh + sq + sk + d + window)
    q = torch.randn(bh, sq, d, generator=g).to(dev, dtype)
    k = torch.randn(bh // group, sk, d, generator=g).to(dev, dtype)
    v = torch.randn(bh // group, sk, d, generator=g).to(dev, dtype)
    do = torch.randn(bh, sq, d, generator=g).to(dev, dtype)
    kw = dict(causal=True, q_offset=q_offset, window=window)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    before = dict(fa.BWD_WINDOW_ROUTES)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fa.BWD_WINDOW_ROUTES[route] == before[route] + 1
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    tol = 2e-2 if route == "mma" else 1e-4
    for i, (x, y, z) in enumerate(zip(got, want, again)):
        assert x.dtype == dtype and torch.isfinite(x).all()
        # at window 1 each softmax has one key, so dS, dq and dk are 0
        # but for rounding on both sides: there they are held against
        # max|dv|
        ref = want[2] if window == 1 and i < 2 else y
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol * float(ref.float().abs().max())
        assert torch.equal(x, z)
    hidden = q_offset - window + 1  # the keys before the first query's band
    if hidden > 0:
        assert not got[1][:, :hidden].any() and not got[2][:, :hidden].any()


def test_moe_train_steps_repeat_bitwise_on_card(dev):
    """Two training steps of deepseek-moe-16b's smoke shrink (bf16, a
    dense layer then an MoE layer), run twice from the same seed, give
    the same losses and grad norms bit for bit: the dispatch's backward
    writes each kept gradient once, and K4's backward has no atomics."""
    from repro_torch.configs import get_config, smoke_shrink
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import train_batch, train_dataset
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = smoke_shrink(get_config("deepseek-moe-16b"))
    ds = train_dataset(cfg, 128, 4, seed=0)
    ocfg = opt.OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                               total_steps=2)

    def run():
        model = build_model(cfg, seed=0, device=dev)
        state, step = init_state(model, ocfg), make_train_step(model, ocfg)
        out = []
        for i in range(2):
            state, met = step(state, train_batch(cfg, ds, i))
            out.append((float(met["loss"]), float(met["grad_norm"])))
        return out

    fa.reset_launches()
    first = run()
    assert fa.LAUNCHES["flash_attention_bwd"] > 0
    assert first == run()
    assert all(np.isfinite(x) for pair in first for x in pair)


@pytest.mark.parametrize("BH,G,C,L,D,S,lo,hi", [
    (6, 6, 3, 64, 64, 128, 0.01, 0.5),   # mamba2-130m cell, G == BH
    (96, 4, 8, 64, 64, 128, 0.01, 0.5),  # the training shape: 24 heads a group
    (8, 2, 2, 32, 16, 8, 0.01, 0.5),     # head-free groups, small
    (3, 3, 2, 32, 8, 4, 5.0, 10.0),      # decay overflow above the diagonal
    (4, 2, 2, 64, 64, 64, 5.0, 10.0),
])
def test_ssd_chunk_bwd_on_card(dev, BH, G, C, L, D, S, lo, hi):
    """K5's backward kernel against its plain version, 1e-4 of
    max|plain| (fp32, another summation order), finite under decays that
    overflow above the diagonal; two runs give the same bits."""
    from repro_torch.kernels import mamba2_ssd as ssd

    rng = np.random.default_rng(BH + L + S)

    def rnd(shape, sample=rng.standard_normal):
        return torch.from_numpy(np.asarray(sample(size=shape), np.float32)).to(dev)

    x = rnd((BH, C, L, D))
    dt = rnd((BH, C, L), lambda size: rng.uniform(0.1, 1.0, size))
    a = rnd((BH, C, L), lambda size: -rng.uniform(lo, hi, size))
    b, c = rnd((G, C, L, S)), rnd((G, C, L, S))
    gy, gst = rnd((BH, C, L, D)), rnd((BH, C, S, D))
    before = ssd.LAUNCHES["ssd_chunk_bwd"]
    got = ssd.ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst)
    assert ssd.LAUNCHES["ssd_chunk_bwd"] == before + 1
    again = ssd.ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst)
    want = ssd.ssd_intra_chunk_bwd_plain(x, dt, a, b, c, gy, gst)
    torch.cuda.synchronize()
    for x_, y_, z_ in zip(got, want, again):
        assert x_.shape == y_.shape and torch.isfinite(x_).all()
        assert _rel(x_, y_) <= 1e-4
        assert torch.equal(x_, z_)


SSD_BWD_ROUTE_CASES = [
    (6, 6, 3, 64, 64, 128, 0.01, 0.5),    # G == BH: one head a group
    (96, 4, 8, 64, 64, 128, 0.01, 0.5),   # the training shape: 6 heads a block
    (24, 1, 8, 64, 64, 128, 0.01, 0.5),   # one group of 24 heads
    (40, 4, 8, 64, 64, 128, 5.0, 10.0),   # 10 heads a group, overflowing decays
    (4, 2, 2, 64, 64, 64, 5.0, 10.0),     # S = 64, overflowing decays
]


@pytest.mark.parametrize("route,BH,G,C,L,D,S,lo,hi", [
    (route, *case) for case in SSD_BWD_ROUTE_CASES for route in ("wgmma", "simt")
] + [
    # two head-dim slices: the simt kernel's cell (315 KB) does not fit
    ("wgmma", 8, 2, 2, 64, 128, 128, 0.01, 0.5),
])
def test_ssd_chunk_bwd_routes_on_card(dev, route, BH, G, C, L, D, S, lo, hi):
    """Each route of K5's backward at shapes the wgmma rule takes (the
    3xTF32 one the rule picks, the FFMA one forced) against the plain
    version, 1e-4 of max|plain| (fp32, another summation order), finite
    under decays that overflow above the diagonal; the launch is counted
    on its route, and two runs give the same bits."""
    from repro_torch.kernels import mamba2_ssd as ssd

    rng = np.random.default_rng(BH + D + S + 7)

    def rnd(shape, sample=rng.standard_normal):
        return torch.from_numpy(np.asarray(sample(size=shape), np.float32)).to(dev)

    x = rnd((BH, C, L, D))
    dt = rnd((BH, C, L), lambda size: rng.uniform(0.1, 1.0, size))
    a = rnd((BH, C, L), lambda size: -rng.uniform(lo, hi, size))
    b, c = rnd((G, C, L, S)), rnd((G, C, L, S))
    gy, gst = rnd((BH, C, L, D)), rnd((BH, C, S, D))
    assert ssd.ssd_route(L, D, S) == "wgmma"
    force = None if route == "wgmma" else route
    before = dict(ssd.SSD_BWD_ROUTES)
    got = ssd.ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst, route=force)
    assert ssd.SSD_BWD_ROUTES[route] == before[route] + 1
    again = ssd.ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst, route=force)
    want = ssd.ssd_intra_chunk_bwd_plain(x, dt, a, b, c, gy, gst)
    torch.cuda.synchronize()
    for x_, y_, z_ in zip(got, want, again):
        assert x_.shape == y_.shape and torch.isfinite(x_).all()
        assert _rel(x_, y_) <= 1e-4
        assert torch.equal(x_, z_)


def test_fp64_refused_on_card(dev):
    """fp64 takes the plain versions on the CPU only: on the card K4's
    forward and backward and K5 refuse it before any launch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd

    def z(*shape):
        return torch.zeros(*shape, dtype=torch.float64, device=dev)

    fa.reset_launches()
    ssd.reset_launches()
    with pytest.raises(TypeError):
        fa.flash_attention(z(4, 64, 16), z(2, 64, 16), z(2, 64, 16))
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(z(4, 64, 16), z(2, 64, 16), z(2, 64, 16),
                               z(4, 64, 16), z(4, 64), z(4, 64, 16))
    with pytest.raises(TypeError):
        ssd.ssd_intra_chunk(z(4, 2, 64, 64), z(4, 2, 64), z(4, 2, 64),
                            z(1, 2, 64, 64), z(1, 2, 64, 64))
    assert set(fa.LAUNCHES.values()) == set(ssd.LAUNCHES.values()) == {0}


def test_autograd_functions_launch_backward_kernels(dev):
    """ops.attention and ops.ssd_scan under autograd on the card: the
    backward kernels run (no plain version), and the gradients match the
    same graph on the CPU (fp32, 1e-4 of max|grad|)."""
    from repro_torch.kernels import flash_attention as fa, mamba2_ssd as ssd
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 128, 4, 32, generator=g)
    k, v = (torch.randn(2, 128, 2, 32, generator=g) for _ in range(2))
    x = torch.randn(6, 128, 16, generator=g)
    dt = 0.1 + torch.rand(6, 128, generator=g)
    a = -0.5 * torch.rand(6, 128, generator=g)
    b, c = (torch.randn(2, 128, 8, generator=g) for _ in range(2))

    def grads(device):
        ins = [t.to(device).requires_grad_() for t in (q, k, v, x, dt, a, b, c)]
        o = ops.attention(*ins[:3], causal=True)
        y, h = ops.ssd_scan(*ins[3:], chunk=64)
        (o.square().sum() + y.square().sum() + h.sum()).backward()
        return [t.grad.cpu() for t in ins]

    fa.reset_launches()
    ssd.reset_launches()
    card = grads(dev)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd"] == 1
    assert ssd.LAUNCHES["ssd_chunk_bwd"] == 1
    for got, want in zip(card, grads("cpu")):
        assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("arch,kernel", [
    ("qwen3-4b", "flash_attention"), ("mamba2-130m", "ssd_chunk"),
    ("deepseek-moe-16b", "flash_attention"), ("qwen2-vl-72b", "flash_attention"),
])
def test_prefill_on_card_matches_cpu(dev, arch, kernel):
    """The smoke model's prefill through the kernels against the same
    weights and prompt on the CPU (plain versions), bf16: 3e-2 of
    max|logit|."""
    from repro_torch.configs import get_config, smoke_shrink
    from repro_torch.kernels import flash_attention as fa, mamba2_ssd as ssd
    from repro_torch.launch.decode_demo import prefill, prompt_inputs
    from repro_torch.models import build_model

    cfg = smoke_shrink(get_config(arch))
    model = build_model(cfg, seed=0, device=dev)
    params = {k: v.detach().cpu() for k, v in model.top.tensors().items()}
    params["layers"] = [{k: v.detach().cpu() for k, v in lp.tensors().items()}
                        for lp in model.layers]
    cpu_model = build_model(cfg, params, device="cpu")
    inputs = prompt_inputs(cfg, 2, 128, torch.Generator().manual_seed(1))
    mod = fa if kernel == "flash_attention" else ssd
    mod.reset_launches()
    _, logits = prefill(model, {k: v.to(dev) for k, v in inputs.items()})
    assert mod.LAUNCHES[kernel] == cfg.num_layers
    _, want = prefill(cpu_model, inputs)
    assert _rel(logits.cpu(), want) <= 3e-2


def _encdec_pair(dev, dtype):
    """seamless-m4t-medium's shrink (2 + 2 layers) on the card and on the
    CPU with the same weights in ``dtype``."""
    from repro_torch.configs import get_config, smoke_shrink
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    cfg = smoke_shrink(get_config("seamless-m4t-medium"))
    params = tree_map(lambda t: t.detach().cpu().to(dtype),
                      build_model(cfg, seed=0, device=dev).param_tree())
    return (build_model(cfg, params, device=dev),
            build_model(cfg, params, device="cpu"))


def test_encdec_prefill_on_card_counts_noncausal_launches(dev, monkeypatch):
    """The encoder-decoder shrink's bf16 prefill on 256 frames and 128
    tokens: 6 K4 launches, all on the wgmma kernel, 4 of them non-causal
    (2 encoder layers, 2 cross-attentions, sq 128 on sk 256); its logits
    within 3e-2 of max|logit| of the CPU's on the same weights, the CPU
    taking the card's attention inputs (at the reference's init the
    attention is near hard: one bf16 rounding of q or k moves a score by
    units, and the free runs part by half of max|logit|)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L

    model, cpu_model = _encdec_pair(dev, torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 128), generator=g)
    embeds = torch.randn(2, 256, model.cfg.d_model, generator=g)
    attention, card_inputs = L.blockwise_attention, []

    def recorded(q, k, v, **kw):
        card_inputs.append((q.cpu(), k.cpu(), v.cpu()))
        return attention(q, k, v, **kw)

    monkeypatch.setattr(L, "blockwise_attention", recorded)
    fa.reset_launches()
    _, logits = model.prefill(toks.to(dev), embeds=embeds.to(dev))
    assert fa.LAUNCHES["flash_attention"] == 6
    assert fa.FWD_ROUTES == {"wgmma": 6, "simt": 0}
    assert fa.NONCAUSAL == {"wgmma": 4, "simt": 0}
    replay = iter(card_inputs)
    monkeypatch.setattr(L, "blockwise_attention",
                        lambda q, k, v, **kw: attention(*next(replay), **kw))
    _, want = cpu_model.prefill(toks, embeds=embeds)
    assert next(replay, None) is None
    assert _rel(logits.cpu(), want) <= 3e-2


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "simt")])
def test_encdec_train_step_on_card_counts_noncausal_backward(dev, dtype,
                                                             route):
    """One training step of the encoder-decoder shrink (256 frames, 128
    tokens): 6 K4 backward
    launches on the dtype's route, 4 of them non-causal (the encoder's
    and the cross-attention's, whose dK and dV reach the encoder); the
    loss within 1e-3 (fp32) or 3e-2 (bf16) of the CPU's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import init_state, make_train_step

    model, cpu_model = _encdec_pair(dev, dtype)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, size=(1, 129), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "embeds": rng.normal(size=(1, 256, 64)).astype(np.float32)}
    ocfg = opt.OptimizerConfig(learning_rate=1e-4, warmup_steps=0)
    fa.reset_launches()
    _, met = make_train_step(model, ocfg)(init_state(model, ocfg), batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd"] == 6
    assert fa.BWD_ROUTES[route] == 6
    assert fa.BWD_NONCAUSAL[route] == 4
    _, want = make_train_step(cpu_model, ocfg)(init_state(cpu_model, ocfg),
                                               batch)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    assert abs(float(met["loss"]) - float(want["loss"])) <= tol * abs(
        float(want["loss"]))
    assert np.isfinite(float(met["grad_norm"]))


def _hybrid_pair(dev, dtype):
    """zamba2-7b's shrink at 7 layers (one group of 6 and the shared
    block, one tail layer) with a window of 96, on the card and on the
    CPU with the same weights in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_shrink
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(smoke_shrink(get_config("zamba2-7b")),
                              num_layers=7, attn_every=6, window=96)
    model = build_model(cfg, seed=0, device=dev)
    params = tree_map(lambda t: t.detach().cpu().to(dtype),
                      model.param_tree())
    return (build_model(cfg, params, device=dev),
            build_model(cfg, params, device="cpu"))


def test_hybrid_prefill_and_decode_on_card_match_cpu(dev):
    """The hybrid in fp32 on a prompt of 256: the window of 96 binds in
    prefill and the ring wraps on the S % window != 0 side in decode.
    Card against the CPU, prefill and two decode steps, 1e-3 of
    max|logit|; the shared block's prefill launches the windowed K4
    once, on the FFMA kernel."""
    from repro_torch.kernels import flash_attention as fa

    model, cpu_model = _hybrid_pair(dev, torch.float32)
    g = torch.Generator().manual_seed(1)
    S = 256
    toks = torch.randint(0, model.cfg.vocab_size, (2, S + 2), generator=g)
    fa.reset_launches()
    cache, logits = model.prefill(toks[:, :S].to(dev), max_len=S + 2)
    assert fa.WINDOW_ROUTES["simt"] == fa.LAUNCHES["flash_attention"] == 1
    cpu_cache, want = cpu_model.prefill(toks[:, :S], max_len=S + 2)
    assert _rel(logits.cpu(), want) <= 1e-3
    for i in range(2):
        tok = toks[:, S + i:S + i + 1]
        logits, cache = model.decode_step(cache, tok.to(dev), S + i)
        want, cpu_cache = cpu_model.decode_step(cpu_cache, tok, S + i)
        assert _rel(logits.cpu(), want) <= 1e-3


def test_hybrid_bf16_blocks_on_card_match_cpu(dev):
    """The hybrid in bf16, block by block: each block on the card from
    the CPU's input to it (the shared block through the windowed wgmma
    K4), its output within 3e-2 of max|value| of the CPU's.  End to end
    the reference's init makes the shared block's attention hard (wq's
    and wk's fan-in is the head count), which amplifies single bf16
    roundings far past that (0.37 of max|logit| on the H100)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.ssm_model import mamba_block

    model, cpu_model = _hybrid_pair(dev, torch.bfloat16)
    cfg = model.cfg
    g = torch.Generator().manual_seed(1)
    S = 256
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=g)
    card, host = model.param_tree(), cpu_model.param_tree()
    h = host["embed"][toks]
    pos = torch.arange(S).expand(2, S)
    fa.reset_launches()
    for j in range(cfg.num_layers):
        want = mamba_block(cfg, host["layers"][j], h)[0]
        got = mamba_block(cfg, card["layers"][j], h.to(dev))[0]
        assert _rel(got.cpu(), want) <= 3e-2, j
        h = want
        if model._group_after(j) is not None:
            want = cpu_model._shared_attn(host["shared"], h, pos)[0]
            got = model._shared_attn(card["shared"], h.to(dev), pos.to(dev))[0]
            assert _rel(got.cpu(), want) <= 3e-2, j
            h = want
    assert fa.WINDOW_ROUTES["wgmma"] == fa.LAUNCHES["flash_attention"] == 1


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
def test_moe_layer_on_card_matches_cpu(dev, dispatch):
    """The MoE layer on the card, fp32 with TF32 off, at deepseek-moe-16b's
    routing (64 experts, top 6) and a skewed router that drops slots:
    the same routing as on the CPU, outputs within 1e-4 of max|y|, aux
    within 1e-6; and the layer makes no host synchronisation."""
    from repro_torch.core.executor import exact_fp32_matmul
    from repro_torch.models import layers as L

    exact_fp32_matmul()
    g = torch.Generator().manual_seed(0)
    T, D, E, F, k = 512, 256, 64, 96, 6
    x = torch.randn(2, T // 2, D, generator=g)
    x[..., 0] = 1 + x[..., 0].abs()
    router = 0.05 * torch.randn(D, E, generator=g)
    router[0] += torch.linspace(1.0, 0.0, E)
    ws = [torch.randn(E, a, b, generator=g) / a ** 0.5
          for a, b in ((D, F), (D, F), (F, D))]
    want, want_aux = L.moe_layer(x, router, *ws, top_k=k, dispatch=dispatch)
    route = L.moe_route(x, router, k, dispatch=dispatch)
    args = [t.to(dev) for t in (x, router, *ws)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = L.moe_layer(*args, top_k=k, dispatch=dispatch)
        card_route = L.moe_route(args[0], args[1], k, dispatch=dispatch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool((~route[3]).any())  # slots were dropped
    for a, b in zip(card_route[2:5], route[2:5]):
        assert torch.equal(a.cpu(), b)
    assert _rel(got.cpu(), want) <= 1e-4
    assert abs(float(aux) - float(want_aux)) <= 1e-6


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
