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


@pytest.mark.parametrize("B,M,N,K", [(1, 100, 70, 33), (3, 64, 128, 16), (1, 1, 1, 1)])
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
