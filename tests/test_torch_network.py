"""The port's circuits, networks, simplification and statevector against
the JAX reference package on the same inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.executor import simplify_network as ref_simplify  # noqa: E402
from repro.quantum import circuits as ref_circuits  # noqa: E402
from repro.quantum import gates as ref_gates  # noqa: E402
from repro.quantum import statevector as ref_sv  # noqa: E402
from repro.sampling.batch import open_batch_network as ref_open  # noqa: E402

from repro_torch.core.executor import simplify_network  # noqa: E402
from repro_torch.quantum import circuits, gates, statevector  # noqa: E402
from repro_torch.sampling.batch import open_batch_network  # noqa: E402

CIRCUITS = [
    ("syc", (3, 3, 6)),
    ("syc", (4, 4, 8)),
    ("zcz", (3, 4, 5)),
    ("1d", (8, 6)),
]


def _make(pkg, kind, args, seed):
    if kind == "syc":
        return pkg.sycamore_like(*args, seed=seed)
    if kind == "zcz":
        return pkg.zuchongzhi_like(*args, seed=seed)
    return pkg.random_1d_circuit(*args, seed=seed)


def _same_network(tn_a, arrs_a, tn_b, arrs_b):
    assert [list(t) for t in tn_a.inputs] == [list(t) for t in tn_b.inputs]
    assert list(tn_a.open_inds) == list(tn_b.open_inds)
    assert dict(tn_a.ind_sizes) == dict(tn_b.ind_sizes)
    assert tn_a.masks == tn_b.masks
    assert len(arrs_a) == len(arrs_b)
    for x, y in zip(arrs_a, arrs_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(ref_gates.SINGLE_QUBIT_POOL) + ["syc"])
def test_gate_arrays_identical(name):
    np.testing.assert_array_equal(
        gates.gate_array(name), ref_gates.gate_array(name)
    )


@pytest.mark.parametrize("kind,args", CIRCUITS)
@pytest.mark.parametrize("seed", [0, 3])
def test_circuits_identical(kind, args, seed):
    a = _make(ref_circuits, kind, args, seed)
    b = _make(circuits, kind, args, seed)
    assert a.num_qubits == b.num_qubits
    assert [(o.name, o.qubits, o.params) for o in a.ops] == [
        (o.name, o.qubits, o.params) for o in b.ops
    ]


@pytest.mark.parametrize("kind,args", CIRCUITS)
def test_network_and_simplify_identical(kind, args):
    ref_c = _make(ref_circuits, kind, args, 1)
    c = _make(circuits, kind, args, 1)
    bits = "".join(
        str(b) for b in np.random.default_rng(5).integers(0, 2, c.num_qubits)
    )
    tn_r, arr_r = ref_circuits.circuit_to_network(ref_c, bitstring=bits)
    tn_p, arr_p = circuits.circuit_to_network(c, bitstring=bits)
    _same_network(tn_r, arr_r, tn_p, arr_p)
    _same_network(*ref_simplify(tn_r, arr_r), *simplify_network(tn_p, arr_p))


def test_open_batch_network_identical():
    ref_c = ref_circuits.sycamore_like(3, 3, 6, seed=2)
    c = circuits.sycamore_like(3, 3, 6, seed=2)
    base = "010110010"
    _same_network(*ref_open(ref_c, base, (6, 8)), *open_batch_network(c, base, (6, 8)))


@pytest.mark.parametrize("kind,args", [("syc", (3, 3, 6)), ("1d", (8, 6))])
def test_statevector_matches_reference(kind, args):
    """Gates applied on rank-≤5 views give the reference's state to fp32
    precision (complex64 in both)."""
    ref_c = _make(ref_circuits, kind, args, 0)
    c = _make(circuits, kind, args, 0)
    want = np.asarray(ref_sv.simulate(ref_c)).reshape(-1)
    got = statevector.simulate(c, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        statevector.probabilities(c, device="cpu"),
        ref_sv.probabilities(ref_c), rtol=1e-5, atol=1e-7,
    )
    bits = "1" * c.num_qubits
    assert abs(
        statevector.amplitude(c, bits, device="cpu")
        - ref_sv.amplitude(ref_c, bits)
    ) < 1e-6


def test_statevector_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        statevector.simulate(circuits.random_1d_circuit(4, 2))
