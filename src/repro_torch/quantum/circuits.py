"""Random quantum circuit generators and circuit → tensor-network lowering.

``sycamore_like``/``zuchongzhi_like`` follow the published RQC recipe:
each cycle applies a random single-qubit gate from {√X, √Y, √W} (never
repeating the previous gate on that qubit) to every qubit, followed by
two-qubit fSim couplers on a cycling pattern of grid edges (ABCDCDAB for
Sycamore, ABCDABCD-like for Zuchongzhi).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Sequence

import numpy as np

from ..core.tensor_network import TensorNetwork
from . import gates


@dataclasses.dataclass
class GateOp:
    name: str
    qubits: tuple[int, ...]
    params: tuple = ()

    def array(self) -> np.ndarray:
        return gates.gate_array(self.name, self.params)


@dataclasses.dataclass
class Circuit:
    num_qubits: int
    ops: list[GateOp]

    def depth_cycles(self) -> int:
        return sum(1 for op in self.ops if op.name == "cycle_marker")


def _grid_edges(rows: int, cols: int) -> dict[str, list[tuple[int, int]]]:
    """Sycamore-style A/B/C/D coupler patterns on a rows×cols grid."""

    def q(r, c):
        return r * cols + c

    pats: dict[str, list[tuple[int, int]]] = {"A": [], "B": [], "C": [], "D": []}
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:  # horizontal
                e = (q(r, c), q(r, c + 1))
                key = ("A", "B")[(r + c) % 2]
                pats[key].append(e)
            if r + 1 < rows:  # vertical
                e = (q(r, c), q(r + 1, c))
                key = ("C", "D")[(r + c) % 2]
                pats[key].append(e)
    return pats


def _random_layers(
    rows: int,
    cols: int,
    cycles: int,
    pattern_order: Sequence[str],
    seed: int,
    twoq_gate: str = "syc",
) -> Circuit:
    n = rows * cols
    rng = random.Random(seed)
    pats = _grid_edges(rows, cols)
    ops: list[GateOp] = []
    last = [None] * n
    names = list(gates.SINGLE_QUBIT_POOL)
    for cyc in range(cycles):
        for qb in range(n):
            choices = [g for g in names if g != last[qb]]
            g = rng.choice(choices)
            last[qb] = g
            ops.append(GateOp(g, (qb,)))
        pat = pattern_order[cyc % len(pattern_order)]
        for a, b in pats[pat]:
            ops.append(GateOp(twoq_gate, (a, b)))
    return Circuit(n, ops)


def sycamore_like(
    rows: int, cols: int, cycles: int, seed: int = 0
) -> Circuit:
    return _random_layers(rows, cols, cycles, "ABCDCDAB", seed)


def zuchongzhi_like(
    rows: int, cols: int, cycles: int, seed: int = 0
) -> Circuit:
    return _random_layers(rows, cols, cycles, "ABCD", seed)


def random_1d_circuit(n: int, cycles: int, seed: int = 0) -> Circuit:
    """1D chain RQC — small enough for statevector cross-checks."""
    rng = random.Random(seed)
    ops: list[GateOp] = []
    last = [None] * n
    names = list(gates.SINGLE_QUBIT_POOL)
    for cyc in range(cycles):
        for qb in range(n):
            g = rng.choice([x for x in names if x != last[qb]])
            last[qb] = g
            ops.append(GateOp(g, (qb,)))
        offset = cyc % 2
        for a in range(offset, n - 1, 2):
            ops.append(GateOp("syc", (a, a + 1)))
    return Circuit(n, ops)


# ----------------------------------------------------------------------
# circuit → tensor network
# ----------------------------------------------------------------------
def circuit_to_network(
    circuit: Circuit,
    bitstring: str | None = None,
    open_final: bool = False,
    open_qubits: Sequence[int] | None = None,
) -> tuple[TensorNetwork, list[np.ndarray]]:
    """Lower a circuit to (TensorNetwork, arrays).

    Initial state |0…0>.  If ``bitstring`` is given the final state is
    projected (closed network, scalar amplitude).  If ``open_final`` the
    final wire indices stay open (statevector-shaped output).

    ``open_qubits`` selects the *partial* projection used for batched
    correlated-amplitude sampling: the listed qubits keep their final wire
    open (one output axis each, ascending qubit order) while every other
    qubit is projected onto its ``bitstring`` value.  One contraction of
    the resulting network yields all ``2^k`` amplitudes that share the
    projected prefix — the paper's batch-per-slice sampling workload.
    """
    n = circuit.num_qubits
    seg = [0] * n  # current wire segment per qubit

    def wire(q: int) -> str:
        return f"q{q}_{seg[q]}"

    tensors: list[list[str]] = []
    arrays: list[np.ndarray] = []
    # initial |0> kets
    for q in range(n):
        tensors.append([wire(q)])
        arrays.append(np.array([1.0, 0.0], dtype=np.complex64))
    for op in circuit.ops:
        arr = op.array()
        if len(op.qubits) == 1:
            (q,) = op.qubits
            old = wire(q)
            seg[q] += 1
            new = wire(q)
            tensors.append([new, old])
            arrays.append(arr)  # (out, in)
        else:
            a, b = op.qubits
            old_a, old_b = wire(a), wire(b)
            seg[a] += 1
            seg[b] += 1
            new_a, new_b = wire(a), wire(b)
            tensors.append([new_a, new_b, old_a, old_b])
            arrays.append(arr.reshape(2, 2, 2, 2))
    open_inds: list[str] = []
    if open_qubits is not None:
        open_set = sorted(set(open_qubits))
        if any(q < 0 or q >= n for q in open_set):
            raise ValueError(f"open_qubits out of range for {n} qubits")
        if bitstring is None:
            bitstring = "0" * n
        assert len(bitstring) == n
        for q in range(n):
            if q in open_set:
                continue
            bra = np.zeros(2, dtype=np.complex64)
            bra[int(bitstring[q])] = 1.0
            tensors.append([wire(q)])
            arrays.append(bra)
        open_inds = [wire(q) for q in open_set]
    elif bitstring is not None:
        assert len(bitstring) == n
        for q in range(n):
            bra = np.zeros(2, dtype=np.complex64)
            bra[int(bitstring[q])] = 1.0
            tensors.append([wire(q)])
            arrays.append(bra)
    elif open_final:
        open_inds = [wire(q) for q in range(n)]
    return TensorNetwork(tensors, open_inds=open_inds), arrays
