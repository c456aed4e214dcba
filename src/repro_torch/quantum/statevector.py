"""Dense statevector simulator in PyTorch — the correctness oracle for
the contraction executor, on the card up to 30 qubits (a 2^30 complex64
state is 8 GiB).

The state is kept flat.  Each gate is applied on a view of rank at most
5, ``(2^x, 2, 2^y)`` for one qubit or ``(2^x, 2, 2^y, 2, 2^z)`` for two,
never on a ``[2] * n`` tensor: CUDA's elementwise kernels take at most 25
dimensions.  Qubit 0 is the most significant bit of the flat index, as
in the reference's ``(2,) * n`` layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .circuits import Circuit


def _apply_1q(psi: torch.Tensor, n: int, q: int, g: np.ndarray) -> None:
    v = psi.view(1 << q, 2, 1 << (n - q - 1))
    s0, s1 = v[:, 0, :], v[:, 1, :]
    g = [[complex(x) for x in row] for row in g]
    new0 = g[0][0] * s0 + g[0][1] * s1
    new1 = g[1][0] * s0 + g[1][1] * s1
    s0.copy_(new0)
    s1.copy_(new1)


def _apply_2q(psi: torch.Tensor, n: int, a: int, b: int, g: np.ndarray) -> None:
    # g[a_out, b_out, a_in, b_in]; the view's axes are (lo, hi) qubits
    g4 = g.reshape(2, 2, 2, 2)
    lo, hi = min(a, b), max(a, b)
    if a > b:  # view axes are (b, a): swap both gate index pairs
        g4 = g4.transpose(1, 0, 3, 2)
    v = psi.view(1 << lo, 2, 1 << (hi - lo - 1), 2, 1 << (n - hi - 1))
    src = [[v[:, i, :, j, :] for j in range(2)] for i in range(2)]
    new = [
        [
            sum(
                complex(g4[i, j, k, l]) * src[k][l]
                for k in range(2)
                for l in range(2)
            )
            for j in range(2)
        ]
        for i in range(2)
    ]
    for i in range(2):
        for j in range(2):
            src[i][j].copy_(new[i][j])


def simulate(circuit: Circuit, device="cuda") -> torch.Tensor:
    """Flat statevector (length 2^n, complex64) of ``circuit`` applied
    to |0…0>."""
    from ..core.executor import resolve_device

    dev = resolve_device(device)
    n = circuit.num_qubits
    psi = torch.zeros(1 << n, dtype=torch.complex64, device=dev)
    psi[0] = 1.0
    for op in circuit.ops:
        arr = op.array()
        if len(op.qubits) == 1:
            _apply_1q(psi, n, op.qubits[0], arr)
        else:
            _apply_2q(psi, n, op.qubits[0], op.qubits[1], arr)
    return psi


def amplitude(circuit: Circuit, bitstring: str, device="cuda") -> complex:
    psi = simulate(circuit, device=device)
    return complex(psi[int(bitstring, 2)].item())


def probabilities(circuit: Circuit, device="cuda") -> np.ndarray:
    psi = simulate(circuit, device=device)
    return (psi.abs() ** 2).cpu().numpy()
