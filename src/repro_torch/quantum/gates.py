"""Quantum gate tensor library (numpy, complex64).

Sycamore's native set: sqrt(X), sqrt(Y), sqrt(W) single-qubit gates and the
fSim(θ, φ) two-qubit gate (fSim(π/2, π/6) ≈ the Sycamore coupler).
Zuchongzhi uses the same fSim family.  Matrices follow arXiv:1910.11333.
"""

from __future__ import annotations

import numpy as np

_SQ2 = 1.0 / np.sqrt(2.0)


def _c64(m) -> np.ndarray:
    return np.asarray(m, dtype=np.complex64)


I2 = _c64([[1, 0], [0, 1]])
X = _c64([[0, 1], [1, 0]])
Y = _c64([[0, -1j], [1j, 0]])
Z = _c64([[1, 0], [0, -1]])
H = _c64([[_SQ2, _SQ2], [_SQ2, -_SQ2]])
S = _c64([[1, 0], [0, 1j]])
T = _c64([[1, 0], [0, np.exp(1j * np.pi / 4)]])

SQRT_X = _c64([[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]])
SQRT_Y = _c64([[0.5 + 0.5j, -0.5 - 0.5j], [0.5 + 0.5j, 0.5 + 0.5j]])
# sqrt(W), W = (X + Y)/sqrt(2)
SQRT_W = _c64(
    [
        [0.5 + 0.5j, -np.sqrt(0.5) * 1j],
        [np.sqrt(0.5), 0.5 + 0.5j],
    ]
)


def fsim(theta: float, phi: float) -> np.ndarray:
    """fSim gate, 4x4, basis |00>,|01>,|10>,|11>."""
    c, s = np.cos(theta), np.sin(theta)
    return _c64(
        [
            [1, 0, 0, 0],
            [0, c, -1j * s, 0],
            [0, -1j * s, c, 0],
            [0, 0, 0, np.exp(-1j * phi)],
        ]
    )


CZ = _c64(np.diag([1, 1, 1, -1]))
ISWAP = _c64(
    [[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]]
)
SYC = fsim(np.pi / 2, np.pi / 6)  # Sycamore coupler

SINGLE_QUBIT_POOL = {"sqrt_x": SQRT_X, "sqrt_y": SQRT_Y, "sqrt_w": SQRT_W}

GATES_1Q = {
    "i": I2,
    "x": X,
    "y": Y,
    "z": Z,
    "h": H,
    "s": S,
    "t": T,
    "sqrt_x": SQRT_X,
    "sqrt_y": SQRT_Y,
    "sqrt_w": SQRT_W,
}
GATES_2Q = {"cz": CZ, "iswap": ISWAP, "syc": SYC}


def gate_array(name: str, params: tuple = ()) -> np.ndarray:
    if name == "fsim":
        return fsim(*params)
    if name in GATES_1Q:
        return GATES_1Q[name]
    if name in GATES_2Q:
        return GATES_2Q[name]
    raise KeyError(name)


def is_two_qubit(name: str) -> bool:
    return name in GATES_2Q or name == "fsim"
