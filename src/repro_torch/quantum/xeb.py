"""Linear cross-entropy benchmarking (Eq. 1 of the paper)."""

from __future__ import annotations

import numpy as np


def linear_xeb(num_qubits: int, sample_probs: np.ndarray) -> float:
    """F_XEB = 2^n / k * Σ p_C(s_i) - 1 over k sampled bitstrings."""
    k = len(sample_probs)
    return float(2.0 ** num_qubits / k * np.sum(sample_probs) - 1.0)


def porter_thomas_expectation(num_qubits: int) -> float:
    """For an ideal Haar-random state, E[F_XEB] → 1 (large n)."""
    n = 2.0 ** num_qubits
    return float((2.0 * n / (n + 1.0)) - 1.0)


def xeb_from_amplitudes(num_qubits: int, amplitudes: np.ndarray) -> float:
    """Linear XEB of a sampled set given the samples' *amplitudes* (as
    returned by the batched open-index contraction): F = 2^n/k·Σ|a_i|^2 - 1.
    """
    return linear_xeb(num_qubits, np.abs(np.asarray(amplitudes)) ** 2)


def sample_bitstrings(
    probs: np.ndarray, k: int, seed: int = 0
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(len(probs), size=k, p=probs / probs.sum())
