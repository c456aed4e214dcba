"""Bitstring samplers over a correlated-amplitude batch.

Three strategies from the supremacy-simulation literature:

  * ``frequency_sample`` — draw from the exact conditional distribution
    |a_i|^2 / Σ|a|^2 over the open qubits (multinomial).  This is the
    paper's correlated sampling: many bitstrings per contraction, with
    frequencies faithful to the circuit distribution.
  * ``rejection_sample`` — Markov-free accept/reject against a uniform
    proposal (arXiv:2005.06787's frugal rejection sampling): accept
    candidate ``i`` with probability p_i / M where M ≥ max p.  Produces
    unbiased samples without normalizing over unseen amplitudes.
  * ``top_k_indices`` — the k heaviest outcomes, for spoofing-style
    heavy-output workloads.

All samplers return *flat batch indices*; :class:`AmplitudeBatch` maps
those to full n-qubit bitstrings.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .batch import AmplitudeBatch


@dataclasses.dataclass
class SamplingResult:
    """Output of :func:`repro_torch.core.api.sample_bitstrings`.

    bitstrings  — sampled full n-qubit bitstrings
    amplitudes  — the sampled entries' amplitudes (len == num samples)
    probs       — true probabilities |amplitude|^2 of the samples
    xeb         — Linear XEB estimate of the sample set (Eq. 1)
    batch       — the underlying 2^k correlated-amplitude batch
    sampler     — which sampling strategy produced the set
    report      — planner metrics for the one contraction that was run
    """

    bitstrings: list[str]
    amplitudes: np.ndarray
    probs: np.ndarray
    xeb: float
    batch: AmplitudeBatch
    sampler: str
    report: object | None = None

    @property
    def num_samples(self) -> int:
        return len(self.bitstrings)


def frequency_sample(
    batch: AmplitudeBatch, num_samples: int, seed: int = 0
) -> np.ndarray:
    """Multinomial draw of flat batch indices ∝ |amplitude|^2 (delegates
    to the XEB module's sampler so there is one multinomial in the repo)."""
    from ..quantum import xeb

    # normalize=True keeps the all-zero-batch guard in one place
    return xeb.sample_bitstrings(
        batch.probs(normalize=True), num_samples, seed=seed
    )


def rejection_sample(
    batch: AmplitudeBatch,
    num_samples: int,
    seed: int = 0,
    ceiling: float | None = None,
    max_rounds: int = 10_000,
) -> np.ndarray:
    """Accept/reject with a uniform proposal over the batch.

    ``ceiling`` bounds max_i p_i; default is the exact batch maximum (known
    here since the whole batch is in hand — frugal variants use a
    Porter-Thomas multiple of the mean instead).
    """
    rng = np.random.default_rng(seed)
    p = batch.probs(normalize=False)
    m = float(p.max()) if ceiling is None else float(ceiling)
    if m <= 0:
        raise ValueError("cannot rejection-sample an all-zero batch")
    out: list[np.ndarray] = []
    need = num_samples
    for _ in range(max_rounds):
        if need <= 0:
            break
        # propose in blocks sized by the expected acceptance rate
        rate = max(p.mean() / m, 1e-6)
        block = int(min(4 * need / rate, 4e6)) + 1
        cand = rng.integers(0, batch.size, size=block)
        keep = cand[rng.random(block) * m < p[cand]]
        out.append(keep[:need])
        need -= len(keep[:need])
    if need > 0:
        raise RuntimeError("rejection sampling did not converge")
    return np.concatenate(out)


def top_k_indices(batch: AmplitudeBatch, k: int) -> np.ndarray:
    """Flat indices of the k largest |amplitude|^2, heaviest first.

    Unlike the random samplers, top-k draws *without* replacement, so it
    cannot return more samples than the batch holds — asking for more is
    an error rather than a silent truncation.
    """
    if k > batch.size:
        raise ValueError(
            f"topk asked for {k} samples from a batch of {batch.size}; "
            "open more qubits or lower num_samples"
        )
    p = batch.probs(normalize=False)
    idx = np.argpartition(p, -k)[-k:]
    return idx[np.argsort(p[idx])[::-1]]


def draw(
    batch: AmplitudeBatch,
    num_samples: int,
    sampler: str = "frequency",
    seed: int = 0,
) -> np.ndarray:
    """Dispatch on sampler name ('frequency' | 'rejection' | 'topk')."""
    if sampler == "frequency":
        return frequency_sample(batch, num_samples, seed=seed)
    if sampler == "rejection":
        return rejection_sample(batch, num_samples, seed=seed)
    if sampler == "topk":
        return top_k_indices(batch, num_samples)
    raise ValueError(f"unknown sampler {sampler!r}")
