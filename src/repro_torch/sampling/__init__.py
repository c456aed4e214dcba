"""Batched correlated-amplitude sampling — the paper's flagship workload.

The headline experiment (Sec. VI: one million correlated samples of the
Sycamore RQC in 96.1 s) never computes amplitudes one bitstring at a
time.  Instead, a small subset of output qubits is held *open* through
the final stem of the contraction, so every sliced contraction produces
a tensor of ``2^k`` amplitudes sharing the projected prefix — a batch of
*correlated* amplitudes from one plan execution.  Bitstrings are then
drawn from that batch (frequency / rejection / top-k sampling) and
scored with Linear XEB.  The same trick is the winning move in
"Closing the Quantum Supremacy Gap" (arXiv:2110.14502) and "Classical
Simulation of Quantum Supremacy Circuits" (arXiv:2005.06787).

Layering:

  batch.py    — open-batch network construction + contraction
  samplers.py — frequency / rejection / top-k samplers + SamplingResult

The public entry point is :func:`repro_torch.core.api.sample_bitstrings`.
"""

from .batch import (  # noqa: F401
    AmplitudeBatch,
    contract_amplitude_batch,
    open_batch_network,
)
from .samplers import (  # noqa: F401
    SamplingResult,
    frequency_sample,
    rejection_sample,
    top_k_indices,
)
