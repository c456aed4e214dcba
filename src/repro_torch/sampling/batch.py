"""Open-batch contraction: one sliced contraction → 2^k correlated amplitudes.

``open_batch_network`` lowers a circuit with ``k`` chosen output qubits held
open (everything else projected onto a base bitstring); contracting the
result yields the full amplitude tensor over those qubits.  The open axes
ride through the planner untouched — open indices are never sliced and never
contracted, so the slice-sum structure (and the single all-reduce) is
exactly the scalar-amplitude pipeline's, just with a tensor accumulator.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def open_batch_network(circuit, base_bitstring: str, open_qubits):
    """(TensorNetwork, arrays) with ``open_qubits`` output wires held open.

    Non-open qubits are projected onto their ``base_bitstring`` value; the
    open wires become output axes in ascending qubit order.  The network is
    pre-simplified (gate fusion) like the scalar-amplitude path.
    """
    from ..core.executor import simplify_network
    from ..quantum.circuits import circuit_to_network

    tn, arrays = circuit_to_network(
        circuit, bitstring=base_bitstring, open_qubits=tuple(open_qubits)
    )
    return simplify_network(tn, arrays)


def contract_amplitude_batch(
    plan,
    arrays,
    hoist: bool = True,
    devices=None,
) -> np.ndarray:
    """Run a compiled :class:`~repro_torch.core.executor.ContractionPlan`
    and return the amplitude tensor (one axis per open qubit) on the host.

    ``devices=None`` runs every slice on the plan's device; with a list
    of devices the slice ids are split into contiguous chunks over them
    (:func:`repro_torch.core.distributed.contract_sharded`, one id at a
    time, partials summed on the first device in device order) and the
    open-batch axes ride inside each device's accumulator unchanged.

    Backend-agnostic: a plan built with ``backend="gemm"`` carries its
    lowered kernel schedule (open indices lowered as GEMM batch axes, see
    :mod:`repro_torch.lowering`) and executes it.  Under two-phase
    execution (``hoist``) the slice-invariant stem prologue runs once (per
    device) and only the per-slice epilogue runs per slice.
    """
    from ..obs import trace as _trace

    with _trace.span(
        "sampling.contract", cat="sampling", sharded=devices is not None,
    ):
        if devices is None:
            value = plan.contract_all(arrays, hoist=hoist)
        else:
            from ..core.distributed import contract_sharded

            value = contract_sharded(plan, arrays, devices, hoist=hoist)
        value = _trace.sync(value)
    return value.cpu().numpy()


@dataclasses.dataclass
class AmplitudeBatch:
    """All 2^k correlated amplitudes from one open-batch contraction.

    ``amplitudes`` has one axis per open qubit (ascending qubit order), so
    flat index ``i`` encodes the open-qubit bits MSB-first: bit ``j`` of the
    batch entry is ``(i >> (k-1-j)) & 1`` and belongs to ``open_qubits[j]``.
    """

    amplitudes: np.ndarray
    open_qubits: tuple[int, ...]
    base_bitstring: str
    num_qubits: int

    def __post_init__(self):
        self.open_qubits = tuple(self.open_qubits)
        if self.amplitudes.ndim != len(self.open_qubits):
            raise ValueError(
                f"batch has {self.amplitudes.ndim} axes for "
                f"{len(self.open_qubits)} open qubits"
            )

    @property
    def k(self) -> int:
        return len(self.open_qubits)

    @property
    def size(self) -> int:
        return int(self.amplitudes.size)

    def flat(self) -> np.ndarray:
        """Amplitudes as a 1-D batch of length 2^k (C order = MSB first)."""
        return np.ravel(self.amplitudes)

    def probs(self, normalize: bool = False) -> np.ndarray:
        """|amplitude|^2 per batch entry.

        Unnormalized values are the *true* circuit probabilities p_C(s) of
        the full n-qubit bitstrings (what XEB needs); ``normalize=True``
        gives the conditional distribution over the open qubits (what the
        frequency sampler draws from).
        """
        p = np.abs(self.flat()) ** 2
        if normalize:
            s = p.sum()
            if s <= 0:
                raise ValueError("all batch amplitudes are zero")
            p = p / s
        return p

    def bitstring_for(self, index: int) -> str:
        """Full n-qubit bitstring for flat batch entry ``index``: the base
        bitstring with the open positions filled from ``index``'s bits."""
        out = list(self.base_bitstring)
        kk = self.k
        for j, q in enumerate(self.open_qubits):
            out[q] = str((index >> (kk - 1 - j)) & 1)
        return "".join(out)

    def bitstrings_for(self, indices) -> list[str]:
        return [self.bitstring_for(int(i)) for i in np.asarray(indices)]
