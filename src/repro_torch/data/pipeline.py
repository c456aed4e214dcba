"""Deterministic, resumable synthetic data pipeline (numpy only).

A copy of the reference's ``data/pipeline.py``: every batch is a pure
function of (seed, step, shape) through numpy's counter-seeded
``SeedSequence([seed, step])``, so a restart at step N reproduces batch N
exactly on any host count (each host slices its rows of the global
batch), and checkpoint-resume is bit-identical.  The batches are bitwise
the reference's for the same ``(seed, step, host_slice)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTextDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embed_dim: int = 0  # >0: also emit frame/patch embeddings (stub fronts)
    mrope: bool = False

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )

    def batch(self, step: int, host_slice: slice | None = None) -> dict:
        rng = self._rng(step)
        B, S = self.global_batch, self.seq_len
        # learnable Markov stream: next = prev + δ (mod V), δ ∈ {1,2,3}
        # with fixed probabilities — entropy ≈ 1.16 bits, so a working
        # model's loss drops well below ln(V) (random-token streams are
        # unlearnable and make "loss decreases" meaningless).
        start = rng.integers(0, self.vocab_size, size=(B, 1), dtype=np.int64)
        deltas = rng.choice(
            np.array([1, 2, 3]), size=(B, S), p=[0.7, 0.2, 0.1]
        )
        tokens = (
            start + np.concatenate(
                [np.zeros((B, 1), np.int64), np.cumsum(deltas, axis=1)],
                axis=1,
            )
        ) % self.vocab_size
        tokens = tokens.astype(np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.embed_dim:
            out["embeds"] = rng.normal(size=(B, S, self.embed_dim)).astype(
                np.float32
            )
        if self.mrope:
            base = np.arange(S, dtype=np.int32)
            out["positions"] = np.broadcast_to(
                base, (3, B, S)
            ).copy()
        if host_slice is not None:
            out = {
                k: (v[:, host_slice] if k == "positions" else v[host_slice])
                for k, v in out.items()
            }
        return out

    # resumability contract
    def state_dict(self, step: int) -> dict:
        return {"seed": self.seed, "step": step}

    @classmethod
    def from_state(cls, state: dict, **kw) -> tuple["SyntheticTextDataset", int]:
        return cls(seed=state["seed"], **kw), state["step"]
