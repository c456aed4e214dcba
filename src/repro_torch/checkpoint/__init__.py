"""Fault-tolerant checkpoints: atomic slice-range checkpoints and an
async, bounded manager for trees of tensors (:mod:`.manager`)."""

from .manager import (  # noqa: F401
    CheckpointManager,
    load_slice_checkpoint,
    save_slice_checkpoint,
)
