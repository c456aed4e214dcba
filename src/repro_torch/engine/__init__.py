"""Execution engine: :class:`ContractionSession` is the session layer
every slice strategy runs through.  The reference's multi-tenant serving
engine is not ported yet."""

from .session import ContractionSession, mask_invalid, padded_ids

__all__ = ["ContractionSession", "mask_invalid", "padded_ids"]
