"""Execution engine + contraction-as-a-service.

:mod:`repro_torch.engine.session` is the session layer every slice
strategy runs through (:class:`ContractionSession`, with the device's
:class:`ExecutionGate`); :mod:`repro_torch.engine.server` is the
multi-tenant continuous-batching amplitude/sampling engine built on top
of sessions.
"""

from .server import (
    AmplitudeRequest,
    EngineServer,
    SampleRequest,
    ServerOverloaded,
    Ticket,
    circuit_fingerprint,
)
from .session import (
    ContractionSession,
    ExecutionGate,
    execution_gate,
    mask_invalid,
    padded_ids,
    record_execution,
)

__all__ = [
    "ContractionSession",
    "ExecutionGate",
    "execution_gate",
    "mask_invalid",
    "padded_ids",
    "record_execution",
    "AmplitudeRequest",
    "EngineServer",
    "SampleRequest",
    "ServerOverloaded",
    "Ticket",
    "circuit_fingerprint",
]
