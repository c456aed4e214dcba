"""Hierarchical multi-host slice parallelism (paper Sec. V-D, extended),
on ``torch.distributed``.

The paper distributes the ``2^|S|`` slice subtasks over processes with a
static uniform split and ends with one terminal all-reduce.  This
package is the dynamic successor to that scheme, in three decoupled
layers the runner composes:

  * :mod:`~repro_torch.distributed.scheduler` — LPT work queues seeded by
    the co-optimizer's per-slice modeled FLOPs, with deterministic tail
    stealing between hosts (plus a virtual-time simulator);
  * :mod:`~repro_torch.distributed.transport` — ``torch.distributed``
    set-up (``gloo`` on CPU tensors, ``nccl`` on CUDA ones; N plain
    subprocesses in the CPU tests) and the overlapped chunked all-reduce
    with a fixed, steal-proof collective call count;
  * :mod:`~repro_torch.distributed.elastic` — filesystem claim store:
    atomic range claims (``O_EXCL``), single-writer per-host checkpoints,
    epoch-gated stale-claim reclaim, and the merged-checkpoint resume.

:func:`~repro_torch.distributed.multihost.contract_multihost` is the
runner; ``contract_sharded`` (device-level, one process) stays in
:mod:`repro_torch.core.distributed` and is unchanged at world size 1.
"""

from .elastic import ClaimStore
from .multihost import MultiHostResult, contract_multihost
from .scheduler import (
    Arbiter,
    LocalArbiter,
    SimResult,
    SliceRange,
    SliceScheduler,
    imbalance,
    lpt_assignment,
    make_ranges,
    simulate,
    uniform_assignment,
)
from .transport import (
    CollectiveTransport,
    FileTransport,
    NullTransport,
    Transport,
    init_multi_host,
    world,
)

__all__ = [
    "Arbiter",
    "ClaimStore",
    "CollectiveTransport",
    "FileTransport",
    "LocalArbiter",
    "MultiHostResult",
    "NullTransport",
    "SimResult",
    "SliceRange",
    "SliceScheduler",
    "Transport",
    "contract_multihost",
    "imbalance",
    "init_multi_host",
    "lpt_assignment",
    "make_ranges",
    "simulate",
    "uniform_assignment",
    "world",
]
