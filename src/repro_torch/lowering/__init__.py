"""GEMM lowering subsystem: contraction trees → executable kernel schedules.

  gemm_form — normalize each pairwise contraction into
              transpose→reshape→GEMM→reshape form (batch/M/N/K index
              classification; open sampling indices ride as batch axes,
              sliced indices are fixed before lowering)
  refiner   — the Sec. V-B adaptive refiner priced on the card: per-node
              backend choice (tiled / fused kernel, torch.matmul,
              torch.einsum), block shapes, pad-vs-split decisions, and the
              fusion-boundary pass that plans chains for the chain kernel
  partition — lifetime-based two-phase split: slice-invariant prologue
              vs slice-dependent epilogue
  memory    — lifetime-based buffer planner: linear-scan slots, exact
              live-set peaks per execution segment, free schedules
  precision — mixed precision under a Linear-XEB budget: which steps run
              bf16 inputs with fp32 accumulation, which nodes are stored
              at half width
  cache     — compiled-plan LRU keyed by a canonical network
              fingerprint (structure + dtype + open indices + planner
              params) with single-flight misses, so repeated requests for
              one circuit family skip planning; plus the hoisted-prologue
              LRU keyed by the prologue's leaf tensors
"""

from .cache import (  # noqa: F401
    PLAN_CACHE,
    HoistCache,
    PlanCache,
    PlanEntry,
    leaf_fingerprint,
    leaf_key,
    network_fingerprint,
)
from .gemm_form import GemmForm, apply, apply_chain, lower_step  # noqa: F401
from .memory import (  # noqa: F401
    MemoryPlan,
    SegmentPlan,
    chain_segment_plan,
    node_nbytes,
    peak_bytes,
    plan_memory,
)
from .partition import TreePartition, partition_tree  # noqa: F401
from .refiner import (  # noqa: F401
    ChainPlan,
    FusedChainSpec,
    GemmSpec,
    LoweredSchedule,
    modeled_plan_time,
    modeled_step_time,
    operand_transpose_bytes,
    plan_chains,
    plan_tree_chains,
    refine_schedule,
    refine_step,
    refine_tree_schedule,
)
