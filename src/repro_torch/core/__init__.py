"""Lifetime-based tensor-network contraction planning + sliced execution.

  tensor_network  — graph representation (bitmask index algebra)
  contraction_tree— W(B), C(B), C(B,S) (Eqs. 2/3/6) + tree surgery
  lifetime        — lifetime/correlated contractions/stem (Defs. 1-2, Thm. 1)
  slicing         — sliceFinder (Alg. 1), greedy baseline, interval-optimal
  tuning          — branch exchange + tuningSliceFinder (Alg. 2)
  merging         — branch merging under the card's F(M,N,K) surface (Sec. V)
  pathfinder      — contraction-order search (greedy/partition/DP oracle)
  executor        — eager sliced contraction on the card (einsum oracle +
                    lowered-GEMM kernel backends via repro_torch.lowering)
  api             — end-to-end pipeline + PlanReport; sample_bitstrings
"""

from .api import (  # noqa: F401
    PlanReport,
    SimulationResult,
    draw_from_batch,
    open_amplitude_batch,
    open_session,
    plan_compiled,
    plan_contraction,
    sample_bitstrings,
    simulate_amplitude,
)
from .contraction_tree import ContractionTree  # noqa: F401
from .executor import (  # noqa: F401
    ContractionPlan,
    default_backend,
    default_hoist,
    simplify_network,
)
from .lifetime import Stem, detect_stem  # noqa: F401
from .slicing import find_slices, greedy_slicer, interval_optimal_slicer, slice_finder  # noqa: F401
from .tensor_network import TensorNetwork  # noqa: F401
from .tuning import tuning_slice_finder  # noqa: F401
