"""Hardware constants read by the port's cost models.

Two planner layers price work against a machine:

  * :mod:`repro_torch.core.merging` — the F(M, N, K) efficiency surface
    behind branch merging (it changes contraction trees);
  * :mod:`repro_torch.lowering.refiner` — per-step backend choice, block
    ladder, shared-memory tile budget and the chain workspace budget.

Both take a :class:`Hardware` object.  The default is :data:`H100_SXM`.
Tests build an object from another machine's constants to show that the
planner code itself is unchanged: the same constants give the same
trees, masks and schedules.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One accelerator, as the planner's cost models see it.

    ``peak_flops`` is the rate of the port's own GEMM kernels (the tiled,
    fused and chain kernels), ``mem_bw`` the device-memory rate.
    ``tile`` is the kernels' output-tile edge: the merging surface's
    quantization step and the refiner's smallest kernel dimension.
    ``merge_dtype_bytes`` is the element width the merging surface
    charges for traffic.  ``block_candidates`` is the refiner's block
    ladder, ``tile_budget_bytes`` the on-chip working set one block may
    hold, ``chain_budget_bytes`` the certified live set of one fused
    chain.  ``non_kernel_peak_fraction`` prices library einsum/matmul
    steps on sub-tile shapes; ``bf16_peak_flops`` is the kernels' rate on
    their bf16 routes (bf16 inputs, fp32 accumulation)."""

    name: str
    peak_flops: float
    mem_bw: float
    tile: int
    merge_dtype_bytes: float
    block_candidates: tuple[int, ...]
    tile_budget_bytes: int
    chain_budget_bytes: int
    non_kernel_peak_fraction: float = 0.125
    einsum_flops_floor: float = 2.0 ** 16
    bf16_peak_flops: float = 0.0
    l2_bytes: int = 0
    smem_per_block_bytes: int = 0


# NVIDIA H100 SXM5.  The kernel rates are measured: launch/calibrate.py on
# an NVIDIA H100 80GB HBM3 at a 700.00 W power limit times every GEMM form
# of the 30- and 36-qubit plans of chip_smoke.py on each backend (PERF.md
# §6).  The memory rate and the on-chip sizes are the data sheet's
# and the Hopper white paper's.
#
# The kernels' fp32 route is 3xTF32 on wgmma (K1, K2; about 22 of fp32's
# 24 mantissa bits), complex64 read in place, a complex product as four
# real products.  At the plans' compute-bound steps (2^35 to 2^38 real
# operations a step, counted four real products to a complex one) K1 and
# K2 reach 63-78 TFLOP/s, their bf16 routes 75-107 TFLOP/s, and the
# library's complex matmul without TF32 (the dot and einsum backends)
# 45-56 TFLOP/s, all on the H100 80GB HBM3 at 700.00 W.
_H100_KERNEL_FLOPS = 78e12  # K1/K2 3xTF32, best of the plans' compute-bound steps
_H100_KERNEL_BF16_FLOPS = 107e12  # K1/K2 bf16 routes, the same steps
_H100_LIBRARY_FLOPS = 55.5e12  # torch.matmul complex64, no TF32, the same steps
_H100_HBM_BW = 3.35e12  # data sheet: 80 GB HBM3 at 3.35 TB/s
# NVIDIA H100 Tensor Core GPU data sheet, SXM: NVLink 900 GB/s in total
# (18 fourth-generation links), 450 GB/s each way; a ring step sends and
# receives at once, so a collective's bytes leave a card at 450 GB/s.
# The dry run's collective term (roofline/analysis.py) reads it
H100_NVLINK_BW = 450e9
_H100_L2_BYTES = 50 * 1024 * 1024  # white paper: 50 MB L2 cache
_H100_SMEM_PER_BLOCK = 227 * 1024  # white paper: 227 KB shared memory per block

H100_SXM = Hardware(
    name="H100_SXM",
    peak_flops=_H100_KERNEL_FLOPS,
    mem_bw=_H100_HBM_BW,
    # the 64-wide edge the kernels take whole: K1's and K2's 128 x 64 /
    # 64 x 128 tile (K1 runs K2's body; a 64 x 64 block per consumer
    # warpgroup) and K3's 64 x 64 tile.  Measured as the merging
    # surface's step (launch/calibrate.py --trees, same card): 128 builds
    # trees of 1.5x (amp30) and 2.1x (share36) the operations, and amp30
    # ran 3.51 s against 2.60 s, share36 0.372 s a slice (|S| 10) against
    # 0.075 (|S| 12).
    tile=64,
    # a complex64 step is four real products over 8-byte elements, the
    # same operations per byte as one real product over 4-byte ones
    merge_dtype_bytes=4.0,
    # block targets; the fused kernels' effective tiles are the
    # axis-suffix products at most this large
    block_candidates=(64, 128, 256),
    tile_budget_bytes=_H100_SMEM_PER_BLOCK,
    # a chain's interior carries live in a device workspace that should
    # stay resident in L2 between steps: a quarter of L2 leaves room for
    # the streamed external operands
    chain_budget_bytes=_H100_L2_BYTES // 4,
    non_kernel_peak_fraction=_H100_LIBRARY_FLOPS / _H100_KERNEL_FLOPS,
    bf16_peak_flops=_H100_KERNEL_BF16_FLOPS,
    l2_bytes=_H100_L2_BYTES,
    smem_per_block_bytes=_H100_SMEM_PER_BLOCK,
)

DEFAULT_HARDWARE = H100_SXM
