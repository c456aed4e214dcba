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
    steps on sub-tile shapes."""

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


# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet; NVIDIA Hopper
# architecture white paper for the on-chip sizes).
_H100_FP32_FLOPS = 67e12  # data sheet: FP32 67 TFLOPS (CUDA cores, no tensor cores)
_H100_BF16_FLOPS = 989e12  # data sheet: BF16 Tensor Core, dense (1,979 with sparsity)
_H100_HBM_BW = 3.35e12  # data sheet: 80 GB HBM3 at 3.35 TB/s
_H100_L2_BYTES = 50 * 1024 * 1024  # white paper: 50 MB L2 cache
_H100_SMEM_PER_BLOCK = 227 * 1024  # white paper: 227 KB shared memory per block

H100_SXM = Hardware(
    name="H100_SXM",
    # the port's GEMM kernels are exact-fp32 SIMT FFMA (no TF32 mma), so
    # their ceiling is the CUDA-core fp32 rate, not a tensor-core rate
    peak_flops=_H100_FP32_FLOPS,
    mem_bw=_H100_HBM_BW,
    # the SIMT kernels' output tile is 64 x 64 (kernels/csrc/gemm.cu)
    tile=64,
    # complex64 runs as split fp32 planes: 4 bytes per real component
    merge_dtype_bytes=4.0,
    # block targets; the fused kernels' effective tiles are the
    # axis-suffix products at most this large
    block_candidates=(64, 128, 256),
    tile_budget_bytes=_H100_SMEM_PER_BLOCK,
    # a chain's interior carries live in a device workspace that should
    # stay resident in L2 between steps: a quarter of L2 leaves room for
    # the streamed external operands
    chain_budget_bytes=_H100_L2_BYTES // 4,
    bf16_peak_flops=_H100_BF16_FLOPS,
    l2_bytes=_H100_L2_BYTES,
    smem_per_block_bytes=_H100_SMEM_PER_BLOCK,
)

DEFAULT_HARDWARE = H100_SXM
