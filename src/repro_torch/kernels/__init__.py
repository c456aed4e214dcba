"""Hand-written CUDA kernels for Hopper and their wrappers.

contract_gemm — the three contraction kernels (tiled_gemm, fused_gemm,
                chain_gemm), each with its plain PyTorch version and a
                launch counter
ops           — wrappers used by the lowering layer: complex Karatsuba,
                the dot fallback below the tile size, the complex split
                at the chain boundary
ref           — plain PyTorch helpers
build         — nvcc build of csrc/ at first use, loaded with ctypes

The reference's two LM-side kernels (flash attention, Mamba-2 SSD) are
not ported yet.
"""
