"""Hand-written CUDA kernels for Hopper and their wrappers.

contract_gemm   — the three contraction kernels (tiled_gemm,
                  fused_gemm_c64, chain_gemm_c64), each with its plain
                  PyTorch version, its bf16 route and launch counters
flash_attention — causal GQA flash attention (bf16 on wgmma, fp32 FFMA)
                  and its backward (bf16 on mma.sync, fp32 FFMA)
mamba2_ssd      — the Mamba-2 SSD intra-chunk kernel and its backward
                  (3xTF32 wgmma on the model's shapes, FFMA elsewhere)
ops             — wrappers used by the lowering layer and the models:
                  complex64 in place for the tiled, fused and chain
                  kernels (fp32 or bf16 routes, half-width outputs), the
                  dot fallback below the tile size, attention and the SSD
                  scan
ref             — plain PyTorch helpers
build           — nvcc build of csrc/ at first use, loaded with ctypes
"""
