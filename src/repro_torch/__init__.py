"""PyTorch/CUDA port of the lifetime-based quantum-circuit simulator.

The JAX package ``repro`` is the reference; this package runs the same
pipeline — circuit → tensor network → lifetime-based plan → sliced GEMM
execution → amplitudes and samples — on an NVIDIA H100, with the
contraction kernels hand-written in CUDA for Hopper
(:mod:`repro_torch.kernels`).  It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``.
"""
