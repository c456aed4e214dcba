"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].  Shared transformer block applied every 6
mamba layers (one weight set, zamba's signature trick); sliding-window
attention keeps the 500k decode sub-quadratic."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    window=4096,
    sub_quadratic=True,
)
