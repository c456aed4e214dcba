"""mamba2-130m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    sub_quadratic=True,
    # at 130M parameters sharding over hundreds of devices costs more in
    # gathers than it saves: pure data parallelism
    sharding_recipe="dp_only",
)
