"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783; unverified].

Too large for one card (405.85 B parameters): only the dry run builds it,
as meta tensors."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
)
