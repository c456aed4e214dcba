"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
Backbone only: the vision frontend is a stub — the prompt comes as
precomputed patch/text embeddings plus (3, B, S) M-RoPE position ids
(``launch.decode_demo.prompt_inputs``)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    mrope=True,
    embed_inputs=True,
    rope_theta=1000000.0,
)
