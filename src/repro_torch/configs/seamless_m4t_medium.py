"""seamless-m4t-medium [audio] — enc-dec backbone, multimodal
[arXiv:2308.11596; hf].  The audio frontend is a stub, as in the
reference: the encoder takes precomputed frame embeddings (batch,
frames, d_model); the text decoder is causal with cross-attention to the
encoder's memory (``models/encdec.py``)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    embed_inputs=True,      # encoder consumes frame embeddings
    rope_theta=10000.0,
)
