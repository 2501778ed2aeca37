"""llama-3.2-vision-90b [vlm] — cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. Frontend = stub patch
embeddings; cross layer every 5th layer (100L = 20 x [4 self + 1 cross])."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    cross_attn_every=5, n_vision_tokens=1601, rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
