"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]. ssm_state=64. The reference runs it in its
long_500k cell, where the shared attention switches to a sliding window."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, head_dim=64),
    shared_attn_every=6,
    source="arXiv:2411.15242; hf",
)
