"""whisper-small [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64,
    encoder_layers=12, n_audio_frames=1500, max_target_positions=448,
    tie_embeddings=True, norm_eps=1e-5,
    source="arXiv:2212.04356; unverified",
)
