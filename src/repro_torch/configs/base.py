"""Architecture configuration schema of the port's model paths.

A subset of ``repro.configs.base``: the PyTorch port imports nothing of
the JAX package, so it keeps its own copy of the fields its models read,
and of the parts of :func:`reduced` for the families it has, so that both
packages build the same shapes from the same config. The SSM family's
rwkv6 reads no field beyond the dense ones (its head count is
``d_model // 64``), and the dense part of ``reduced`` is also the
reference's reduced rwkv6. The hybrid family (zamba2) adds
:class:`SSMConfig` and ``shared_attn_every``; the vlm family (mllama)
``cross_attn_every`` and ``n_vision_tokens``; the audio family (whisper)
``encoder_layers``, ``n_audio_frames``, ``max_target_positions`` and
``tie_embeddings``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    # granite/phi both use a dense FFN nowhere; every block is MoE.


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64           # N (per-head state size)
    conv_width: int = 4
    expand: int = 2               # inner dim = expand * d_model
    head_dim: int = 64            # mamba2 head size


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | ssm | hybrid | vlm | audio | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False                  # qwen2-style QKV bias
    qk_norm: bool = False                   # qwen3-style per-head RMSNorm
    sliding_window: Optional[int] = None    # SWA (h2o-danube: 4096)
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k SSM blocks
    shared_attn_every: Optional[int] = None
    # vlm (mllama): one cross-attention block every k self-attention blocks
    cross_attn_every: Optional[int] = None
    n_vision_tokens: int = 1601             # stub patch-embedding count
    # audio (whisper): encoder-decoder
    encoder_layers: int = 0
    n_audio_frames: int = 1500              # stub frame-embedding count
    max_target_positions: int = 448
    dtype: str = "bfloat16"
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests (the reference's
    ``reduced``: same shapes for the same config)."""
    base = dict(
        n_layers=max(2, (cfg.shared_attn_every or cfg.cross_attn_every
                         or 1) + 1),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=128,
        vocab=256,
        head_dim=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        n_vision_tokens=16 if cfg.family == "vlm" else cfg.n_vision_tokens,
        n_audio_frames=16 if cfg.family == "audio" else cfg.n_audio_frames,
    )
    if cfg.moe:
        base["moe"] = MoEConfig(n_experts=min(cfg.moe.n_experts, 8),
                                top_k=min(cfg.moe.top_k, 2),
                                expert_d_ff=64)
    if cfg.ssm:
        base["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2)
    if cfg.sliding_window:
        base["sliding_window"] = 32
    if cfg.shared_attn_every:
        base["shared_attn_every"] = 2
        base["n_layers"] = 5
    if cfg.cross_attn_every:
        base["cross_attn_every"] = 2
        base["n_layers"] = 4
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
