"""Arch-id -> ArchConfig registry of the port (the 10 assigned
architectures): the dense and MoE configs run by ``models/transformer``,
the SSM config by ``models/rwkv6``, the hybrid config by ``models/zamba2``,
the vlm config by ``models/mllama`` and the audio config by
``models/whisper``."""
from . import (granite_moe_3b, h2o_danube_1_8b, llama32_vision_90b,
               minitron_8b, phi35_moe_42b, qwen2_7b, qwen3_14b, rwkv6_3b,
               whisper_small, zamba2_1_2b)

ALL_ARCHS = {
    "qwen2-7b": qwen2_7b.CONFIG,
    "minitron-8b": minitron_8b.CONFIG,
    "h2o-danube-1.8b": h2o_danube_1_8b.CONFIG,
    "qwen3-14b": qwen3_14b.CONFIG,
    "rwkv6-3b": rwkv6_3b.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "llama-3.2-vision-90b": llama32_vision_90b.CONFIG,
    "whisper-small": whisper_small.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b.CONFIG,
}


def get_config(arch_id: str):
    if arch_id not in ALL_ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ALL_ARCHS)}")
    return ALL_ARCHS[arch_id]
