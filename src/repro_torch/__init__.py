"""PyTorch/CUDA port of the ``repro`` serving path for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and no JAX. Module names mirror ``repro``'s so that each counterpart is
easy to find. Entry points run on ``cuda`` unless the caller asks for the
CPU; asking for ``cuda`` without a card raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. Raises when ``cuda`` is asked
    for and no card is present: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
