"""Arch registry: the dense-family subset of ``repro.models.registry``.

    adapter = get_adapter("qwen2-7b")
    params  = adapter.init(torch.Generator("cuda").manual_seed(0))
    state   = adapter.init_decode_state(batch, max_seq, device="cuda")
    logits, state = adapter.decode(params, {"tokens": tokens}, state, pos)

``pos`` is a host int. Only the dense family is ported; the other families
(and ``forward`` / ``loss``) wait for their slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ArchConfig
from ..configs.registry_configs import ALL_ARCHS
from . import transformer


@dataclass
class ModelAdapter:
    cfg: ArchConfig

    def init(self, gen: torch.Generator) -> dict:
        return transformer.init(self.cfg, gen)

    def init_decode_state(self, batch: int, max_seq: int,
                          dtype=torch.bfloat16, device="cuda") -> dict:
        return transformer.init_cache(self.cfg, batch, max_seq, dtype,
                                      device)

    def decode(self, params: dict, batch: dict, state: dict, pos: int):
        return transformer.decode_step(params, self.cfg, batch["tokens"],
                                       state, pos)


def get_adapter(arch_id_or_cfg) -> ModelAdapter:
    cfg = (arch_id_or_cfg if isinstance(arch_id_or_cfg, ArchConfig)
           else ALL_ARCHS[arch_id_or_cfg])
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet")
    return ModelAdapter(cfg)
