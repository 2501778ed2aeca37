"""Arch registry: the dense, MoE, SSM and hybrid subset of
``repro.models.registry``.

    adapter = get_adapter("rwkv6-3b")
    params  = adapter.init(torch.Generator("cuda").manual_seed(0))
    logits  = adapter.forward(params, {"tokens": tokens})   # prefill
    state   = adapter.init_decode_state(batch, max_seq, device="cuda")
    logits, state = adapter.decode(params, {"tokens": tokens}, state, pos)

``pos`` is a host int. The dense and MoE families share
``models/transformer``, as in the reference; the SSM family runs
``models/rwkv6``, whose decode state ignores ``max_seq`` and ``dtype`` (as
the reference's does: the state's dtypes are fixed); the hybrid family
runs ``models/zamba2``, whose decode state holds fp32 SSM states, conv
tails and a KV cache in ``dtype`` for each application of its shared
attention block. The other families (and ``loss``) wait for their slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ArchConfig
from ..configs.registry_configs import ALL_ARCHS
from . import rwkv6, transformer, zamba2


def _tfm_forward(params, cfg, batch):
    return transformer.forward(params, cfg, batch["tokens"])


def _tfm_decode(params, cfg, batch, state, pos):
    return transformer.decode_step(params, cfg, batch["tokens"], state, pos)


def _rwkv_forward(params, cfg, batch):
    return rwkv6.forward(params, cfg, batch["tokens"])


def _rwkv_decode(params, cfg, batch, state, pos):
    return rwkv6.decode_step(params, cfg, batch["tokens"], state, pos)


def _rwkv_init_state(cfg, batch, max_seq, dtype, device):
    return rwkv6.init_state(cfg, batch, device)


def _zamba_forward(params, cfg, batch):
    return zamba2.forward(params, cfg, batch["tokens"])


def _zamba_decode(params, cfg, batch, state, pos):
    return zamba2.decode_step(params, cfg, batch["tokens"], state, pos)


_TRANSFORMER = dict(init=transformer.init, forward=_tfm_forward,
                    decode=_tfm_decode, init_state=transformer.init_cache)

_FAMILY = {
    "dense": _TRANSFORMER,
    "moe": _TRANSFORMER,
    "ssm": dict(init=rwkv6.init, forward=_rwkv_forward, decode=_rwkv_decode,
                init_state=_rwkv_init_state),
    "hybrid": dict(init=zamba2.init, forward=_zamba_forward,
                   decode=_zamba_decode, init_state=zamba2.init_state),
}


@dataclass
class ModelAdapter:
    cfg: ArchConfig

    @property
    def _fns(self) -> dict:
        return _FAMILY[self.cfg.family]

    def init(self, gen: torch.Generator) -> dict:
        return self._fns["init"](self.cfg, gen)

    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        """Logits (b, s, V_padded) of a whole sequence (prefill)."""
        return self._fns["forward"](params, self.cfg, batch)

    def init_decode_state(self, batch: int, max_seq: int,
                          dtype=torch.bfloat16, device="cuda") -> dict:
        return self._fns["init_state"](self.cfg, batch, max_seq, dtype,
                                       device)

    def decode(self, params: dict, batch: dict, state: dict, pos: int):
        return self._fns["decode"](params, self.cfg, batch, state, pos)


def get_adapter(arch_id_or_cfg) -> ModelAdapter:
    cfg = (arch_id_or_cfg if isinstance(arch_id_or_cfg, ArchConfig)
           else ALL_ARCHS[arch_id_or_cfg])
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet")
    return ModelAdapter(cfg)
