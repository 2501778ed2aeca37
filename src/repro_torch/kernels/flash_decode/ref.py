"""Plain PyTorch version of GQA flash decode."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """q: (b, h, d); caches: (b, h_kv, S, d); pos: the position of the new
    token. Returns (b, h, d) in q's dtype.

    The softmax of ``repro.models.layers._cached_attention_local``: fp32
    logits scaled by 1/sqrt(d), slots after ``pos`` set to -1e30, and the
    sum floored at 1e-30."""
    b, h, d = q.shape
    hkv, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) \
        * (1.0 / math.sqrt(d))
    valid = torch.arange(S, device=q.device) <= pos
    logits = logits.masked_fill(~valid, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    acc = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    out = acc / torch.clamp(p.sum(-1), min=1e-30)[..., None]
    return out.to(q.dtype).reshape(b, h, d)
