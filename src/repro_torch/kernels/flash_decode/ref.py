"""Plain PyTorch version of GQA flash decode, and of its partial form over
one shard of a sequence-split cache with the merge of such partials."""
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


def flash_decode_partial_ref(q: torch.Tensor, k_local: torch.Tensor,
                             v_local: torch.Tensor, n_valid: int) -> tuple:
    """Attention of q (b, h, d) over the first ``n_valid`` slots of one
    shard (b, h_kv, S_loc, d) of a cache, 0 <= n_valid <= S_loc. Returns
    (out, m, l): out (b, h, d) in q's dtype, normalised by the shard's own
    sum; m (b, h) fp32, the row max of the logits times 1/sqrt(d); l (b, h)
    fp32, the sum of exp(logit - m) over the valid slots. A shard with no
    valid slot gives out 0, m -1e30 and l 0, so that
    :func:`merge_partials` weighs it 0."""
    b, h, d = q.shape
    hkv, S = k_local.shape[1], k_local.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k_local.float()) \
        * (1.0 / math.sqrt(d))
    valid = torch.arange(S, device=q.device) < n_valid
    logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    acc = torch.einsum("bkgs,bksd->bkgd", p, v_local.float())
    l = p.sum(-1)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return (out.to(q.dtype).reshape(b, h, d), m.reshape(b, h),
            l.reshape(b, h))


def merge_partials(outs: list, ms: list, ls: list) -> torch.Tensor:
    """The attention over the union of the shards whose partials
    (:func:`flash_decode_partial_ref`) are given: with M the largest m and
    w_r = l_r exp(m_r - M), sum_r w_r out_r / max(sum_r w_r, 1e-30) in
    fp32, cast to the partials' dtype. One shard's out is returned as it
    is."""
    if len(outs) == 1:
        return outs[0]
    M = torch.stack(ms).amax(0)
    ws = [l * torch.exp(m - M) for m, l in zip(ms, ls)]
    num = sum(w[..., None] * o.float() for w, o in zip(ws, outs))
    den = torch.clamp(sum(ws), min=1e-30)
    return (num / den[..., None]).to(outs[0].dtype)
