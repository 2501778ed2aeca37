"""Shared model layers: norms, rotary embeddings, masks, GQA projection,
full-sequence, cross and cached decode attention, SwiGLU and GELU FFNs and
the dense initializer.

The PyTorch counterpart of ``repro.models.layers``, function for function,
with the same cast order so that bf16 rounds at the same places. At decode
every weight product goes through the row-stream matmul kernel and the
cached attention through the flash-decode kernel; their wrappers launch
the CUDA kernels for CUDA tensors and run the plain versions for CPU
tensors. The JAX package has no prefill kernel, so the full-sequence path
(``self_attention``, ``cross_attention``) is plain torch ops: the products
take ``mm``, ``torch.matmul`` over all rows of a prompt. A decode step's
cross-attention against a KV computed once per request (vision patches,
encoder output) also goes through the flash-decode kernel
(``cross_decode_attention``).

On a mesh whose ``model`` axis holds several ranks the dense decode step
runs tensor- and context-parallel, as the reference's partitioning does:
each rank projects with its shards of the weights (its own heads, its
columns of the SwiGLU), the heads are gathered, each rank attends over its
slots of a KV cache split by sequence (``cached_attention_update``), and
the row-parallel products are summed over the ranks
(``distributed/sharding.py``'s collectives). A cross KV (whisper's
frames, mllama's vision tokens) is split by sequence too where the axis
divides it, every head whole, and whole on every rank where it does not
(``cross_decode_attention``, ``cross_kv_layout``), as the reference lays
it out. The training forward on such a mesh (``self_attention`` with
``mesh``) runs each rank's query heads only, through the autograd
collectives, so its gradients are each rank's shards
(``models/transformer.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.sharding import (TP_AXIS, all_gather, all_reduce_max,
                                    all_reduce_sum, copy_to_model,
                                    model_rank, model_size,
                                    reduce_from_model)
from ..kernels.flash_decode.ops import flash_decode, flash_decode_partial
from ..kernels.rowstream_matmul.ops import rowstream_matmul

# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last dim of x: (..., k) @ (k, n) -> (..., n),
    fp32 accumulation, cast to x's dtype (what ``x @ w`` gives in JAX)."""
    lead = x.shape[:-1]
    out = rowstream_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return out.reshape(*lead, w.shape[1])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32, cast back to x's dtype, then scale by w in that
    dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Normalise in fp32 by the mean and the population variance (jnp.var),
    cast back to x's dtype, then scale by w and shift by b in that
    dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e6) -> torch.Tensor:
    """x: (..., seq, head_dim); positions: (..., seq) integer."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., s, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def causal_mask(q_len: int, kv_len: int, sliding_window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask, True = attend. Supports SWA."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    m = kv_pos <= q_pos
    if sliding_window is not None:
        m &= kv_pos > q_pos - sliding_window
    return m


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, h_kv, s, d) -> (b, h_kv*n_rep, s, d)."""
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (b, h, sq, d), k/v: (b, h, skv, d) -> (b, h, sq, d).

    The logits in fp32 (JAX's ``preferred_element_type``: a bf16 product
    is exact in fp32), masked with fp32's lowest value, softmax in fp32,
    then the probabilities cast to v's dtype before the second product."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def gqa_project(params: dict, x: torch.Tensor, cfg, mm=matmul) -> tuple:
    """Project hidden states to q/k/v heads: returns (q, k, v) shaped
    (b, h, s, hd) / (b, h_kv, s, hd). `mm` is the product."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = mm(x, params["wq"])
    k = mm(x, params["wk"])
    v = mm(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    nH = params["wq"].shape[1] // hd
    nKV = params["wk"].shape[1] // hd
    q = q.reshape(b, s, nH, hd).transpose(1, 2)
    k = k.reshape(b, s, nKV, hd).transpose(1, 2)
    v = v.reshape(b, s, nKV, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


# Above this sequence length the full (s x s) fp32 logits of one layer
# outgrow device memory; switch to the chunked online-softmax evaluation
# (memory O(q_chunk * kv_chunk) per head instead of O(s^2), same result).
CHUNKED_ATTN_THRESHOLD = 8192
Q_CHUNK = 2048
KV_CHUNK = 2048
NEG_INF_F32 = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sliding_window: Optional[int] = None,
                      q_chunk: int = Q_CHUNK,
                      kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """Causal attention via online softmax over KV blocks, one query block
    at a time. q/k/v: (b, h, s, d) -> (b, h, s, d). Every query block
    visits every KV block, masked ones included, as the reference's scan
    does."""
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    nq = -(-s // q_chunk)
    nkv = -(-s // kv_chunk)
    qp = F.pad(q, (0, 0, 0, nq * q_chunk - s))
    kp = F.pad(k, (0, 0, 0, nkv * kv_chunk - s))
    vp = F.pad(v, (0, 0, 0, nkv * kv_chunk - s))
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = qp[:, :, qi * q_chunk:(qi + 1) * q_chunk].float()
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, h, q_chunk), NEG_INF_F32, device=dev)
        l = torch.zeros((b, h, q_chunk), device=dev)
        acc = torch.zeros((b, h, q_chunk, d), device=dev)
        for j in range(nkv):
            kj = kp[:, :, j * kv_chunk:(j + 1) * kv_chunk]
            vj = vp[:, :, j * kv_chunk:(j + 1) * kv_chunk]
            kv_pos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            logits = torch.einsum("bhqd,bhkd->bhqk", qblk, kj.float()) * scale
            mask = kv_pos[None, :] <= q_pos[:, None]
            if sliding_window is not None:
                mask &= kv_pos[None, :] > q_pos[:, None] - sliding_window
            mask &= (kv_pos < s)[None, :]
            logits = torch.where(mask, logits, NEG_INF_F32)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] \
                + torch.einsum("bhqk,bhkd->bhqd", p.to(vj.dtype), vj)
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :s]


def self_attention(params: dict, x: torch.Tensor, cfg,
                   positions: torch.Tensor, mesh=None) -> torch.Tensor:
    """Full-sequence causal GQA self-attention (prefill path), products
    through torch.matmul. Long sequences use the chunked online-softmax
    path (same math, bounded memory). The reference's optional mask, which
    no caller passes, is left out.

    With a `mesh` whose ``model`` axis holds n > 1 ranks (the training
    forward on shards), `params` are this rank's shards: wq and bq its
    query heads' columns, wo their rows, wk/wv/bk/bv its KV heads' where
    they split over n (``transformer.attn_specs``), else whole. `x` enters
    through ``copy_to_model``, the rank attends with its own query heads
    (against its KV heads, or, where every rank holds every KV head, the
    ones its heads' groups use), and its product with wo is summed over
    the ranks (``reduce_from_model``). Replicated leaves that act on this
    rank's heads only (q_norm, k_norm, and wk/wv/bk/bv where they are
    whole) enter through ``copy_to_model`` too, so that their gradients
    are summed over the ranks."""
    b, s, _ = x.shape
    mm = torch.matmul
    n = model_size(mesh)
    if n > 1:
        x = copy_to_model(x, mesh)
        params = _partial_grad_leaves(params, cfg, mesh)
    q, k, v = gqa_project(params, x, cfg, mm)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    if n > 1 and k.shape[1] == cfg.n_kv_heads:
        k, v = kv_groups(k, v, q.shape[1], n, model_rank(mesh))
    n_rep = q.shape[1] // k.shape[1]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    if s >= CHUNKED_ATTN_THRESHOLD:
        out = chunked_attention(q, k, v, cfg.sliding_window)
    else:
        out = attention_scores(q, k, v, causal_mask(s, s, cfg.sliding_window,
                                                    x.device))
    out = out.transpose(1, 2).reshape(b, s, -1)
    out = mm(out, params["wo"])
    return reduce_from_model(out, mesh) if n > 1 else out


def _partial_grad_leaves(params: dict, cfg, mesh) -> dict:
    """The attention leaves with ``copy_to_model`` on those that every
    rank holds whole but applies to its own heads only: q_norm, k_norm,
    and wk, wv, bk, bv where the KV heads do not split."""
    out = dict(params)
    names = ["q_norm", "k_norm"] if cfg.qk_norm else []
    if params["wk"].shape[1] == cfg.n_kv_heads * cfg.resolved_head_dim:
        names += ["wk", "wv"] + (["bk", "bv"] if cfg.qkv_bias else [])
    for name in names:
        out[name] = copy_to_model(params[name], mesh)
    return out


def kv_groups(k: torch.Tensor, v: torch.Tensor, nq: int, n: int,
              rank: int) -> tuple:
    """k, v (b, h_kv, s, hd) of every KV head -> those that query heads
    rank * nq .. (rank + 1) * nq - 1 of nq * n use, one per query head
    (``repeat_kv``'s head j of the whole is KV head j // n_rep)."""
    n_rep = nq * n // k.shape[1]
    idx = torch.arange(rank * nq, (rank + 1) * nq, device=k.device) // n_rep
    return k[:, idx], v[:, idx]


def cross_attention(params: dict, x: torch.Tensor, kv_input: torch.Tensor,
                    cfg) -> torch.Tensor:
    """Full-sequence cross-attention (prefill path): queries from `x`
    (b, s, d), keys and values from `kv_input` (b, s_kv, d), no RoPE, no
    mask, products through torch.matmul. Queries of s >=
    CHUNKED_ATTN_THRESHOLD are taken Q_CHUNK at a time, padded to whole
    blocks, as the reference's q-block map does: the unblocked (s x s_kv)
    fp32 logits grow with s."""
    b, s, _ = x.shape
    mm = torch.matmul
    hd = cfg.resolved_head_dim
    skv = kv_input.shape[1]
    q = mm(x, params["wq"]).reshape(b, s, -1, hd).transpose(1, 2)
    k = mm(kv_input, params["wk"]).reshape(b, skv, -1, hd).transpose(1, 2)
    v = mm(kv_input, params["wv"]).reshape(b, skv, -1, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    n_rep = q.shape[1] // k.shape[1]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    if s >= CHUNKED_ATTN_THRESHOLD:
        nq = -(-s // Q_CHUNK)
        qp = F.pad(q, (0, 0, 0, nq * Q_CHUNK - s))
        out = torch.cat([attention_scores(
            qp[:, :, i * Q_CHUNK:(i + 1) * Q_CHUNK], k, v, None)
            for i in range(nq)], dim=2)[:, :, :s]
    else:
        out = attention_scores(q, k, v, None)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return mm(out, params["wo"])


def cross_decode_attention(q: torch.Tensor, xk: torch.Tensor,
                           xv: torch.Tensor, mesh=None,
                           seq_len: Optional[int] = None) -> torch.Tensor:
    """One query token against a cross KV computed once per request.
    q: (b, h, 1, hd); xk/xv: (b, h_kv, S_loc, hd), every slot valid;
    ``seq_len``: the whole cross KV's S (default: its own length). Returns
    (b, h, 1, hd) in q's dtype. The reference's ``attention_scores``
    casts the probabilities to the cache's dtype before the second
    product; the kernel keeps them in fp32, so a bf16 cache agrees to bf16
    rounding and an fp32 one to fp32 rounding.

    The cross KV is laid out as the reference's ``cache_specs`` and
    divisibility rule lay it out (:func:`cross_kv_layout`): where the
    mesh's ``model`` axis holds n > 1 ranks that divide S it is split by
    sequence, every head whole, and this rank attends over all of its S /
    n slots through ``flash_decode_partial``, the ranks' partials merged
    by their softmax statistics (:func:`merge_partials`); otherwise it is
    whole and the flash-decode kernel runs at pos = S - 1, as without a
    mesh. On such a mesh `q` holds this rank's query heads: they are
    gathered over ``model`` for the attention and the output is cut back
    to them, as in :func:`decode_attention`."""
    n = model_size(mesh)
    nq = q.shape[1]
    if n > 1:
        q = all_gather(q, mesh, TP_AXIS, 1)
    b, hq, _, hd = q.shape
    S = xk.shape[2] if seq_len is None else seq_len
    split = n > 1 and S % n == 0
    if xk.shape[2] != (S // n if split else S):
        raise ValueError(f"cross_decode_attention: a cross KV of {S} slots "
                         f"over {n} ranks of the model axis holds "
                         f"{S // n if split else S} a rank, not "
                         f"{xk.shape[2]}")
    q3 = q.reshape(b, hq, hd).contiguous()
    if split:
        out = merge_partials(*flash_decode_partial(q3, xk, xv, S // n),
                             mesh).to(q.dtype)
    else:
        out = flash_decode(q3, xk, xv, S - 1)
    out = out.reshape(b, hq, 1, hd)
    return _own_heads(out, nq, mesh) if n > 1 else out


def cross_kv_layout(k: torch.Tensor, v: torch.Tensor, heads: int,
                    mesh=None) -> tuple:
    """The cross KV of one layer as the decode step reads it on `mesh`:
    k, v (b, h, S, hd) of every slot, h this rank's heads or all `heads`
    -> every head and, where ``model`` holds n > 1 ranks that divide S,
    this rank's S / n slots (the reference's ``cache_specs`` under its
    divisibility rule); all S otherwise. Heads split over ``model`` are
    gathered in one collective for k and v together."""
    n = model_size(mesh)
    if n == 1:
        return k, v
    if k.shape[1] < heads:
        kv = all_gather(torch.stack([k, v]), mesh, TP_AXIS, 2)
        k, v = kv[0], kv[1]
    S = k.shape[2]
    if S % n == 0:
        start = model_rank(mesh) * (S // n)
        k, v = (t[:, :, start:start + S // n] for t in (k, v))
    return k.contiguous(), v.contiguous()


def merge_partials(out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                   mesh) -> torch.Tensor:
    """The attention over a sequence split by ``model``, from each rank's
    partial over its shard (``flash_decode_partial``: out (b, h, hd), row
    maxima m and sums l (b, h) in fp32): one all-reduce max of the maxima
    and one all-reduce sum of the weighted outputs and sums packed
    together (the reference's pmax and two psums). Returns (b, h, hd) in
    fp32."""
    hd = out.shape[-1]
    w = l * torch.exp(m - all_reduce_max(m, mesh, TP_AXIS))
    acc = all_reduce_sum(torch.cat([w[..., None] * out.float(),
                                    w[..., None]], -1), mesh, TP_AXIS)
    return acc[..., :hd] / torch.clamp(acc[..., hd:], min=1e-30)


def _own_heads(x: torch.Tensor, nq: int, mesh) -> torch.Tensor:
    """This rank's `nq` heads (dim 1) of `x`, which holds every rank's."""
    r = model_rank(mesh)
    return x[:, r * nq:(r + 1) * nq]


def cached_attention_update(q, k_new, v_new, k_cache, v_cache, pos: int,
                            slot: int, mesh=None,
                            seq_len: Optional[int] = None) -> torch.Tensor:
    """One decode step against a KV cache, split by sequence over the
    mesh's ``model`` axis where it can be (the reference's decision).

    q: (b, h, 1, hd), every query head; k_new/v_new: (b, h_kv, 1, hd);
    k_cache/v_cache: this rank's (b, h_kv, S_loc, hd); ``seq_len``: the
    whole cache's S (default: the caches' own length). Returns (b, h, 1,
    hd); the new token's K/V are written in place.

    Where ``model`` holds n > 1 ranks and divides S, rank r holds slots
    r * S / n onwards: it writes the new token only if it owns ``slot``,
    attends over its valid slots through ``flash_decode_partial`` and the
    ranks merge their partials (:func:`merge_partials`). Else, as where
    the mesh is absent, the caches are whole and the local path runs. The
    reference takes its shard_map branch on a ``model`` axis of one rank
    too (the same math); here that axis takes the local path, so that a
    1x1 mesh is the meshless step, launch for launch."""
    S = k_cache.shape[2] if seq_len is None else seq_len
    n = model_size(mesh)
    if n == 1 or S % n:
        return _cached_attention_local(q, k_new, v_new, k_cache, v_cache,
                                       pos, slot)
    S_loc = S // n
    if k_cache.shape[2] != S_loc:
        raise ValueError(f"cached_attention_update: a cache of {S} slots "
                         f"over {n} ranks holds {S_loc} a rank, not "
                         f"{k_cache.shape[2]}")
    b, hq, _, hd = q.shape
    start = model_rank(mesh) * S_loc
    if 0 <= slot - start < S_loc:
        k_cache[:, :, slot - start] = k_new[:, :, 0].to(k_cache.dtype)
        v_cache[:, :, slot - start] = v_new[:, :, 0].to(v_cache.dtype)
    n_valid = min(max(pos + 1 - start, 0), S_loc)
    out = merge_partials(*flash_decode_partial(
        q.reshape(b, hq, hd).contiguous(), k_cache, v_cache, n_valid), mesh)
    return out.to(q.dtype).reshape(b, hq, 1, hd)


def _cached_attention_local(q, k_new, v_new, kc, vc, pos: int,
                            slot: int) -> torch.Tensor:
    """Single-shard cached attention: write the new token's K/V at
    ``slot``, then attend over slots 0..pos.

    q: (b, h, 1, hd); k_new/v_new: (b, h_kv, 1, hd); caches
    (b, h_kv, S, hd). Unlike JAX, which returns new cache arrays, the write
    is in place into ``kc``/``vc`` (views of the stacked cache). A slot
    outside 0..S-1 is not written, as in the reference."""
    b, hq, _, hd = q.shape
    if 0 <= slot < kc.shape[2]:
        kc[:, :, slot] = k_new[:, :, 0].to(kc.dtype)
        vc[:, :, slot] = v_new[:, :, 0].to(vc.dtype)
    out = flash_decode(q.reshape(b, hq, hd).contiguous(), kc, vc, pos)
    return out.reshape(b, hq, 1, hd)


def decode_attention(params: dict, x: torch.Tensor, cfg,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: int, slot: Optional[int] = None, mesh=None,
                     seq_len: Optional[int] = None) -> torch.Tensor:
    """Single-token GQA decode. x: (b, 1, d); caches: (b, h_kv, S, hd).

    ``pos`` is the true sequence position (drives RoPE and validity);
    ``slot`` is the cache slot to write (defaults to ``pos``; sliding-window
    archs pass ``pos % window``). Returns out (b, 1, d); the caches are
    updated in place.

    With a ``mesh`` whose ``model`` axis holds several ranks, ``params``
    are this rank's shards: wq (and bq) its columns, so its own query
    heads, wk/wv (bk/bv) too where they are split, wo its rows. The heads
    are gathered for the attention (``cached_attention_update``, the caches
    this rank's shards of a cache of ``seq_len`` slots), its output cut
    back to this rank's heads, and the products with wo summed over the
    ranks."""
    b = x.shape[0]
    if slot is None:
        slot = pos
    q, k, v = gqa_project(params, x, cfg)
    posb = torch.full((b, 1, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    tp = model_size(mesh) > 1
    if tp:
        nq = q.shape[1]
        q = all_gather(q, mesh, TP_AXIS, 1)
        if k.shape[1] < cfg.n_kv_heads:
            k = all_gather(k, mesh, TP_AXIS, 1)
            v = all_gather(v, mesh, TP_AXIS, 1)
    out = cached_attention_update(q, k, v, k_cache, v_cache, pos, slot, mesh,
                                  seq_len)
    if tp:
        out = _own_heads(out, nq, mesh)
    out = out.transpose(1, 2).reshape(b, 1, -1)
    out = matmul(out, params["wo"])
    return all_reduce_sum(out, mesh, TP_AXIS) if tp else out


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def swiglu(params: dict, x: torch.Tensor, mm=matmul) -> torch.Tensor:
    """SwiGLU FFN; `mm` is the product."""
    return mm(F.silu(mm(x, params["w_gate"])) * mm(x, params["w_up"]),
              params["w_down"])


def gelu_mlp(params: dict, x: torch.Tensor, mm=matmul,
             mesh=None) -> torch.Tensor:
    """Biased GELU MLP with the tanh approximation (``jax.nn.gelu``'s
    default; torch's default is the exact erf form); `mm` is the
    product. With a `mesh` (a ``model`` axis of several ranks at decode)
    `params` hold this rank's columns of w_up and b_up and rows of
    w_down: the product with w_down is summed over the ranks before the
    whole b_down is added, once."""
    y = mm(F.gelu(mm(x, params["w_up"]) + params["b_up"],
                  approximate="tanh"), params["w_down"])
    if mesh is not None:
        y = all_reduce_sum(y, mesh, TP_AXIS)
    return y + params["b_down"]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1) * scale drawn in fp32 on the generator's device, then
    cast; scale defaults to 1/sqrt(fan_in) with fan_in = shape[0]."""
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def attn_params(gen: torch.Generator, cfg, d_q_heads: int, d_kv_heads: int,
                dtype) -> dict:
    """GQA projection params; head counts may be TP-padded upstream."""
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, d_q_heads * hd), dtype),
        "wk": dense_init(gen, (d, d_kv_heads * hd), dtype),
        "wv": dense_init(gen, (d, d_kv_heads * hd), dtype),
        "wo": dense_init(gen, (d_q_heads * hd, d), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((d_q_heads * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((d_kv_heads * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((d_kv_heads * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def ffn_params(gen: torch.Generator, d_model: int, d_ff: int,
               dtype) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }
