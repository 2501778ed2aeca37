"""Shared model layers of the decode path: norms, rotary embeddings, GQA
projection, cached decode attention, SwiGLU and the dense initializer.

The PyTorch counterpart of ``repro.models.layers``, function for function,
with the same cast order so that bf16 rounds at the same places. Every
weight product goes through the row-stream matmul kernel and the cached
attention through the flash-decode kernel; their wrappers launch the CUDA
kernels for CUDA tensors and run the plain versions for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_decode.ops import flash_decode
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
# Attention
# ---------------------------------------------------------------------------

def gqa_project(params: dict, x: torch.Tensor, cfg) -> tuple:
    """Project hidden states to q/k/v heads: returns (q, k, v) shaped
    (b, h, s, hd) / (b, h_kv, s, hd)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = matmul(x, params["wq"])
    k = matmul(x, params["wk"])
    v = matmul(x, params["wv"])
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
                     pos: int, slot: Optional[int] = None) -> torch.Tensor:
    """Single-token GQA decode. x: (b, 1, d); caches: (b, h_kv, S, hd).

    ``pos`` is the true sequence position (drives RoPE and validity);
    ``slot`` is the cache slot to write (defaults to ``pos``; sliding-window
    archs pass ``pos % window``). Returns out (b, 1, d); the caches are
    updated in place."""
    b = x.shape[0]
    if slot is None:
        slot = pos
    q, k, v = gqa_project(params, x, cfg)
    posb = torch.full((b, 1, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    out = _cached_attention_local(q, k, v, k_cache, v_cache, pos, slot)
    out = out.transpose(1, 2).reshape(b, 1, -1)
    return matmul(out, params["wo"])


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    return matmul(F.silu(matmul(x, params["w_gate"]))
                  * matmul(x, params["w_up"]), params["w_down"])


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
