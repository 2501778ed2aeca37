"""Dense decoder-only transformer LM: init, KV cache and the single-token
decode step (qwen2, qwen3, minitron, h2o-danube).

The PyTorch counterpart of ``repro.models.transformer``. Parameters are a
dict of tensors with the reference's structure: the per-layer ``blocks``
leaves are stacked along a leading layer dim. The full-sequence ``forward``
(train / prefill) is not ported yet.
"""
from __future__ import annotations

import torch

from ..distributed.sharding import padded_vocab
from .layers import (attn_params, decode_attention, dense_init, ffn_params,
                     matmul, rmsnorm, swiglu)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _stack(trees: list) -> dict:
    """List of same-structured dicts -> one dict of stacked tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg, gen: torch.Generator) -> dict:
    """Random parameters on ``gen``'s device, drawn as the reference draws
    them: normal/sqrt(fan_in) projections, embedding at 0.02, zero biases,
    unit norms. (torch's generator gives other numbers than jax.random;
    tests move the reference's parameters across with ``repro_torch.bridge``
    instead.)"""
    dt = _dtype(cfg)
    dev = gen.device
    V = padded_vocab(cfg.vocab)

    def block_init():
        return {
            "attn": attn_params(gen, cfg, cfg.n_heads, cfg.n_kv_heads, dt),
            "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "ffn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "ffn": ffn_params(gen, cfg.d_model, cfg.d_ff, dt),
        }

    params = {
        "embed": dense_init(gen, (V, cfg.d_model), dt, scale=0.02),
        "blocks": _stack([block_init() for _ in range(cfg.n_layers)]),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": dense_init(gen, (cfg.d_model, V), dt),
    }
    return params


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """Zeroed stacked KV cache (L, b, h_kv, S, hd). bf16 by default, also
    for an fp32 model, as in the reference. With a sliding window S is the
    window and the cache is a ring buffer."""
    hd = cfg.resolved_head_dim
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params: dict, cfg, token: torch.Tensor, cache: dict,
                pos: int) -> tuple:
    """token: (b, 1) int; pos: host int. Returns (logits (b, 1, V_padded),
    cache).

    The cache is updated in place, one slot per layer (JAX returns a new
    cache); the returned cache is the same dict. With a sliding window the
    slot is ``pos % S``."""
    h = params["embed"][token]
    L = cache["k"].shape[0]
    S = cache["k"].shape[3]
    slot = pos % S if cfg.sliding_window else pos
    blocks = params["blocks"]
    for i in range(L):
        bp = _index(blocks, i)
        x = rmsnorm(h, bp["attn_norm"], cfg.norm_eps)
        a = decode_attention(bp["attn"], x, cfg, cache["k"][i],
                             cache["v"][i], pos, slot)
        h = h + a
        x = rmsnorm(h, bp["ffn_norm"], cfg.norm_eps)
        h = h + swiglu(bp["ffn"], x)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return matmul(h, params["lm_head"]), cache


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
