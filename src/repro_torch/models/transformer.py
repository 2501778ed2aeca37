"""Dense / MoE decoder-only transformer LM (qwen2, minitron, h2o-danube,
qwen3, granite-moe, phi3.5-moe): init, the full-sequence ``forward``
(prefill), the KV cache and the single-token decode step.

The PyTorch counterpart of ``repro.models.transformer``. Parameters are a
dict of tensors with the reference's structure: the per-layer ``blocks``
leaves are stacked along a leading layer dim. ``forward`` runs its
products through torch.matmul (the JAX package has no prefill kernel) and
takes the reference's ``remat`` option (each block recomputed in the
backward, :func:`remat_call`); ``decode_step`` runs its weight products
through the row-stream kernel and its attention through the flash-decode
kernel.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import padded_heads, padded_vocab
from . import moe as moe_lib
from .layers import (attn_params, decode_attention, dense_init, ffn_params,
                     matmul, rmsnorm, self_attention, swiglu)

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

def init(cfg, gen: torch.Generator, tp: int = 1) -> dict:
    """Random parameters on ``gen``'s device, drawn as the reference draws
    them: normal/sqrt(fan_in) projections, embedding at 0.02, zero biases,
    unit norms; the query heads padded to a multiple of `tp`
    (``padded_heads``). (torch's generator gives other numbers than
    jax.random; tests move the reference's parameters across with
    ``repro_torch.bridge`` instead.)"""
    dt = _dtype(cfg)
    dev = gen.device
    nH = padded_heads(cfg.n_heads, tp)
    V = padded_vocab(cfg.vocab)

    def block_init():
        p = {
            "attn": attn_params(gen, cfg, nH, cfg.n_kv_heads, dt),
            "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "ffn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        }
        if cfg.moe:
            p["moe"] = moe_lib.moe_params(gen, cfg, dt)
        else:
            p["ffn"] = ffn_params(gen, cfg.d_model, cfg.d_ff, dt)
        return p

    params = {
        "embed": dense_init(gen, (V, cfg.d_model), dt, scale=0.02),
        "blocks": _stack([block_init() for _ in range(cfg.n_layers)]),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": dense_init(gen, (cfg.d_model, V), dt),
    }
    return params


def _stacked(specs: dict) -> dict:
    """Block specs with the leading (layer) dim of the stacked leaves."""
    return {k: _stacked(v) if isinstance(v, dict) else (None,) + v
            for k, v in specs.items()}


def attn_specs(cfg, fsdp, tp: int) -> dict:
    """Spec tuples of ``layers.attn_params``: q and o over ``model``, k
    and v too where the KV heads divide over TP."""
    hd = cfg.resolved_head_dim
    kv_shardable = (cfg.n_kv_heads * hd) % tp == 0 and cfg.n_kv_heads >= tp
    kv = "model" if kv_shardable else None
    attn = {"wq": (fsdp, "model"), "wk": (fsdp, kv), "wv": (fsdp, kv),
            "wo": ("model", fsdp)}
    if cfg.qkv_bias:
        attn |= {"bq": ("model",), "bk": (kv,), "bv": (kv,)}
    if cfg.qk_norm:
        attn |= {"q_norm": (None,), "k_norm": (None,)}
    return attn


def ffn_specs(fsdp) -> dict:
    return {"w_gate": (fsdp, "model"), "w_up": (fsdp, "model"),
            "w_down": ("model", fsdp)}


def param_specs(cfg, fsdp=None, tp: int = 16) -> dict:
    """Spec tuples mirroring init()'s structure (the reference's). `fsdp`
    is the mesh axis name for ZeRO-3 parameter sharding (None to
    replicate over data)."""
    block = {"attn": attn_specs(cfg, fsdp, tp), "attn_norm": (None,),
             "ffn_norm": (None,)}
    if cfg.moe:
        block["moe"] = moe_lib.moe_param_specs(cfg, fsdp, tp)
    else:
        block["ffn"] = ffn_specs(fsdp)
    specs = {
        "embed": ("model", fsdp),
        "blocks": _stacked(block),
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (fsdp, "model")
    return specs


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _block_forward(cfg, h: torch.Tensor, bp: dict,
                   positions: torch.Tensor) -> torch.Tensor:
    h = h + self_attention(bp["attn"], rmsnorm(h, bp["attn_norm"],
                                               cfg.norm_eps), cfg, positions)
    x = rmsnorm(h, bp["ffn_norm"], cfg.norm_eps)
    if cfg.moe:
        f = moe_lib.moe_ffn(bp["moe"], x, cfg, mm=torch.matmul)
    else:
        f = swiglu(bp["ffn"], x, torch.matmul)
    return h + f


def forward(params: dict, cfg, tokens: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """tokens: (b, s) int -> logits (b, s, V_padded). With `remat` each
    block is recomputed in the backward (the reference's jax.checkpoint of
    its block)."""
    b, s = tokens.shape
    h = params["embed"][tokens]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    for bp in _layers(params["blocks"]):
        h = remat_call(remat, _block_forward, cfg, h, bp, positions)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return torch.matmul(h, params["lm_head"])


def remat_call(remat: bool, fn, *args):
    """fn(*args), recomputed in the backward when `remat` (the
    counterpart of ``jax.checkpoint``). The forwards draw no random
    numbers, so no RNG state is kept for the recompute."""
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _layers(tree: dict) -> list[dict]:
    """The per-layer dicts of a stacked tree, each leaf unbound once along
    its layer dim. Under autograd the backward of one ``unbind`` is one
    ``stack`` into a buffer of the stacked leaf's size, where a slice per
    layer (:func:`_index`) would make a full-size zero gradient for each
    layer."""
    flat = {k: _layers(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    n = len(next(iter(flat.values())))
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda", tp: int = 1) -> dict:
    """Zeroed stacked KV cache (L, b, h_kv, S, hd). bf16 by default, also
    for an fp32 model, as in the reference. With a sliding window S is the
    window and the cache is a ring buffer. `tp` changes nothing: the KV
    heads are not padded (``padded_kv_heads``)."""
    hd = cfg.resolved_head_dim
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_specs(cfg) -> dict:
    """The KV cache's spec tuples (the reference's): batch over the DP
    axes, sequence over ``model`` (its context-parallel decode; the port's
    decode runs on whole caches)."""
    s = (None, ("pod", "data"), None, "model", None)
    return {"k": s, "v": s}


def block_decode(cfg, h: torch.Tensor, bp: dict, kc: torch.Tensor,
                 vc: torch.Tensor, pos: int, slot: int) -> torch.Tensor:
    """One layer of the decode step: h (b, 1, d) -> (b, 1, d); writes the
    new token's K/V into this layer's caches kc/vc at `slot`."""
    x = rmsnorm(h, bp["attn_norm"], cfg.norm_eps)
    h = h + decode_attention(bp["attn"], x, cfg, kc, vc, pos, slot)
    x = rmsnorm(h, bp["ffn_norm"], cfg.norm_eps)
    f = moe_lib.moe_ffn(bp["moe"], x, cfg) if cfg.moe \
        else swiglu(bp["ffn"], x)
    return h + f


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
        h = block_decode(cfg, h, _index(blocks, i), cache["k"][i],
                         cache["v"][i], pos, slot)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return matmul(h, params["lm_head"]), cache


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
