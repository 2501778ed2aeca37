"""Llama-3.2-Vision backbone: a dense GQA decoder with a cross-attention
layer after every ``cross_attn_every - 1`` self-attention layers (pattern
unit = (cross_attn_every - 1) self layers + 1 cross layer).

The PyTorch counterpart of ``repro.models.mllama``, function for function,
with the same cast order. The vision frontend is a stub, as in the
reference: callers give precomputed patch embeddings
(b, n_vision_tokens, d_model). The cross layers attend to them and gate
their attention and FFN contributions with fp32 scalar tanh gates (zero at
init); the gate is taken in fp32, cast to the residual's dtype, then
multiplied.

A self layer is the dense transformer's block (``transformer._block_forward``
at prefill, ``transformer.block_decode`` at decode). ``forward`` (prefill)
is plain torch ops with torch.matmul products: the JAX package has no
prefill kernel. In ``decode_step`` every weight product goes through
``layers.matmul`` (the row-stream kernel), the self-attention through
``layers.decode_attention`` and the cross-attention against the cached
vision KV through ``layers.cross_decode_attention``, so both through the
flash-decode kernel. ``precompute_cross_kv`` fills that KV once per
request; the serve driver, as the reference's, never calls it.

Parameters are a dict of tensors with the reference's structure: stacked
``self_blocks`` (n_units * (k - 1), ...) and ``cross_blocks`` (n_units,
...), the gates stacked as (n_units,) fp32. ``forward`` takes the
reference's ``remat`` option (each self and cross layer recomputed in the
backward). ``param_specs`` and ``cache_specs`` are the reference's: on a
mesh whose ``model`` axis holds several ranks, ``decode_step`` computes on
each rank's shards (the dense family's split for the self layers, the
cross layers' query heads and SwiGLU columns, the head's columns, the
embedding's vocab rows), its slots of the self KV, and its tokens of the
cross KV where the axis divides them (``init_cache``,
``precompute_cross_kv`` with ``mesh``). ``forward`` on shards is the
training slice's.
"""
from __future__ import annotations

import torch

from ..distributed.sharding import (TP_AXIS, all_gather, all_reduce_sum,
                                    local, model_size, padded_heads,
                                    padded_vocab)
from .layers import (attn_params, cross_attention, cross_decode_attention,
                     cross_kv_layout, dense_init, ffn_params, matmul,
                     rmsnorm, swiglu)
from .transformer import (_block_forward, _dtype, _embed, _index, _layers,
                          _stack, _stacked, attn_specs, block_decode,
                          ffn_specs, mesh_cache, remat_call)


def _pattern(cfg) -> tuple[int, int]:
    """(k, n_units): k layers a pattern unit, the last of them cross."""
    k = cfg.cross_attn_every
    return k, cfg.n_layers // k


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _self_block_init(gen: torch.Generator, cfg, nH: int, dt) -> dict:
    dev = gen.device
    return {
        "attn": attn_params(gen, cfg, nH, cfg.n_kv_heads, dt),
        "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "ffn": ffn_params(gen, cfg.d_model, cfg.d_ff, dt),
        "ffn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }


def _cross_block_init(gen: torch.Generator, cfg, nH: int, dt) -> dict:
    p = _self_block_init(gen, cfg, nH, dt)
    p["gate_attn"] = torch.zeros((), dtype=torch.float32, device=gen.device)
    p["gate_ffn"] = torch.zeros((), dtype=torch.float32, device=gen.device)
    return p


def init(cfg, gen: torch.Generator, tp: int = 1) -> dict:
    """Random parameters on ``gen``'s device with the reference's structure
    and scales: normal/sqrt(fan_in) projections, the embedding at 0.02,
    unit norms, zero fp32 gates; the query heads padded to a multiple of
    `tp`."""
    dt = _dtype(cfg)
    nH = padded_heads(cfg.n_heads, tp)
    k, n_units = _pattern(cfg)
    V = padded_vocab(cfg.vocab)
    embed = dense_init(gen, (V, cfg.d_model), dt, scale=0.02)
    self_blocks = _stack([_self_block_init(gen, cfg, nH, dt)
                          for _ in range(n_units * (k - 1))])
    cross_blocks = _stack([_cross_block_init(gen, cfg, nH, dt)
                           for _ in range(n_units)])
    return {
        "embed": embed,
        "self_blocks": self_blocks,
        "cross_blocks": cross_blocks,
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
        "lm_head": dense_init(gen, (cfg.d_model, V), dt),
    }


def param_specs(cfg, fsdp=None, tp: int = 16) -> dict:
    """Spec tuples mirroring init()'s structure (the reference's)."""
    attn = attn_specs(cfg, fsdp, tp)
    base = {"attn": {k: attn[k] for k in ("wq", "wk", "wv", "wo")},
            "attn_norm": (None,), "ffn": ffn_specs(fsdp),
            "ffn_norm": (None,)}
    cross = base | {"gate_attn": (), "gate_ffn": ()}
    return {
        "embed": ("model", fsdp),
        "self_blocks": _stacked(base),
        "cross_blocks": _stacked(cross),
        "final_norm": (None,),
        "lm_head": (fsdp, "model"),
    }


def _gate(gate: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """tanh of an fp32 gate, cast to h's dtype (the reference's order)."""
    return torch.tanh(gate).to(h.dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _cross_fwd(cfg, h: torch.Tensor, bp: dict,
               vision: torch.Tensor) -> torch.Tensor:
    a = cross_attention(bp["attn"], rmsnorm(h, bp["attn_norm"], cfg.norm_eps),
                        vision, cfg)
    h = h + _gate(bp["gate_attn"], h) * a
    f = swiglu(bp["ffn"], rmsnorm(h, bp["ffn_norm"], cfg.norm_eps),
               torch.matmul)
    return h + _gate(bp["gate_ffn"], h) * f


def forward(params: dict, cfg, tokens: torch.Tensor,
            vision_embeds: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """tokens: (b, s); vision_embeds: (b, n_vis, d_model) -> logits
    (b, s, V_padded). With `remat` each self and cross layer is recomputed
    in the backward."""
    b, s = tokens.shape
    k, n_units = _pattern(cfg)
    h = params["embed"][tokens]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    selfs = _layers(params["self_blocks"])
    crosses = _layers(params["cross_blocks"])
    for u in range(n_units):
        for j in range(k - 1):
            h = remat_call(remat, _block_forward, cfg, h,
                           selfs[u * (k - 1) + j], positions)
        h = remat_call(remat, _cross_fwd, cfg, h, crosses[u], vision_embeds)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return torch.matmul(h, params["lm_head"])


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda", tp: int = 1, mesh=None) -> dict:
    """Zeroed stacked caches: self KV (n_self, b, h_kv, max_seq, hd) and
    cross KV (n_units, b, h_kv, n_vision_tokens, hd). bf16 by default, also
    for an fp32 model, as in the reference. `tp` changes nothing: the KV
    heads are not padded.

    On a `mesh`, this rank's shard under ``cache_specs``
    (``transformer.mesh_cache``): its rows of the batch and, where
    ``model`` holds n > 1 ranks, the self KV's max_seq / n slots and the
    cross KV's n_vision_tokens / n tokens wherever n divides them, every
    KV head whole. The 1601 vision tokens of llama-3.2-vision divide over
    neither 2 nor 4 ranks, so there every rank holds the whole cross KV,
    as the reference's divisibility rule keeps it."""
    k, n_units = _pattern(cfg)
    hd = cfg.resolved_head_dim
    self_shape = (n_units * (k - 1), batch, cfg.n_kv_heads, max_seq, hd)
    cross_shape = (n_units, batch, cfg.n_kv_heads, cfg.n_vision_tokens, hd)
    shapes = {"k": self_shape, "v": self_shape, "xk": cross_shape,
              "xv": cross_shape}
    if mesh is None:
        return {key: torch.zeros(s, dtype=dtype, device=device)
                for key, s in shapes.items()}
    return mesh_cache(shapes, cache_specs(cfg)["k"], dtype, device, mesh)


def cache_specs(cfg) -> dict:
    """The caches' spec tuples (the reference's): batch over the DP axes,
    the self KV's slots and the cross KV's vision tokens over ``model``."""
    s = (None, ("pod", "data"), None, "model", None)
    return {"k": s, "v": s, "xk": s, "xv": s}


def precompute_cross_kv(params: dict, cfg, vision_embeds: torch.Tensor,
                        mesh=None) -> tuple:
    """Each cross layer's K and V of the vision embeddings, stacked:
    (n_units, b, h_kv, n_vis, hd) each, in the projection's dtype (the
    caller writes them into a cache of its own dtype).

    On a `mesh` whose ``model`` axis holds n > 1 ranks, `params` are this
    rank's shards (``param_specs(tp=n)``: wk and wv split by KV heads
    where they divide over n, else whole) and `vision_embeds` its rows of
    the batch: it projects its KV heads for every token, then each
    layer's heads are gathered over ``model`` (where split) and this rank
    keeps its tokens of the cache's layout (``layers.cross_kv_layout``:
    n_vis / n of them where n divides n_vis, else all)."""
    hd = cfg.resolved_head_dim
    b, nv, _ = vision_embeds.shape
    cross = params["cross_blocks"]
    ks, vs = [], []
    for u in range(cross["attn_norm"].shape[0]):
        a = _index(cross, u)["attn"]
        k, v = (torch.matmul(vision_embeds, a[w]).reshape(
            b, nv, -1, hd).transpose(1, 2) for w in ("wk", "wv"))
        k, v = cross_kv_layout(k, v, cfg.n_kv_heads, mesh)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def _cross_decode(cfg, h: torch.Tensor, bp: dict, xk: torch.Tensor,
                  xv: torch.Tensor, mesh=None,
                  seq_len: int | None = None) -> torch.Tensor:
    """Single-token cross layer against the cached vision KV. As in the
    reference, no qk_norm is applied here (``cross_attention`` applies
    it; no vlm config sets it).

    With a `mesh` (a ``model`` axis of several ranks) `bp` holds this
    rank's shards: the query heads of its wq columns attend over xk/xv as
    ``layers.cross_decode_attention`` lays out a cross KV of `seq_len`
    tokens; the products with wo's rows and the SwiGLU's row-parallel
    output are each summed over ``model`` before the fp32 tanh gate
    multiplies them, so that the gate sees them whole, as in the
    reference."""
    b = h.shape[0]
    hd = cfg.resolved_head_dim
    x = rmsnorm(h, bp["attn_norm"], cfg.norm_eps)
    q = matmul(x, bp["attn"]["wq"]).reshape(b, 1, -1, hd).transpose(1, 2)
    out = cross_decode_attention(q, xk, xv, mesh, seq_len).transpose(
        1, 2).reshape(b, 1, -1)
    a = matmul(out, bp["attn"]["wo"])
    if mesh is not None:
        a = all_reduce_sum(a, mesh, TP_AXIS)
    h = h + _gate(bp["gate_attn"], h) * a
    f = swiglu(bp["ffn"], rmsnorm(h, bp["ffn_norm"], cfg.norm_eps))
    if mesh is not None:
        f = all_reduce_sum(f, mesh, TP_AXIS)
    return h + _gate(bp["gate_ffn"], h) * f


def decode_step(params: dict, cfg, token: torch.Tensor, cache: dict,
                pos: int, mesh=None) -> tuple:
    """token: (b, 1) int; pos: host int. Returns (logits (b, 1, V_padded),
    cache); the self KV is written in place, the cross KV only read.

    On a `mesh` the tokens, the cache (``init_cache(mesh=...)``) and the
    logits are this rank's rows. Where ``model`` holds one rank the step
    is the meshless one. Where it holds n > 1, `params` are this rank's
    shards under ``param_specs(tp=n)`` (query heads padded by
    ``init(tp=n)``; :func:`check_decode_shards`): the vocab-parallel
    embedding (``transformer._embed``), each self layer as the dense
    family's tensor- and context-parallel ``block_decode``, each cross
    layer on its shards (:func:`_cross_decode`), and the head's columns,
    whose logits are gathered over ``model``."""
    n = model_size(mesh)
    tp = mesh if n > 1 else None
    if tp is not None:
        check_decode_shards(params, cfg, n)
    k, n_units = _pattern(cfg)
    kc, vc, xk, xv = (local(cache[key]) for key in ("k", "v", "xk", "xv"))
    S, n_vis = cache["k"].shape[3], cache["xk"].shape[3]
    h = _embed(params["embed"], token, cfg, tp)
    for u in range(n_units):
        for j in range(k - 1):
            i = u * (k - 1) + j
            h = block_decode(cfg, h, _index(params["self_blocks"], i),
                             kc[i], vc[i], pos, pos, tp, S)
        h = _cross_decode(cfg, h, _index(params["cross_blocks"], u),
                          xk[u], xv[u], tp, n_vis)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = matmul(h, params["lm_head"])
    if tp is not None:
        logits = all_gather(logits, tp, TP_AXIS, -1)
    return logits, cache


def check_decode_shards(params: dict, cfg, n: int) -> None:
    """Raise unless `params` hold this rank's shards of a ``model`` axis of
    n ranks as ``init(tp=n)`` and ``param_specs`` make them: 1/n of the
    self and cross layers' query heads and SwiGLU width, of the head's
    columns and of the embedding's vocab rows."""
    cols = padded_heads(cfg.n_heads, n) * cfg.resolved_head_dim
    V = padded_vocab(cfg.vocab)
    got, want = {}, {}
    for blocks in ("self_blocks", "cross_blocks"):
        bp = params[blocks]
        got[f"{blocks}/attn/wq"] = bp["attn"]["wq"].shape[-1]
        got[f"{blocks}/ffn/w_gate"] = bp["ffn"]["w_gate"].shape[-1]
        want[f"{blocks}/attn/wq"] = cols // n
        want[f"{blocks}/ffn/w_gate"] = cfg.d_ff // n
    got |= {"embed": params["embed"].shape[0],
            "lm_head": params["lm_head"].shape[-1]}
    want |= {"embed": V // n, "lm_head": V // n}
    if got != want:
        raise ValueError(f"{cfg.name}: split leaves hold {got} on this "
                         f"rank; a model axis of {n} ranks needs {want} "
                         f"(parameters from init(tp={n}), placed by "
                         f"param_specs)")
