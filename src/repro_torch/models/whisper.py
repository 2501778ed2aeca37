"""Whisper-small backbone: encoder-decoder transformer (arXiv:2212.04356).
12 encoder + 12 decoder layers, d_model 768, 12 heads, d_ff 3072,
vocab 51865 (padded to 51968).

The PyTorch counterpart of ``repro.models.whisper``, function for
function, with the same cast order. The conv frontend is a stub, as in
the reference: callers give precomputed frame embeddings
(b, n_audio_frames, d_model). Positions are sinusoidal on both sides,
blocks are pre-LN (LayerNorm at a fixed eps of 1e-5) with biased
projections and tanh-approximated GELU MLPs, and the decoder's head ties
the token embedding.

``encode`` and ``forward`` (prefill) are plain torch ops with torch.matmul
products, as the other families' prefills: the JAX package has no prefill
kernel. In ``decode_step`` every weight product goes through
``layers.matmul`` (the row-stream kernel), the head included: it reads
:func:`tied_head`, a contiguous copy of ``embed.T`` made once per
parameter set. The self-attention goes through
``layers.cached_attention_update`` and the cross-attention through
``layers.cross_decode_attention``, so both through the flash-decode kernel.
``precompute_cross_kv`` fills the cross KV from the encoder output; the
serve driver, as the reference's, never calls it.

Parameters are a dict of tensors with the reference's structure, the
per-layer ``encoder`` and ``decoder`` leaves stacked along a leading layer
dim. ``encode`` and ``forward`` take the reference's ``remat`` option (each
encoder and decoder block recomputed in the backward). ``param_specs`` and
``cache_specs`` are the reference's: on a mesh whose ``model`` axis holds
several ranks, ``decode_step`` computes on each rank's shards (its heads,
its columns of the MLP, its vocab rows of the tied embedding) and its
slots of the self KV, and its frames of the cross KV where the axis
divides them (``init_cache``, ``precompute_cross_kv`` with ``mesh``). The
encoder and ``forward`` on shards are the training slice's.
"""
from __future__ import annotations

import math

import torch

from ..distributed.sharding import (TP_AXIS, all_gather, all_reduce_sum,
                                    local, model_size, padded_heads,
                                    padded_vocab)
from .layers import (CHUNKED_ATTN_THRESHOLD, _own_heads, attention_scores,
                     cached_attention_update, causal_mask, chunked_attention,
                     cross_decode_attention, cross_kv_layout, dense_init,
                     gelu_mlp, layernorm, matmul)
from .transformer import (_dtype, _embed, _index, _layers, _stack, _stacked,
                          mesh_cache, remat_call)


def sinusoid_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., s) int -> (..., s, d) float32 sinusoidal embeddings."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / (half - 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _attn_init(gen: torch.Generator, cfg, nH: int, dt) -> dict:
    d = cfg.d_model
    n = nH * cfg.resolved_head_dim
    dev = gen.device
    return {
        "wq": dense_init(gen, (d, n), dt),
        "bq": torch.zeros((n,), dtype=dt, device=dev),
        "wk": dense_init(gen, (d, n), dt),
        "wv": dense_init(gen, (d, n), dt),
        "bv": torch.zeros((n,), dtype=dt, device=dev),
        "wo": dense_init(gen, (n, d), dt),
        "bo": torch.zeros((d,), dtype=dt, device=dev),
    }


def _mlp_init(gen: torch.Generator, cfg, dt) -> dict:
    dev = gen.device
    return {
        "w_up": dense_init(gen, (cfg.d_model, cfg.d_ff), dt),
        "b_up": torch.zeros((cfg.d_ff,), dtype=dt, device=dev),
        "w_down": dense_init(gen, (cfg.d_ff, cfg.d_model), dt),
        "b_down": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }


def _ln_init(cfg, dt, dev) -> dict:
    return {"w": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "b": torch.zeros((cfg.d_model,), dtype=dt, device=dev)}


def init(cfg, gen: torch.Generator, tp: int = 1) -> dict:
    """Random parameters on ``gen``'s device with the reference's structure
    and scales: normal/sqrt(fan_in) projections, the embedding at 0.02,
    zero biases and LayerNorm shifts, unit LayerNorm scales. The heads
    (the KV heads are the query heads) are padded to a multiple of
    `tp`."""
    dt = _dtype(cfg)
    dev = gen.device
    nH = padded_heads(cfg.n_heads, tp)

    def enc_block():
        return {"attn": _attn_init(gen, cfg, nH, dt),
                "ln_attn": _ln_init(cfg, dt, dev),
                "mlp": _mlp_init(gen, cfg, dt),
                "ln_mlp": _ln_init(cfg, dt, dev)}

    def dec_block():
        return {"attn": _attn_init(gen, cfg, nH, dt),
                "ln_attn": _ln_init(cfg, dt, dev),
                "xattn": _attn_init(gen, cfg, nH, dt),
                "ln_xattn": _ln_init(cfg, dt, dev),
                "mlp": _mlp_init(gen, cfg, dt),
                "ln_mlp": _ln_init(cfg, dt, dev)}

    return {
        "embed": dense_init(gen, (padded_vocab(cfg.vocab), cfg.d_model), dt,
                            scale=0.02),
        "encoder": _stack([enc_block() for _ in range(cfg.encoder_layers)]),
        "decoder": _stack([dec_block() for _ in range(cfg.n_layers)]),
        "ln_enc": _ln_init(cfg, dt, dev),
        "ln_dec": _ln_init(cfg, dt, dev),
    }


def param_specs(cfg, fsdp=None, tp: int = 16) -> dict:
    """Spec tuples mirroring init()'s structure (the reference's)."""
    attn = {"wq": (fsdp, "model"), "bq": ("model",), "wk": (fsdp, "model"),
            "wv": (fsdp, "model"), "bv": ("model",), "wo": ("model", fsdp),
            "bo": (None,)}
    mlp = {"w_up": (fsdp, "model"), "b_up": ("model",),
           "w_down": ("model", fsdp), "b_down": (None,)}
    ln = {"w": (None,), "b": (None,)}
    enc = {"attn": attn, "ln_attn": ln, "mlp": mlp, "ln_mlp": ln}
    dec = enc | {"xattn": attn, "ln_xattn": ln}
    return {"embed": ("model", fsdp), "encoder": _stacked(enc),
            "decoder": _stacked(dec), "ln_enc": ln, "ln_dec": ln}


def tied_head(embed: torch.Tensor) -> torch.Tensor:
    """The decode head: ``embed.T`` (d, V) made contiguous, as
    rowstream_matmul requires. Made once per embedding tensor and kept on
    that tensor (attribute ``_tied_head``), so it lives as long as the
    parameters and no step copies it. Made again if the embedding was
    changed in place since, as its version counter shows. An inference
    tensor has no version counter, so such an embedding is refused: make
    the parameters outside ``torch.inference_mode``."""
    if embed.is_inference():
        raise ValueError("tied_head: the embedding is an inference tensor, "
                         "whose in-place changes cannot be seen; make the "
                         "parameters outside torch.inference_mode")
    version = embed._version
    kept = getattr(embed, "_tied_head", None)
    if kept is None or kept[0] != version:
        kept = (version, embed.T.contiguous())
        embed._tied_head = kept
    return kept[1]


# ---------------------------------------------------------------------------
# Attention helpers (biased projections, whisper-style)
# ---------------------------------------------------------------------------

def _heads(cfg, x: torch.Tensor, w: torch.Tensor, b=None,
           mm=torch.matmul) -> torch.Tensor:
    bsz, s, _ = x.shape
    y = mm(x, w)
    if b is not None:
        y = y + b
    return y.reshape(bsz, s, -1, cfg.resolved_head_dim).transpose(1, 2)


def _attn(params: dict, cfg, x: torch.Tensor, kv: torch.Tensor, mask,
          causal: bool = False) -> torch.Tensor:
    """Full-sequence attention of `x` over `kv`, products through
    torch.matmul. Long causal self-attention takes the chunked
    online-softmax path, as in the reference."""
    q = _heads(cfg, x, params["wq"], params["bq"])
    k = _heads(cfg, kv, params["wk"])
    v = _heads(cfg, kv, params["wv"], params["bv"])
    if causal and x.shape[1] >= CHUNKED_ATTN_THRESHOLD:
        out = chunked_attention(q, k, v)
    else:
        out = attention_scores(q, k, v, mask)
    b, h, s, hd = out.shape
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return torch.matmul(out, params["wo"]) + params["bo"]


def _ln(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return layernorm(x, p["w"], p["b"], eps)


# ---------------------------------------------------------------------------
# Encoder / decoder
# ---------------------------------------------------------------------------

def _enc_block(cfg, h: torch.Tensor, bp: dict) -> torch.Tensor:
    x = _ln(bp["ln_attn"], h)
    h = h + _attn(bp["attn"], cfg, x, x, None)
    return h + gelu_mlp(bp["mlp"], _ln(bp["ln_mlp"], h), torch.matmul)


def encode(params: dict, cfg, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """frames: (b, n_frames, d_model) stub embeddings -> encoder output.
    With `remat` each block is recomputed in the backward."""
    b, s, _ = frames.shape
    pos = torch.arange(s, device=frames.device).expand(b, s)
    h = frames + sinusoid_pos(pos, cfg.d_model).to(frames.dtype)
    for bp in _layers(params["encoder"]):
        h = remat_call(remat, _enc_block, cfg, h, bp)
    return _ln(params["ln_enc"], h)


def _dec_block(cfg, h: torch.Tensor, bp: dict, enc: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    x = _ln(bp["ln_attn"], h)
    h = h + _attn(bp["attn"], cfg, x, x, mask, causal=True)
    h = h + _attn(bp["xattn"], cfg, _ln(bp["ln_xattn"], h), enc, None)
    return h + gelu_mlp(bp["mlp"], _ln(bp["ln_mlp"], h), torch.matmul)


def forward(params: dict, cfg, tokens: torch.Tensor, frames: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """Teacher-forced forward: (b, s) tokens + frames -> logits
    (b, s, V_padded). With `remat` each encoder and decoder block is
    recomputed in the backward."""
    enc = encode(params, cfg, frames, remat)
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    h = params["embed"][tokens] + sinusoid_pos(pos, cfg.d_model).to(
        _dtype(cfg))
    mask = causal_mask(s, s, device=tokens.device)
    for bp in _layers(params["decoder"]):
        h = remat_call(remat, _dec_block, cfg, h, bp, enc, mask)
    h = _ln(params["ln_dec"], h)
    return torch.matmul(h, params["embed"].T)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda", tp: int = 1, mesh=None) -> dict:
    """Zeroed stacked caches: self KV (L, b, h, max_seq, hd) and cross KV
    (L, b, h, n_audio_frames, hd), the KV heads being the query heads,
    padded to a multiple of `tp` as init pads them. bf16 by default, also
    for an fp32 model, as in the reference.

    On a `mesh`, this rank's shard under ``cache_specs``
    (``transformer.mesh_cache``): its rows of the batch and, where
    ``model`` holds n > 1 ranks, the self KV's max_seq / n slots and the
    cross KV's n_audio_frames / n frames wherever n divides them, every
    head whole (padded to a multiple of n, as ``init(tp=n)`` pads
    them)."""
    hd, L = cfg.resolved_head_dim, cfg.n_layers
    n = model_size(mesh)
    nH = padded_heads(cfg.n_heads, n if n > 1 else tp)
    self_shape = (L, batch, nH, max_seq, hd)
    cross_shape = (L, batch, nH, cfg.n_audio_frames, hd)
    shapes = {"k": self_shape, "v": self_shape, "xk": cross_shape,
              "xv": cross_shape}
    if mesh is None:
        return {k: torch.zeros(s, dtype=dtype, device=device)
                for k, s in shapes.items()}
    return mesh_cache(shapes, cache_specs(cfg)["k"], dtype, device, mesh)


def cache_specs(cfg) -> dict:
    """The caches' spec tuples (the reference's): batch over the DP axes,
    the self KV's slots and the cross KV's frames over ``model``."""
    s = (None, ("pod", "data"), None, "model", None)
    return {"k": s, "v": s, "xk": s, "xv": s}


def precompute_cross_kv(params: dict, cfg, enc_out: torch.Tensor,
                        mesh=None) -> tuple:
    """Each decoder layer's cross K and V of the encoder output, stacked:
    (L, b, h, n_frames, hd) each, in the projection's dtype (the caller
    writes them into a cache of its own dtype).

    On a `mesh` whose ``model`` axis holds n > 1 ranks, `params` are this
    rank's shards (``param_specs(tp=n)``) and `enc_out` its rows of the
    batch: it projects its heads for every frame, then each layer's heads
    are gathered over ``model`` and this rank keeps its frames of the
    cache's layout (``layers.cross_kv_layout``: n_frames / n of them
    where n divides n_frames, else all)."""
    dec = params["decoder"]
    heads = padded_heads(cfg.n_heads, model_size(mesh))
    ks, vs = [], []
    for i in range(dec["ln_attn"]["w"].shape[0]):
        xa = _index(dec, i)["xattn"]
        k, v = cross_kv_layout(_heads(cfg, enc_out, xa["wk"]),
                               _heads(cfg, enc_out, xa["wv"], xa["bv"]),
                               heads, mesh)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def _out(out: torch.Tensor, p: dict, mesh) -> torch.Tensor:
    """The attention output (b, h, 1, hd) through wo, summed over
    ``model`` where `mesh` is given (wo this rank's rows), then bo, which
    the reference leaves whole, added once."""
    b = out.shape[0]
    y = matmul(out.transpose(1, 2).reshape(b, 1, -1), p["wo"])
    if mesh is not None:
        y = all_reduce_sum(y, mesh, TP_AXIS)
    return y + p["bo"]


def dec_block_step(cfg, h: torch.Tensor, bp: dict, kc: torch.Tensor,
                   vc: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                   pos: int, mesh=None, seq_len: int | None = None,
                   frames: int | None = None) -> torch.Tensor:
    """One decoder layer of the decode step: h (b, 1, d) -> (b, 1, d);
    writes the new token's K/V into this layer's caches kc/vc at `pos` and
    attends over the cross KV xk/xv.

    With a `mesh` (a ``model`` axis of several ranks) `bp` holds this
    rank's shards: the columns of wq, bq, wk, wv, bv (its own heads) and
    w_up, b_up, the rows of wo and w_down. q, k and v are gathered over
    ``model`` in one collective for ``cached_attention_update`` on kc/vc,
    this rank's shards of caches of `seq_len` slots; the cross attention
    takes xk/xv as ``layers.cross_decode_attention`` lays out a cross KV
    of `frames` frames; each row-parallel product is summed over the
    ranks before its whole bias is added."""
    a, xa = bp["attn"], bp["xattn"]
    x = _ln(bp["ln_attn"], h)
    q = _heads(cfg, x, a["wq"], a["bq"], matmul)
    k = _heads(cfg, x, a["wk"], None, matmul)
    v = _heads(cfg, x, a["wv"], a["bv"], matmul)
    nq = q.shape[1]
    if mesh is not None:
        q, k, v = all_gather(torch.stack([q, k, v]), mesh, TP_AXIS,
                             2).unbind(0)
    out = cached_attention_update(q, k, v, kc, vc, pos, pos, mesh, seq_len)
    if mesh is not None:
        out = _own_heads(out, nq, mesh)
    h = h + _out(out, a, mesh)
    xq = _heads(cfg, _ln(bp["ln_xattn"], h), xa["wq"], xa["bq"], matmul)
    h = h + _out(cross_decode_attention(xq, xk, xv, mesh, frames), xa, mesh)
    return h + gelu_mlp(bp["mlp"], _ln(bp["ln_mlp"], h), mesh=mesh)


def decode_step(params: dict, cfg, token: torch.Tensor, cache: dict,
                pos: int, mesh=None) -> tuple:
    """token: (b, 1) int; pos: host int. Returns (logits (b, 1, V_padded),
    cache); the self KV is written in place, the cross KV only read.

    On a `mesh` the tokens, the cache (``init_cache(mesh=...)``) and the
    logits are this rank's rows. Where ``model`` holds one rank the step
    is the meshless one. Where it holds n > 1, `params` are this rank's
    shards under ``param_specs(tp=n)`` (heads padded by ``init(tp=n)``;
    :func:`check_decode_shards`): the embedding looks up the tokens in its
    vocab rows and sums over ``model`` (``transformer._embed``), each
    layer runs tensor-parallel on its shards and context-parallel on the
    caches' (:func:`dec_block_step`), and the tied head on its vocab rows
    gives this rank's logits, gathered over ``model``."""
    n = model_size(mesh)
    tp = mesh if n > 1 else None
    if tp is not None:
        check_decode_shards(params, cfg, n)
    b = token.shape[0]
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=token.device)
    h = _embed(params["embed"], token, cfg, tp) + sinusoid_pos(
        posb, cfg.d_model).to(_dtype(cfg))
    dec = params["decoder"]
    kc, vc, xk, xv = (local(cache[key]) for key in ("k", "v", "xk", "xv"))
    S, frames = cache["k"].shape[3], cache["xk"].shape[3]
    for i in range(kc.shape[0]):
        h = dec_block_step(cfg, h, _index(dec, i), kc[i], vc[i], xk[i],
                           xv[i], pos, tp, S, frames)
    h = _ln(params["ln_dec"], h)
    logits = matmul(h, tied_head(params["embed"]))
    if tp is not None:
        logits = all_gather(logits, tp, TP_AXIS, -1)
    return logits, cache


def check_decode_shards(params: dict, cfg, n: int) -> None:
    """Raise unless `params` hold this rank's shards of a ``model`` axis of
    n ranks as ``init(tp=n)`` and ``param_specs`` make them: 1/n of the
    decoder's query, key and value heads (self and cross), of its MLP's
    width and of the embedding's vocab rows."""
    dec = params["decoder"]
    cols = padded_heads(cfg.n_heads, n) * cfg.resolved_head_dim
    got = {f"decoder/{a}/{w}": dec[a][w].shape[-1]
           for a in ("attn", "xattn") for w in ("wq", "wk", "wv")}
    want = dict.fromkeys(got, cols // n)
    got |= {"decoder/mlp/w_up": dec["mlp"]["w_up"].shape[-1],
            "embed": params["embed"].shape[0]}
    want |= {"decoder/mlp/w_up": cfg.d_ff // n,
             "embed": padded_vocab(cfg.vocab) // n}
    if got != want:
        raise ValueError(f"{cfg.name}: split leaves hold {got} on this "
                         f"rank; a model axis of {n} ranks needs {want} "
                         f"(parameters from init(tp={n}), placed by "
                         f"param_specs)")
