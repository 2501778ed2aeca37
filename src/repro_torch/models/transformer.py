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
kernel. On a mesh (``init_cache`` and ``decode_step`` with ``mesh``) each
rank decodes its rows of the batch; where the ``model`` axis holds
several ranks, the dense step is tensor-parallel on each rank's shards of
the parameters (``param_specs``: the embedding's vocab rows, the head's
columns, the attention and SwiGLU products' columns or rows) and
context-parallel on its slots of the KV cache (``cache_specs``), as the
reference's partitioning computes it. ``forward`` with ``mesh`` (the
dense family's training forward on a ``model`` axis of several ranks)
computes on the same shards, through the autograd collectives of
``distributed/sharding.py``: a vocab-parallel embedding, each rank's
query heads, its columns of w_gate and w_up and rows of w_down, and its
columns of the head, the logits gathered over ``model``.

The MoE family takes the same paths: its attention, embedding and head
as the dense family's, its experts split over ``model`` by
``moe.moe_param_specs`` (experts where the axis divides them, else each
expert's FFN width) and its routing groups formed over the whole batch
where the batch axes split the rows (``models/moe.py``). So its decode
step and its forward also take a mesh whose ``model`` axis holds one
rank (a ``data``-only mesh, or the batch axes' sub-mesh that the train
step passes with whole parameters), for the groups alone.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (BATCH_AXES, TP_AXIS, all_gather,
                                    all_reduce_sum, batch_rows,
                                    constrain_entries, copy_to_model,
                                    data_rows,
                                    gather_from_model, local,
                                    mesh_axis_sizes, model_rank, model_size,
                                    padded_heads, padded_vocab, placements,
                                    reduce_from_model)
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
                   positions: torch.Tensor, mesh=None) -> torch.Tensor:
    """One block of ``forward``; with a tensor-parallel `mesh` (see
    :func:`forward`) on this rank's shards of `bp`. The MoE FFN takes any
    mesh, for its routing groups (``moe.moe_ffn``)."""
    h = h + self_attention(bp["attn"], rmsnorm(h, bp["attn_norm"],
                                               cfg.norm_eps), cfg, positions,
                           mesh)
    x = rmsnorm(h, bp["ffn_norm"], cfg.norm_eps)
    if cfg.moe:
        f = moe_lib.moe_ffn(bp["moe"], x, cfg, mm=torch.matmul, mesh=mesh)
    else:
        f = reduce_from_model(swiglu(bp["ffn"], copy_to_model(x, mesh),
                                     torch.matmul), mesh)
    return h + f


def forward(params: dict, cfg, tokens: torch.Tensor,
            remat: bool = False, mesh=None) -> torch.Tensor:
    """tokens: (b, s) int -> logits (b, s, V_padded). With `remat` each
    block is recomputed in the backward (the reference's jax.checkpoint of
    its block).

    With a `mesh` whose ``model`` axis holds n > 1 ranks (the training
    forward on shards), `params`
    are this rank's shards under ``param_specs(tp=n)`` with the batch axes
    gathered (``sharding.gather_batch``), the query heads padded by
    ``init(tp=n)``, and every split one checked (:func:`check_train_shards`):
    the embedding looks up its vocab rows (:func:`_embed`), each block runs
    on its shards, and the head's columns give this rank's logits, gathered
    over ``model`` (``gather_from_model``, whose backward is this rank's
    slice: every rank computes the same loss from them). Each rank's
    gradients are then its shards. On a ``model`` axis of one rank, or
    without a mesh, this is the single-process forward, but for the MoE
    FFN's routing groups, which span the rows of the mesh's batch axes
    (`tokens` this rank's rows of them)."""
    n = model_size(mesh)
    tp = mesh if n > 1 else None
    if tp is not None:
        check_train_shards(params, cfg, n)
    b, s = tokens.shape
    h = _embed(params["embed"], tokens, cfg, tp)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    for bp in _layers(params["blocks"]):
        h = remat_call(remat, _block_forward, cfg, h, bp, positions, mesh)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(copy_to_model(h, tp), params["lm_head"])
    return gather_from_model(logits, tp, -1)


def train_tp_refusal(cfg, n: int) -> str | None:
    """Why `cfg` cannot compute on the shards of a ``model`` axis of n
    ranks, or None where it can: n must divide d_ff and the padded vocab
    (``init(tp=n)`` pads the query heads; KV heads that do not split are
    held whole on every rank), and in the MoE family the experts or their
    FFN width (``moe.tp_refusal``)."""
    refusal = moe_lib.tp_refusal(cfg, n) if cfg.moe else None
    if refusal is not None:
        return refusal
    for what, size in (("d_ff", cfg.d_ff),
                       ("padded vocab", padded_vocab(cfg.vocab))):
        if size % n:
            return (f"{cfg.name}: its {what} of {size} does not split over "
                    f"{n} ranks of the model axis")
    return None


def check_train_shards(params: dict, cfg, n: int) -> None:
    """Raise unless `params` hold this rank's shards of every leaf the
    training forward on a ``model`` axis of n ranks splits: the query
    heads and the experts (:func:`_check_tp_shards`), the columns of
    w_gate (the dense family's) and of the head and the embedding's vocab
    rows, 1/n of each; where `cfg` cannot compute on shards
    (:func:`train_tp_refusal`), raise that."""
    refusal = train_tp_refusal(cfg, n)
    if refusal is not None:
        raise NotImplementedError(refusal)
    _check_tp_shards(params, cfg, n)
    V = padded_vocab(cfg.vocab)
    got = {"embed": params["embed"].shape[0],
           "lm_head": params["lm_head"].shape[-1]}
    want = {"embed": V // n, "lm_head": V // n}
    if not cfg.moe:
        got["ffn/w_gate"] = params["blocks"]["ffn"]["w_gate"].shape[-1]
        want["ffn/w_gate"] = cfg.d_ff // n
    if got != want:
        raise ValueError(f"{cfg.name}: split leaves hold {got} on this "
                         f"rank; a model axis of {n} ranks needs {want}")


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
               device="cuda", tp: int = 1, mesh=None) -> dict:
    """Zeroed stacked KV cache (L, b, h_kv, S, hd). bf16 by default, also
    for an fp32 model, as in the reference. With a sliding window S is the
    window and the cache is a ring buffer. `tp` changes nothing: the KV
    heads are not padded (``padded_kv_heads``).

    On a `mesh`, this rank's shard under ``cache_specs``
    (:func:`mesh_cache`): its rows of the batch and, where ``model`` holds
    n > 1 ranks that divide S, its S / n slots. The MoE
    family's routing groups take the rows as split over every batch axis
    (``moe.route``), so there the batch must divide over their ranks."""
    hd = cfg.resolved_head_dim
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, hd)
    if mesh is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    ranks = data_rows(mesh)[1]
    if cfg.moe and batch % ranks:
        raise ValueError(f"{cfg.name}: a batch of {batch} rows does not "
                         f"split over the {ranks} ranks of the batch axes, "
                         f"which the MoE family's routing groups span")
    return mesh_cache({"k": shape, "v": shape}, cache_specs(cfg)["k"],
                      dtype, device, mesh)


def mesh_cache(shapes: dict, spec: tuple, dtype, device, mesh) -> dict:
    """Zeroed caches {name: whole shape (layers, b, h, S, hd)}, each this
    rank's shard on `mesh` under `spec` (a cache spec: batch over the DP
    axes, sequence over ``model``) by ``constrain_entries``' rule: its rows
    of the batch (``sharding.batch_rows``) and, where ``model`` holds n >
    1 ranks that divide the cache's S, its S / n slots. A cache split by
    sequence is a DTensor (its storage the shard, its shape the whole
    cache's), so that the step knows the whole S; any other is the plain
    local tensor."""
    n = model_size(mesh)
    out = {}
    for name, shape in shapes.items():
        start, stop = batch_rows(shape[1], mesh)
        S = shape[3]
        split = n > 1 and S % n == 0
        t = torch.zeros((shape[0], stop - start, shape[2],
                         S // n if split else S) + tuple(shape[4:]),
                        dtype=dtype, device=device)
        if split:
            places = placements(mesh, constrain_entries(
                spec, shape, mesh_axis_sizes(mesh)))
            t = DTensor.from_local(t, mesh, places, run_check=False)
        out[name] = t
    return out


def cache_specs(cfg) -> dict:
    """The KV cache's spec tuples (the reference's): batch over the DP
    axes, sequence over ``model`` (its context-parallel decode)."""
    s = (None, BATCH_AXES, None, TP_AXIS, None)
    return {"k": s, "v": s}


def block_decode(cfg, h: torch.Tensor, bp: dict, kc: torch.Tensor,
                 vc: torch.Tensor, pos: int, slot: int, mesh=None,
                 seq_len: int | None = None) -> torch.Tensor:
    """One layer of the decode step: h (b, 1, d) -> (b, 1, d); writes the
    new token's K/V into this layer's caches kc/vc at `slot`. On a
    `mesh` (see :func:`decode_step`) h holds this rank's rows; where its
    ``model`` axis holds several ranks `bp` holds this rank's shards and
    kc/vc its shards of caches of `seq_len` slots."""
    x = rmsnorm(h, bp["attn_norm"], cfg.norm_eps)
    h = h + decode_attention(bp["attn"], x, cfg, kc, vc, pos, slot, mesh,
                             seq_len)
    x = rmsnorm(h, bp["ffn_norm"], cfg.norm_eps)
    if cfg.moe:
        f = moe_lib.moe_ffn(bp["moe"], x, cfg, mesh=mesh)
    else:
        f = swiglu(bp["ffn"], x)
        if mesh is not None and bp["ffn"]["w_gate"].shape[1] < cfg.d_ff:
            f = all_reduce_sum(f, mesh, TP_AXIS)
    return h + f


def decode_step(params: dict, cfg, token: torch.Tensor, cache: dict,
                pos: int, mesh=None) -> tuple:
    """token: (b, 1) int; pos: host int. Returns (logits (b, 1, V_padded),
    cache).

    The cache is updated in place, one slot per layer (JAX returns a new
    cache); the returned cache is the same dict. With a sliding window the
    slot is ``pos % S``, S the whole cache's length.

    On a `mesh` the tokens, the cache (``init_cache(mesh=...)``) and the
    logits are this rank's rows. Where ``model`` holds one rank the step is
    the meshless one (the MoE FFN's routing groups apart, which span the
    batch axes' rows: ``moe.moe_ffn``). Where it holds n > 1, `params` are
    this rank's shards under ``param_specs(tp=n)`` (query heads padded by
    ``init(tp=n)``): the embedding looks up the tokens in its vocab rows,
    zeroes the others and sums over ``model`` (one term is non-zero, so
    the sum is exact); each layer runs tensor-parallel (``block_decode``),
    the MoE family's experts on their shards; the head's columns give this
    rank's logits, which are gathered over ``model``, so a greedy sampler
    sees every column."""
    n = model_size(mesh)
    tp = mesh if n > 1 else None
    if tp is not None:
        _check_tp_shards(params, cfg, n)
    kc_all, vc_all = local(cache["k"]), local(cache["v"])
    L = kc_all.shape[0]
    S = cache["k"].shape[3]
    slot = pos % S if cfg.sliding_window else pos
    h = _embed(params["embed"], token, cfg, tp)
    blocks = params["blocks"]
    for i in range(L):
        h = block_decode(cfg, h, _index(blocks, i), kc_all[i], vc_all[i],
                         pos, slot, mesh, S)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = matmul(h, params["lm_head"])
    if tp is not None and logits.shape[-1] < padded_vocab(cfg.vocab):
        logits = all_gather(logits, tp, TP_AXIS, -1)
    return logits, cache


def _embed(embed: torch.Tensor, token: torch.Tensor, cfg,
           mesh) -> torch.Tensor:
    """The rows of `token` (any shape of ints): a lookup, or, where `embed`
    holds this rank's rows of the vocab, the vocab-parallel lookup summed
    over ``model`` (``reduce_from_model``: one term is non-zero, so the sum
    is exact, and each rank's gradient falls on its own rows)."""
    rows = embed.shape[0]
    if mesh is None or rows == padded_vocab(cfg.vocab):
        return embed[token]
    idx = token - model_rank(mesh) * rows
    inside = (idx >= 0) & (idx < rows)
    h = embed[idx.clamp(0, rows - 1)] * inside[..., None].to(embed.dtype)
    return reduce_from_model(h, mesh)


def _check_tp_shards(params: dict, cfg, n: int) -> None:
    """Raise unless the query projection is split by whole heads over the n
    ranks of ``model``, as ``init(tp=n)`` and ``param_specs`` make it, and
    the MoE family's expert leaves by ``moe.moe_param_specs`` (refused
    where neither the experts nor their FFN width split)."""
    if cfg.moe:
        moe_lib.check_shards(params["blocks"]["moe"], cfg, n)
    hd = cfg.resolved_head_dim
    cols = params["blocks"]["attn"]["wq"].shape[-1]
    if cols * n != padded_heads(cfg.n_heads, n) * hd:
        raise ValueError(
            f"{cfg.name}: wq holds {cols} columns on this rank; a model "
            f"axis of {n} ranks needs 1/{n} of "
            f"{padded_heads(cfg.n_heads, n)} heads of {hd} (parameters "
            f"from init(tp={n}), placed by param_specs)")


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
