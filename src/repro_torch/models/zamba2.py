"""Zamba2: a Mamba2 (SSD) backbone with one *shared* attention block applied
periodically (arXiv:2411.15242). zamba2-1.2b: 38 Mamba2 layers, d_model
2048, ssm_state 64, one shared GQA (32 heads over 32 KV heads) + SwiGLU
(8192) block after every `shared_attn_every` layers, with the same
parameters at each of its applications (the Zamba trick).

The PyTorch counterpart of ``repro.models.zamba2``, function for function,
with the same cast order. The SSD recurrence per head h with scalar decay
a_t:

    H_t = a_t * H_{t-1} + dt_t * (B_t outer x_t),  y_t = C_t . H_t + D * x_t

runs token by token in fp32, as the reference's ``lax.scan`` does, both
for ``forward`` (prefill) and, as a single state update, for
``decode_step``. The JAX package computes it outside any Pallas kernel, so
here it is plain torch ops. At decode every weight product (in_proj and
out_proj of each block; the shared block's q/k/v/o and its three FFN
products; the head) goes through ``layers.matmul``, so through the
row-stream kernel, and the shared block's cached attention through
``layers.decode_attention``, so through the flash-decode kernel; the
prefill's products take torch.matmul, as the other families' do.

Parameters are a dict of tensors with the reference's structure, the
per-layer ``blocks`` leaves stacked along a leading layer dim. ``forward``
takes the reference's ``remat`` option (each Mamba2 block recomputed in
the backward).

On a mesh whose ``model`` axis holds n > 1 ranks (n dividing the SSM
heads, d_ff and the padded vocab: :func:`train_tp_refusal`) each rank
computes on its nh / n SSM heads. Its *parts* of the packed in_proj are
the columns of its heads' z, x and dt and all of B and C (one group of
``state_dim``): over 2 ranks of zamba2-1.2b a (2048, 2048 + 2048 + 64 +
64 + 32 = 4256) weight a block, where the reference's ``param_specs``
split the 8384 columns evenly (rank 0 all of z and 96 columns of x).
The conv takes the matching channels, x's and all of B's and C's.
``out_proj`` splits by rows, which are the heads' channels; ``A_log``,
``D``, ``dt_bias`` and ``gate_norm`` act on the rank's heads. The gated
RMSNorm over the whole inner dim takes its sum of squares in fp32 on the
rank's part and sums it over ``model``. The embedding is vocab-parallel
(``transformer._embed``), the head column-parallel with its logits
gathered, and the shared block runs as the dense family's block
(``transformer.block_decode``, ``transformer._block_forward``).

* Decode: :func:`place_decode_params` lays a rank's parts out once, where
  the serve driver places the parameters (``launch/serve.py``); the step
  (:func:`decode_step` with a mesh) launches one in_proj product a block
  on them, as many ``rowstream_matmul`` and ``flash_decode`` launches as
  the meshless step, and sums out_proj's partial products over
  ``model``. The state (:func:`init_state` with a mesh) holds the rank's
  heads of the SSM state, its channels of the conv tail and its sequence
  shard of the shared block's KV cache, merged through
  ``flash_decode_partial``'s softmax statistics.
* Training (:func:`forward` with a mesh): the parameters are the
  reference's even shards. ``gather_parts_for_model`` gathers in_proj and
  conv_w and takes the rank's parts; its backward scatters the rank's
  gradient into the whole and sums it over ``model``, which also sums the
  B and C columns' gradients, partial on each rank (each uses B and C for
  its own heads only), exactly once. The normed input of in_proj enters
  through ``copy_to_model`` for the same reason; the per-head leaves
  through ``slice_for_model``; the gated norm's sum of squares through
  ``reduce_from_model`` and ``copy_to_model`` (each rank's gradient of the
  sum is a partial term); out_proj's product through
  ``reduce_from_model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from ..distributed.sharding import (TP_AXIS, all_gather, all_reduce_sum,
                                    batch_rows, constrain_like,
                                    copy_to_model,
                                    gather_from_model,
                                    gather_parts_for_model, local,
                                    local_tree, model_rank, model_size,
                                    padded_heads, padded_vocab,
                                    reduce_from_model, slice_for_model)
from .layers import attn_params, dense_init, ffn_params, matmul, rmsnorm
from .transformer import (_block_forward, _dtype, _embed, _index, _layers,
                          _stack, _stacked, attn_specs, block_decode,
                          ffn_specs, mesh_cache, remat_call)

# Tokens of one prompt whose SSD updates (B outer x) * dt are formed at once
# in _ssd_scan: 4 x 64 tokens of zamba2-1.2b take 256 MB in fp32.
SCAN_CHUNK = 64


def _ssm(cfg) -> SSMConfig:
    return cfg.ssm or SSMConfig()


def inner_dim(cfg) -> int:
    return _ssm(cfg).expand * cfg.d_model


def ssm_heads(cfg) -> int:
    return inner_dim(cfg) // _ssm(cfg).head_dim


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg, gen: torch.Generator, tp: int = 1) -> dict:
    """Random parameters on ``gen``'s device with the reference's structure
    and scales: normal/sqrt(fan_in) projections, the conv taps at 0.5, the
    embedding at 0.02, unit norms, and the fp32 ``A_log`` (0), ``D`` (1)
    and ``dt_bias`` (-2) inside a model of ``cfg.dtype``; the shared
    block's query heads padded to a multiple of `tp`."""
    dt = _dtype(cfg)
    dev = gen.device
    d = cfg.d_model
    s = _ssm(cfg)
    din = inner_dim(cfg)
    nh = ssm_heads(cfg)
    V = padded_vocab(cfg.vocab)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def mamba_init():
        return {
            "in_proj": dense_init(gen, (d, 2 * din + 2 * s.state_dim + nh),
                                  dt),
            "conv_w": dense_init(gen, (s.conv_width, din + 2 * s.state_dim),
                                 dt, scale=0.5),
            "A_log": full((nh,), 0.0, torch.float32),
            "D": full((nh,), 1.0, torch.float32),
            "dt_bias": full((nh,), -2.0, torch.float32),
            "out_proj": dense_init(gen, (din, d), dt),
            "norm": full((d,), 1.0),
            "gate_norm": full((din,), 1.0),
        }

    return {
        "embed": dense_init(gen, (V, d), dt, scale=0.02),
        "blocks": _stack([mamba_init() for _ in range(cfg.n_layers)]),
        "shared": {
            "attn": attn_params(gen, cfg, padded_heads(cfg.n_heads, tp),
                                cfg.n_kv_heads, dt),
            "attn_norm": full((d,), 1.0),
            "ffn": ffn_params(gen, d, cfg.d_ff, dt),
            "ffn_norm": full((d,), 1.0),
        },
        "final_norm": full((d,), 1.0),
        "lm_head": dense_init(gen, (d, V), dt),
    }


def param_specs(cfg, fsdp=None, tp: int = 16) -> dict:
    """Spec tuples mirroring init()'s structure (the reference's)."""
    mamba = {
        "in_proj": (fsdp, "model"), "conv_w": (None, "model"),
        "A_log": (None,), "D": (None,), "dt_bias": (None,),
        "out_proj": ("model", fsdp), "norm": (None,), "gate_norm": (None,),
    }
    attn = attn_specs(cfg, fsdp, tp)
    shared = {
        "attn": {k: attn[k] for k in ("wq", "wk", "wv", "wo")},
        "attn_norm": (None,),
        "ffn": ffn_specs(fsdp),
        "ffn_norm": (None,),
    }
    return {
        "embed": ("model", fsdp),
        "blocks": _stacked(mamba),
        "shared": shared,
        "final_norm": (None,),
        "lm_head": (fsdp, "model"),
    }


# ---------------------------------------------------------------------------
# A rank's parts on a model axis
# ---------------------------------------------------------------------------

# Block leaves laid out by parts at decode, and leaves that act on a rank's
# heads (sliced to them at decode, through slice_for_model in training).
BY_PARTS = ("in_proj", "conv_w")
PER_HEAD = ("A_log", "D", "dt_bias", "gate_norm")


def _span(start: int, size: int, device) -> torch.Tensor:
    return torch.arange(start, start + size, device=device)


def _parts(cfg, n: int, rank: int, device=None) -> tuple:
    """(in_proj columns, conv channels) of rank `rank` of n on ``model``:
    its heads' z, x and dt and all of B and C; its heads' x channels and
    all of B's and C's."""
    N = _ssm(cfg).state_dim
    din, nh = inner_dim(cfg), ssm_heads(cfg)
    dr, hr = din // n, nh // n
    cols = torch.cat([_span(rank * dr, dr, device),
                      _span(din + rank * dr, dr, device),
                      _span(2 * din, 2 * N, device),
                      _span(2 * din + 2 * N + rank * hr, hr, device)])
    chans = torch.cat([_span(rank * dr, dr, device),
                       _span(din, 2 * N, device)])
    return cols, chans


def _part_widths(cfg, n: int) -> dict:
    """The width of each leaf a rank of n on ``model`` computes with."""
    N = _ssm(cfg).state_dim
    dr, hr = inner_dim(cfg) // n, ssm_heads(cfg) // n
    return {"in_proj": 2 * dr + 2 * N + hr, "conv_w": dr + 2 * N,
            "A_log": hr, "D": hr, "dt_bias": hr, "gate_norm": dr}


def train_tp_refusal(cfg, n: int) -> str | None:
    """Why `cfg` cannot compute on the shards of a ``model`` axis of n
    ranks, or None where it can: n must divide the SSM heads (each rank
    scans whole heads), d_ff and the padded vocab (``init(tp=n)`` pads the
    shared block's query heads; KV heads that do not split are held whole
    on every rank)."""
    for what, size in (("SSM heads", ssm_heads(cfg)), ("d_ff", cfg.d_ff),
                       ("padded vocab", padded_vocab(cfg.vocab))):
        if size % n:
            return (f"{cfg.name}: its {what} ({size} at d_model "
                    f"{cfg.d_model}) do not split over {n} ranks of the "
                    f"model axis")
    return None


def _refuse(cfg, n: int) -> None:
    refusal = train_tp_refusal(cfg, n)
    if refusal is not None:
        raise NotImplementedError(refusal)


def _check_split(params: dict, cfg, n: int, extra: dict) -> None:
    """Raise unless the leaves every layout splits over ``model`` hold
    1/n (out_proj's rows, the query heads, w_gate's columns, the
    embedding's vocab rows and the head's columns) and `extra`'s leaves
    {name: (got, want)} agree."""
    V = padded_vocab(cfg.vocab)
    hd = cfg.resolved_head_dim
    sp = params["shared"]
    got = {"out_proj": params["blocks"]["out_proj"].shape[-2],
           "attn/wq": sp["attn"]["wq"].shape[-1],
           "ffn/w_gate": sp["ffn"]["w_gate"].shape[-1],
           "embed": params["embed"].shape[0],
           "lm_head": params["lm_head"].shape[-1]}
    want = {"out_proj": inner_dim(cfg) // n,
            "attn/wq": padded_heads(cfg.n_heads, n) * hd // n,
            "ffn/w_gate": cfg.d_ff // n, "embed": V // n, "lm_head": V // n}
    got |= {k: g for k, (g, _) in extra.items()}
    want |= {k: w for k, (_, w) in extra.items()}
    if got != want:
        raise ValueError(f"{cfg.name}: leaves hold {got} on this rank; a "
                         f"model axis of {n} ranks needs {want}")


def check_decode_shards(params: dict, cfg, n: int) -> None:
    """Raise unless `params` are a rank's parts on a ``model`` axis of n
    ranks as :func:`place_decode_params` lays them out; where `cfg` cannot
    split over n, raise that."""
    _refuse(cfg, n)
    blocks = params["blocks"]
    _check_split(params, cfg, n, {
        f"blocks/{k}": (blocks[k].shape[-1], w)
        for k, w in _part_widths(cfg, n).items()})


def check_train_shards(params: dict, cfg, n: int) -> None:
    """Raise unless `params` hold this rank's shards under ``param_specs``
    on a ``model`` axis of n ranks (in_proj and conv_w an even part, or
    whole where their width does not split); where `cfg` cannot split
    over n, raise that."""
    _refuse(cfg, n)
    blocks = params["blocks"]
    extra = {}
    for k, whole in (("in_proj", _in_width(cfg)),
                     ("conv_w", _conv_width(cfg))):
        w = blocks[k].shape[-1]
        extra[f"blocks/{k}"] = (w, w if w == whole else whole // n)
    _check_split(params, cfg, n, extra)


def _in_width(cfg) -> int:
    return 2 * inner_dim(cfg) + 2 * _ssm(cfg).state_dim + ssm_heads(cfg)


def _conv_width(cfg) -> int:
    return inner_dim(cfg) + 2 * _ssm(cfg).state_dim


def place_decode_params(params: dict, cfg, mesh, tp: int) -> dict:
    """This rank's decode parameters from `params` (the same on every
    rank): its shards under ``param_specs(tp=tp)``, replicated over
    ``data``, except that on a ``model`` axis of n > 1 ranks in_proj and
    conv_w hold the rank's parts (:func:`_parts`) and the per-head leaves
    its heads, each cut once here, with no communication, so that a step
    streams only its share."""
    n = model_size(mesh)
    specs = param_specs(cfg, None, tp)
    if n > 1:
        _refuse(cfg, n)
        specs["blocks"] = {k: (None,) * len(v)
                           if k in BY_PARTS + PER_HEAD else v
                           for k, v in specs["blocks"].items()}
    placed = local_tree(constrain_like(params, specs, mesh))
    if n == 1:
        return placed
    r = model_rank(mesh)
    blocks = dict(placed["blocks"])
    cols, chans = _parts(cfg, n, r, blocks["in_proj"].device)
    blocks["in_proj"] = blocks["in_proj"].index_select(-1, cols)
    blocks["conv_w"] = blocks["conv_w"].index_select(-1, chans)
    for k in PER_HEAD:
        size = blocks[k].shape[-1] // n
        blocks[k] = blocks[k].index_select(
            -1, _span(r * size, size, blocks[k].device))
    return dict(placed, blocks=blocks)


# ---------------------------------------------------------------------------
# Mamba2 core
# ---------------------------------------------------------------------------

def _split_proj(cfg, proj: torch.Tensor, n: int = 1) -> tuple:
    """in_proj's output (..., 2 din + 2 N + nh) -> z, x, B, C, dt; on a
    rank's parts of a ``model`` axis of n ranks z, x and dt are its
    heads'."""
    s = _ssm(cfg)
    din = inner_dim(cfg) // n
    return torch.split(proj, [din, din, s.state_dim, s.state_dim,
                              ssm_heads(cfg) // n], dim=-1)


def _ssd_scan(bp: dict, cfg, xc: torch.Tensor, Bc: torch.Tensor,
              Cc: torch.Tensor, dt_raw: torch.Tensor,
              H0: torch.Tensor) -> tuple:
    """Sequential SSD over time. xc: (b, s, nh * hd); Bc/Cc: (b, s, N);
    dt_raw: (b, s, nh); H0: (b, nh, hd, N) fp32, nh the heads of `bp`'s
    A_log, D and dt_bias (all of them, or a rank's). Returns y (b, s,
    nh * hd) in xc's dtype and the final state, which is H0 itself,
    updated in place (the decode state's own layer slice, or a fresh zero
    state), unless autograd records the scan (a training forward): then
    each token's state is a new tensor, with the same arithmetic.

    The terms that do not depend on the state are formed for many tokens
    at once: the fp32 casts, the decays a = exp(dt A), D x, and the
    updates (B outer x) * dt, in the reference's order, SCAN_CHUNK tokens
    at a time (bounding their memory). Only the state update a * H + that
    and its read-out H . C run token by token."""
    nh, hd = dt_raw.shape[-1], _ssm(cfg).head_dim
    N = _ssm(cfg).state_dim
    b, s, _ = xc.shape
    A = -torch.exp(bp["A_log"])                                  # (nh,) < 0
    dt = F.softplus(dt_raw.float() + bp["dt_bias"])              # (b,s,nh)
    xh = xc.reshape(b, s, nh, hd).float()
    # Token-major operands: (s, b, nh, 1, 1) decays, and C laid out per
    # token as (b * nh, N, 1) so that the read-out is one batched product.
    xT, BT, dtT = (t.transpose(0, 1) for t in (xh, Bc.float(), dt))
    aT = torch.exp(dtT * A)[..., None, None]
    CT = Cc.float().transpose(0, 1)[:, :, None, :, None].expand(
        s, b, nh, N, 1).reshape(s, b * nh, N, 1)
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xc, Bc, Cc, dt_raw, H0, bp["A_log"],
                                  bp["dt_bias"]))
    Hs = H0
    H3 = Hs.view(b * nh, hd, N)
    ys = []
    for c0 in range(0, s, SCAN_CHUNK):
        c1 = min(s, c0 + SCAN_CHUNK)
        dBx = xT[c0:c1, ..., None] * BT[c0:c1, :, None, None, :]
        dBx *= dtT[c0:c1, ..., None, None]                       # (c,b,nh,hd,N)
        for dBx_t, a_t, C_t in zip(dBx.unbind(0), aT[c0:c1].unbind(0),
                                   CT[c0:c1].unbind(0)):
            if record:
                Hs = Hs * a_t + dBx_t
                H3 = Hs.view(b * nh, hd, N)
            else:
                Hs.mul_(a_t).add_(dBx_t)
            ys.append(torch.bmm(H3, C_t))                        # (b*nh,hd,1)
    y = torch.stack(ys).view(s, b, nh, hd).transpose(0, 1) \
        + bp["D"][:, None] * xh                                  # (b,s,nh,hd)
    return y.reshape(b, s, nh * hd).to(xc.dtype), Hs


def _causal_conv(conv_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, then SiLU. x: (b, s, c); conv_w:
    (w, c). The taps are summed in the reference's order."""
    w = conv_w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, w - 1, 0))
    out = sum(xp[:, i:i + s, :] * conv_w[i] for i in range(w))
    return F.silu(out)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, cfg,
                total=None) -> torch.Tensor:
    """``rmsnorm(y * silu(z), w)`` over the inner dim. Where y, z and w are
    a rank's part of it, `total` sums the fp32 sum of squares of the part
    over ``model``, and the mean divides by the whole inner dim, in
    ``layers.rmsnorm``'s order."""
    g = y * F.silu(z)
    if total is None:
        return rmsnorm(g, w, cfg.norm_eps)
    g32 = g.float()
    var = total(torch.sum(g32 * g32, dim=-1, keepdim=True)) / inner_dim(cfg)
    return (g32 * torch.rsqrt(var + cfg.norm_eps)).to(g.dtype) * w


def _mamba_block_seq(bp: dict, cfg, h: torch.Tensor,
                     mesh=None) -> torch.Tensor:
    """Full-sequence Mamba2 block from a zero state. h: (b, s, d). On a
    tensor-parallel `mesh` on this rank's heads (see the module
    docstring), `bp` its shards under ``param_specs``."""
    s = _ssm(cfg)
    n = model_size(mesh)
    hn = rmsnorm(h, bp["norm"], cfg.norm_eps)
    w_in, conv_w, total = bp["in_proj"], bp["conv_w"], None
    if n > 1:
        hn = copy_to_model(hn, mesh)
        cols, chans = _parts(cfg, n, model_rank(mesh), h.device)
        w_in = gather_parts_for_model(w_in, mesh, -1, cols, _in_width(cfg))
        conv_w = gather_parts_for_model(conv_w, mesh, -1, chans,
                                        _conv_width(cfg))
        bp = dict(bp, **{k: slice_for_model(bp[k], mesh, 0)
                         for k in PER_HEAD})

        def total(ss):
            return copy_to_model(reduce_from_model(ss, mesh), mesh)
    z, x, B, C, dtr = _split_proj(cfg, torch.matmul(hn, w_in), n)
    xBC = _causal_conv(conv_w, torch.cat([x, B, C], -1))
    xc, Bc, Cc = torch.split(xBC, [x.shape[-1], s.state_dim, s.state_dim],
                             -1)
    H0 = torch.zeros((h.shape[0], dtr.shape[-1], s.head_dim, s.state_dim),
                     dtype=torch.float32, device=h.device)
    y, _ = _ssd_scan(bp, cfg, xc, Bc, Cc, dtr, H0)
    y = _gated_norm(y, z, bp["gate_norm"], cfg, total)
    return h + reduce_from_model(torch.matmul(y, bp["out_proj"]), mesh)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _pattern(cfg) -> tuple[int, int]:
    """Layer pattern: shared attention after every `shared_attn_every`
    mamba blocks. Returns (k, number of shared applications)."""
    k = cfg.shared_attn_every or (cfg.n_layers + 1)
    return k, cfg.n_layers // k


def forward(params: dict, cfg, tokens: torch.Tensor,
            remat: bool = False, mesh=None) -> torch.Tensor:
    """tokens: (b, s) int -> logits (b, s, V_padded). n_shared units of
    (k mamba blocks + the shared block), then the remaining blocks. With
    `remat` each Mamba2 block is recomputed in the backward, as the
    reference checkpoints its Mamba2 block (not the shared one).

    With a `mesh` whose ``model`` axis holds n > 1 ranks (the training
    forward on shards), `params` are this rank's shards under
    ``param_specs(tp=n)`` with the batch axes gathered, every split one
    checked (:func:`check_train_shards`); each block computes on the
    rank's heads (see the module docstring) and the logits are gathered
    whole on every rank. On a ``model`` axis of one rank, or without a
    mesh, this is the single-process forward."""
    n = model_size(mesh)
    tp = mesh if n > 1 else None
    if tp is not None:
        check_train_shards(params, cfg, n)
    b, s = tokens.shape
    h = _embed(params["embed"], tokens, cfg, tp)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    k, n_shared = _pattern(cfg)
    layers = _layers(params["blocks"])
    for i in range(cfg.n_layers):
        h = remat_call(remat, _mamba_block_seq, layers[i], cfg, h, tp)
        if i < n_shared * k and (i + 1) % k == 0:
            h = _block_forward(cfg, h, params["shared"], positions, tp)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(copy_to_model(h, tp), params["lm_head"])
    return gather_from_model(logits, tp, -1)


def init_state(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda", tp: int = 1, mesh=None) -> dict:
    """Decode state: per-layer SSM state (fp32) and conv tail (model
    dtype), plus a KV cache in `dtype` (bf16 by default, also for an fp32
    model, as in the reference) for the shared block at each of its
    application depths: a ring buffer of the window where one is set.
    `tp` changes nothing: the KV heads are not padded.

    On a `mesh`, this rank's share: its rows of the batch
    (``sharding.batch_rows``) and, where ``model`` holds n > 1 ranks
    (refused with :func:`train_tp_refusal`'s reason where the shapes do
    not split), its nh / n heads of the SSM state, the conv tail's
    channels of its parts (its heads' x and all of B and C: the
    reference's ``state_specs`` split the channels evenly, which is not a
    rank's heads; see :func:`_parts`) and, where n divides S, its S / n
    slots of the KV cache, a DTensor whose shape is the whole cache's
    (``transformer.mesh_cache``)."""
    s = _ssm(cfg)
    _, n_shared = _pattern(cfg)
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    hd = cfg.resolved_head_dim
    n = model_size(mesh)
    if n > 1:
        _refuse(cfg, n)
    start, stop = batch_rows(batch, mesh)
    rows = stop - start
    kv = (n_shared, batch, cfg.n_kv_heads, S, hd)
    state = {
        "ssm": torch.zeros((cfg.n_layers, rows, ssm_heads(cfg) // n,
                            s.head_dim, s.state_dim), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((cfg.n_layers, rows, s.conv_width - 1,
                             inner_dim(cfg) // n + 2 * s.state_dim),
                            dtype=_dtype(cfg), device=device),
    }
    if mesh is None:
        return state | {key: torch.zeros(kv, dtype=dtype, device=device)
                        for key in ("k", "v")}
    return state | mesh_cache({"k": kv, "v": kv}, state_specs(cfg)["k"],
                              dtype, device, mesh)


def state_specs(cfg) -> dict:
    """The decode state's spec tuples (the reference's). On a ``model``
    axis of several ranks ``init_state`` keeps the conv tail by parts
    instead of ``conv``'s even split (see there)."""
    return {
        "ssm": (None, ("pod", "data"), "model", None, None),
        "conv": (None, ("pod", "data"), None, "model"),
        "k": (None, ("pod", "data"), None, "model", None),
        "v": (None, ("pod", "data"), None, "model", None),
    }


def _mamba_block_step(bp: dict, cfg, h: torch.Tensor,
                      ssm_state: torch.Tensor, conv_tail: torch.Tensor,
                      mesh=None) -> torch.Tensor:
    """Single-token mamba block. h: (b, d). Updates this layer's SSM state
    (b, nh, hd, N) and conv tail (b, w - 1, c) in place. On a
    tensor-parallel `mesh`, `bp` holds this rank's parts
    (:func:`place_decode_params`), the state its heads and channels, the
    gated norm's sum of squares and out_proj's product are summed over
    ``model``."""
    s = _ssm(cfg)
    n = model_size(mesh)
    hn = rmsnorm(h, bp["norm"], cfg.norm_eps)
    z, x, B, C, dtr = _split_proj(cfg, matmul(hn, bp["in_proj"]), n)
    xBC = torch.cat([x, B, C], -1)                               # (b, c)
    win = torch.cat([conv_tail, xBC[:, None, :]], 1)             # (b, w, c)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", win, bp["conv_w"]))
    xc, Bc, Cc = torch.split(conv_out, [x.shape[-1], s.state_dim,
                                        s.state_dim], -1)
    y, _ = _ssd_scan(bp, cfg, xc[:, None], Bc[:, None], Cc[:, None],
                     dtr[:, None], ssm_state)
    conv_tail.copy_(win[:, 1:])
    total = None if n == 1 else (
        lambda ss: all_reduce_sum(ss, mesh, TP_AXIS))
    y = _gated_norm(y[:, 0], z, bp["gate_norm"], cfg, total)
    return h + all_reduce_sum(matmul(y, bp["out_proj"]), mesh, TP_AXIS)


def decode_step(params: dict, cfg, token: torch.Tensor, state: dict,
                pos: int, mesh=None) -> tuple:
    """token: (b, 1) int; pos: host int. Returns (logits (b, 1, V_padded),
    state).

    The state is updated in place (JAX returns a new one): each layer's
    SSM state and conv tail, and the new token's K/V at slot ``pos`` (``pos
    % S`` with a sliding window, S the whole cache's) of the shared
    block's cache at each of its depths. The returned state is the same
    dict.

    On a `mesh` the tokens, the state (``init_state(mesh=...)``) and the
    logits are this rank's rows. Where ``model`` holds n > 1 ranks,
    `params` are this rank's parts (:func:`place_decode_params`, checked
    by :func:`check_decode_shards`): the vocab-parallel embedding, each
    Mamba2 block on the rank's heads, the shared block tensor- and
    context-parallel, the head's columns gathered over ``model``. On a
    ``model`` axis of one rank this is the meshless step, call for
    call."""
    n = model_size(mesh)
    tp = mesh if n > 1 else None
    if tp is not None:
        check_decode_shards(params, cfg, n)
    kc_all, vc_all = local(state["k"]), local(state["v"])
    S = state["k"].shape[3]
    slot = pos % S if cfg.sliding_window else pos
    h = _embed(params["embed"], token[:, 0], cfg, tp)            # (b, d)
    k, n_shared = _pattern(cfg)
    blocks, sp = params["blocks"], params["shared"]
    for i in range(cfg.n_layers):
        h = _mamba_block_step(_index(blocks, i), cfg, h, state["ssm"][i],
                              state["conv"][i], tp)
        if i < n_shared * k and (i + 1) % k == 0:
            u = i // k
            h = block_decode(cfg, h[:, None], sp, kc_all[u], vc_all[u],
                             pos, slot, mesh, S)[:, 0]
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = matmul(h, params["lm_head"])
    if tp is not None:
        logits = all_gather(logits, tp, TP_AXIS, -1)
    return logits[:, None, :], state
