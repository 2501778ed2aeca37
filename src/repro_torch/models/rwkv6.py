"""RWKV6 "Finch": attention-free LM with data-dependent decay
(arXiv:2404.05892). rwkv6-3b: 32L, d_model 2560, d_ff 8960, vocab 65536.

The PyTorch counterpart of ``repro.models.rwkv6``, function for function,
with the same cast order. Per layer: time mix (multi-head linear attention
with per-channel data-dependent decay w_t and bonus u) and channel mix.
The recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t (diag(u) k_t^T v_t + S_{t-1})

runs in two forms:

* ``forward`` (prefill and training) is chunk-parallel where the reference
  scans token by token: the token shift, the mixes and every projection
  run over all b * s rows at once (``torch.matmul``, as the reference
  leaves them to XLA), and the whole prompt's recurrence goes through the
  ``rwkv_scan`` kernel wrapper, one launch per layer, whose gradient is
  the ``rwkv_scan_bwd`` kernel. With ``remat`` each layer is recomputed in
  the backward, so a layer's forward scan runs twice per backward.
* ``decode_step`` updates the state once per token as the reference does;
  every weight product goes through ``layers.matmul`` (the row-stream
  kernel): 10 per layer plus the head.

Parameters are a dict of tensors with the reference's structure, the
per-layer ``blocks`` leaves stacked along a leading layer dim.

``forward`` with a ``mesh`` whose ``model`` axis holds n > 1 ranks (the
training forward on shards) runs on each rank's shards under
``param_specs``, where n divides the H heads (:func:`check_train_shards`):
r, k, v, g and the decay on its H / n heads' columns, ``rwkv_scan`` on
those heads, wo and cv by rows, each summed over the ranks
(``reduce_from_model``), ck by columns, a vocab-parallel embedding and
the head's columns gathered over ``model``. How each replicated leaf's
gradient comes out whole on every rank:

* ``copy_to_model`` at the input of each group of column-parallel
  products, whose backward sums the ranks' partial gradients: the mixed
  xr, xk, xv, xg of the time mix, the LoRA's hidden ``tanh(xw @
  w_lora_a)`` (the input of the column-parallel w_lora_b), the channel
  mix's xk, and the normed h before the head. Behind them ``mu``,
  ``mu_c``, ``w_lora_a``, ``tm_norm``, ``cm_norm`` and ``final_norm`` act
  on replicated activations only, so each rank's gradient is already the
  whole one and is not summed again.
* ``slice_for_model`` on the leaves that act per head or per channel on
  the rank's heads: ``u`` (H, hd) by heads, ``w0`` and ``ln_x`` (d,) by
  channels; their backward gathers the parts' gradients.
* ``cr`` (replicated) acts on the replicated channel-mix input and its
  product is computed whole on every rank: no collective.

``decode_step`` and ``init_state`` with such a mesh decode on the same
shards: the state ``S`` holds the rank's H / n heads (the reference's
``state_specs`` split it by head over ``model``), each layer's time mix
runs on them (:func:`_time_mix_step`, the same slices as
:func:`_time_mix_seq`) with wo's partial products summed over ``model``
by the decode collective, the channel mix as in the forward, and the
head's columns are gathered. ``x_tm`` and ``x_cm`` stay whole on every
rank. Where n does not divide the heads, d_ff or the padded vocab
(:func:`train_tp_refusal`) the decode state and step refuse with the
reason.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import (TP_AXIS, all_gather, all_reduce_sum,
                                    batch_rows, copy_to_model,
                                    gather_from_model, model_size,
                                    padded_vocab, reduce_from_model,
                                    slice_for_model)
from ..kernels.rwkv_scan.ops import rwkv_scan
from .layers import dense_init, matmul, rmsnorm
from .transformer import (_dtype, _embed, _index, _layers, _stack, _stacked,
                          remat_call)

LORA_RANK = 64
HEAD_DIM = 64


def n_heads(cfg) -> int:
    return cfg.d_model // HEAD_DIM


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg, gen: torch.Generator, tp: int = 1) -> dict:
    """Random parameters on ``gen``'s device with the reference's structure
    and scales: normal/sqrt(fan_in) projections (the decay LoRA's second
    factor at 0.01, the embedding at 0.02), mixes at 0.5, unit norms, and
    the fp32 ``w0`` (-5) and ``u`` (0) inside a model of ``cfg.dtype``.
    `tp` changes nothing (no attention heads to pad), as in the
    reference."""
    dt = _dtype(cfg)
    dev = gen.device
    d = cfg.d_model
    V = padded_vocab(cfg.vocab)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def block_init():
        return {
            # time mix
            "mu": full((5, d), 0.5),             # r,k,v,g,w shift mixes
            "wr": dense_init(gen, (d, d), dt),
            "wk": dense_init(gen, (d, d), dt),
            "wv": dense_init(gen, (d, d), dt),
            "wg": dense_init(gen, (d, d), dt),
            "wo": dense_init(gen, (d, d), dt),
            "w0": full((d,), -5.0, torch.float32),      # base decay
            "w_lora_a": dense_init(gen, (d, LORA_RANK), dt),
            "w_lora_b": dense_init(gen, (LORA_RANK, d), dt, scale=0.01),
            "u": full((n_heads(cfg), HEAD_DIM), 0.0, torch.float32),
            "ln_x": full((d,), 1.0),             # per-head group norm
            "tm_norm": full((d,), 1.0),
            # channel mix
            "mu_c": full((2, d), 0.5),
            "ck": dense_init(gen, (d, cfg.d_ff), dt),
            "cv": dense_init(gen, (cfg.d_ff, d), dt),
            "cr": dense_init(gen, (d, d), dt),
            "cm_norm": full((d,), 1.0),
        }

    return {
        "embed": dense_init(gen, (V, d), dt, scale=0.02),
        "blocks": _stack([block_init() for _ in range(cfg.n_layers)]),
        "final_norm": full((d,), 1.0),
        "lm_head": dense_init(gen, (d, V), dt),
    }


def param_specs(cfg, fsdp=None, tp: int = 16) -> dict:
    """Spec tuples mirroring init()'s structure (the reference's)."""
    block = {
        "mu": (None, None), "wr": (fsdp, "model"), "wk": (fsdp, "model"),
        "wv": (fsdp, "model"), "wg": (fsdp, "model"), "wo": ("model", fsdp),
        "w0": (None,), "w_lora_a": (fsdp, None), "w_lora_b": (None, "model"),
        "u": (None, None), "ln_x": (None,), "tm_norm": (None,),
        "mu_c": (None, None), "ck": (fsdp, "model"), "cv": ("model", fsdp),
        "cr": (fsdp, None), "cm_norm": (None,),
    }
    return {
        "embed": ("model", fsdp),
        "blocks": _stacked(block),
        "final_norm": (None,),
        "lm_head": (fsdp, "model"),
    }


# ---------------------------------------------------------------------------
# Core mixing
# ---------------------------------------------------------------------------
# `mm` is the product: layers.matmul (the row-stream kernel) at decode,
# torch.matmul over all rows of a prompt.

def _decay(bp: dict, xw: torch.Tensor, mm=matmul,
           mesh=None) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1): w = exp(-exp(w0 +
    lora)), the LoRA in the model dtype, the rest in fp32. On a
    tensor-parallel `mesh`, w_lora_b holds this rank's columns and the
    decay is its channels' (w0 sliced to them)."""
    hidden = copy_to_model(torch.tanh(mm(xw, bp["w_lora_a"])), mesh)
    lora = mm(hidden, bp["w_lora_b"])
    return torch.exp(-torch.exp(slice_for_model(bp["w0"], mesh, 0)
                                + lora.float()))


def _group_norm(o: torch.Tensor, ln_x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Per-head norm of o (..., H, hd) fp32 with the population variance,
    then cast to the model dtype and scaled by ln_x: (..., H * hd)."""
    o = (o - o.mean(-1, keepdim=True)) \
        * torch.rsqrt(o.var(-1, keepdim=True, correction=0) + 64e-5)
    return o.flatten(-2).to(dtype) * ln_x


def _time_mix_step(bp: dict, cfg, x: torch.Tensor, x_prev: torch.Tensor,
                   S: torch.Tensor, mesh=None) -> tuple:
    """One token of time mixing. x, x_prev: (b, d); S: (b, H, hd, hd)
    fp32. Returns (out (b, d), new S). On a tensor-parallel `mesh` (see
    :func:`decode_step`) on this rank's H / n heads, as
    :func:`_time_mix_seq`: S holds them, and wo's partial product is
    summed over ``model``."""
    H, hd = n_heads(cfg) // model_size(mesh), HEAD_DIM
    b = x.shape[0]
    mix = x[:, None, :] + (x_prev - x)[:, None, :] * bp["mu"]     # (b, 5, d)
    xr, xk, xv, xg, xw = mix.unbind(1)
    r = matmul(xr, bp["wr"]).reshape(b, H, hd).float()
    k = matmul(xk, bp["wk"]).reshape(b, H, hd).float()
    v = matmul(xv, bp["wv"]).reshape(b, H, hd).float()
    g = F.silu(matmul(xg, bp["wg"]))
    w = _decay(bp, xw, matmul, mesh).reshape(b, H, hd)
    kv = k[..., :, None] * v[..., None, :]                        # rank-1
    u = slice_for_model(bp["u"], mesh, 0)
    o = torch.einsum("bhk,bhkv->bhv", r, S + u[None, :, :, None] * kv)
    S = w[..., None] * S + kv
    o = _group_norm(o, slice_for_model(bp["ln_x"], mesh, 0), x.dtype)
    return all_reduce_sum(matmul(o * g, bp["wo"]), mesh, TP_AXIS), S


def _channel_mix_step(bp: dict, x: torch.Tensor, x_prev: torch.Tensor,
                      mm=matmul, mesh=None) -> torch.Tensor:
    """Channel mix of x (..., d) against its shifted x_prev; on a
    tensor-parallel `mesh` ck by columns, cv by rows summed over the
    ranks, cr whole."""
    mix = x[..., None, :] + (x_prev - x)[..., None, :] * bp["mu_c"]
    xk, xr = mix.unbind(-2)
    k = torch.square(torch.relu(mm(copy_to_model(xk, mesh), bp["ck"])))
    return reduce_from_model(mm(k, bp["cv"]), mesh) \
        * torch.sigmoid(mm(xr, bp["cr"]))


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token of each position, zeros at t = 0: (b, s, d)."""
    return F.pad(x[:, :-1], (0, 0, 1, 0))


def _time_mix_seq(bp: dict, cfg, x: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """Time mixing of a whole normed sequence x (b, s, d) from a zero
    state: the mixes and projections over all b * s rows, the recurrence
    in one ``rwkv_scan`` call; on a tensor-parallel `mesh` on this rank's
    H / n heads."""
    H, hd = n_heads(cfg) // model_size(mesh), HEAD_DIM
    b, s, d = x.shape
    mm = torch.matmul
    mix = x[:, :, None, :] + (_shift(x) - x)[:, :, None, :] * bp["mu"]
    xr, xk, xv, xg, xw = mix.unbind(2)
    xr, xk, xv, xg = (copy_to_model(t, mesh) for t in (xr, xk, xv, xg))
    r = mm(xr, bp["wr"]).reshape(b, s, H, hd).float()
    k = mm(xk, bp["wk"]).reshape(b, s, H, hd).float()
    v = mm(xv, bp["wv"]).reshape(b, s, H, hd).float()
    g = F.silu(mm(xg, bp["wg"]))
    w = _decay(bp, xw, mm, mesh).reshape(b, s, H, hd)
    o, _ = rwkv_scan(r, k, v, w, slice_for_model(bp["u"], mesh, 0))
    o = _group_norm(o, slice_for_model(bp["ln_x"], mesh, 0), x.dtype)
    return reduce_from_model(mm(o * g, bp["wo"]), mesh)


def _layer_seq(bp: dict, cfg, h: torch.Tensor, mesh=None) -> torch.Tensor:
    """Full-sequence layer. h: (b, s, d)."""
    hn = rmsnorm(h, bp["tm_norm"], cfg.norm_eps)
    h = h + _time_mix_seq(bp, cfg, hn, mesh)
    hn = rmsnorm(h, bp["cm_norm"], cfg.norm_eps)
    return h + _channel_mix_step(bp, hn, _shift(hn), torch.matmul, mesh)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def forward(params: dict, cfg, tokens: torch.Tensor,
            remat: bool = False, mesh=None) -> torch.Tensor:
    """tokens: (b, s) int. Returns logits (b, s, V_padded). With `remat`
    each layer is recomputed in the backward (the reference's
    jax.checkpoint of its layer). With a `mesh` whose ``model`` axis holds
    n > 1 ranks, `params` are this rank's shards (see the module
    docstring); the logits are gathered whole on every rank. On a
    ``model`` axis of one rank, or without a mesh, this is the
    single-process forward."""
    n = model_size(mesh)
    tp = mesh if n > 1 else None
    if tp is not None:
        check_train_shards(params, cfg, n)
    h = _embed(params["embed"], tokens, cfg, tp)
    for bp in _layers(params["blocks"]):
        h = remat_call(remat, _layer_seq, bp, cfg, h, tp)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(copy_to_model(h, tp), params["lm_head"])
    return gather_from_model(logits, tp, -1)


def train_tp_refusal(cfg, n: int) -> str | None:
    """Why `cfg` cannot compute on the shards of a ``model`` axis of n
    ranks, or None where it can: n must divide the heads (so each rank
    scans whole heads), d_ff and the padded vocab."""
    V = padded_vocab(cfg.vocab)
    for what, size in (("heads", n_heads(cfg)), ("d_ff", cfg.d_ff),
                       ("padded vocab", V)):
        if size % n:
            return (f"{cfg.name}: its {what} ({size} at d_model "
                    f"{cfg.d_model}) do not split over {n} ranks of the "
                    f"model axis")
    return None


def check_train_shards(params: dict, cfg, n: int) -> None:
    """Raise unless `params` hold this rank's 1/n of every leaf the
    training forward on a ``model`` axis of n ranks splits; where `cfg`
    cannot compute on shards (:func:`train_tp_refusal`), raise that."""
    refusal = train_tp_refusal(cfg, n)
    if refusal is not None:
        raise NotImplementedError(refusal)
    d, V = cfg.d_model, padded_vocab(cfg.vocab)
    blocks = params["blocks"]
    got = {"wr": blocks["wr"].shape[-1], "wo": blocks["wo"].shape[-2],
           "w_lora_b": blocks["w_lora_b"].shape[-1],
           "ck": blocks["ck"].shape[-1], "cv": blocks["cv"].shape[-2],
           "embed": params["embed"].shape[0],
           "lm_head": params["lm_head"].shape[-1]}
    want = {"wr": d // n, "wo": d // n, "w_lora_b": d // n,
            "ck": cfg.d_ff // n, "cv": cfg.d_ff // n, "embed": V // n,
            "lm_head": V // n}
    if got != want:
        raise ValueError(f"{cfg.name}: split leaves hold {got} on this "
                         f"rank; a model axis of {n} ranks needs {want} "
                         f"(parameters placed by param_specs)")


def init_state(cfg, batch: int, device="cuda", mesh=None) -> dict:
    """Recurrent decode state (per layer): the previous token's normed
    activations of each mix, in the model dtype, and the (H, hd, hd) fp32
    linear-attention state; O(1) in sequence length. On a `mesh`, this
    rank's share under ``state_specs``: its rows of the batch
    (``sharding.batch_rows``) and, where ``model`` holds n > 1 ranks, its
    H / n heads of S (refused with :func:`train_tp_refusal`'s reason
    where the shapes do not split)."""
    d, L = cfg.d_model, cfg.n_layers
    H = n_heads(cfg)
    n = model_size(mesh)
    if n > 1:
        refusal = train_tp_refusal(cfg, n)
        if refusal is not None:
            raise NotImplementedError(refusal)
        H //= n
    if mesh is not None:
        start, stop = batch_rows(batch, mesh)
        batch = stop - start
    return {
        "x_tm": torch.zeros((L, batch, d), dtype=_dtype(cfg), device=device),
        "x_cm": torch.zeros((L, batch, d), dtype=_dtype(cfg), device=device),
        "S": torch.zeros((L, batch, H, HEAD_DIM, HEAD_DIM),
                         dtype=torch.float32, device=device),
    }


def state_specs(cfg) -> dict:
    """The decode state's spec tuples (the reference's)."""
    return {
        "x_tm": (None, ("pod", "data"), None),
        "x_cm": (None, ("pod", "data"), None),
        "S": (None, ("pod", "data"), "model", None, None),
    }


def decode_step(params: dict, cfg, token: torch.Tensor, state: dict,
                pos=None, mesh=None) -> tuple:
    """token: (b, 1) int. Returns (logits (b, 1, V_padded), state).

    The state is updated in place, layer by layer (JAX returns a new
    state); the returned state is the same dict. ``pos`` is unused, as in
    the reference. On a `mesh` the tokens, the state
    (``init_state(mesh=...)``) and the logits are this rank's rows; where
    ``model`` holds n > 1 ranks, `params` are this rank's shards under
    ``param_specs`` (every split one checked, :func:`check_train_shards`):
    the vocab-parallel embedding, each layer on the rank's heads (see the
    module docstring), the head's columns gathered over ``model``. On a
    ``model`` axis of one rank this is the meshless step."""
    n = model_size(mesh)
    tp = mesh if n > 1 else None
    if tp is not None:
        check_train_shards(params, cfg, n)
    h = _embed(params["embed"], token[:, 0], cfg, tp)             # (b, d)
    blocks = params["blocks"]
    for i in range(state["S"].shape[0]):
        bp = _index(blocks, i)
        hn = rmsnorm(h, bp["tm_norm"], cfg.norm_eps)
        o, S = _time_mix_step(bp, cfg, hn, state["x_tm"][i], state["S"][i],
                              tp)
        h = h + o
        hn2 = rmsnorm(h, bp["cm_norm"], cfg.norm_eps)
        h = h + _channel_mix_step(bp, hn2, state["x_cm"][i], matmul, tp)
        state["x_tm"][i] = hn
        state["x_cm"][i] = hn2
        state["S"][i] = S
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = matmul(h, params["lm_head"])
    if tp is not None:
        logits = all_gather(logits, tp, TP_AXIS, -1)
    return logits[:, None, :], state
