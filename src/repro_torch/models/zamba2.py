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
the backward); its ``param_specs``/``state_specs`` wait for the
distributed slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from ..distributed.sharding import padded_heads, padded_vocab
from .layers import (attn_params, decode_attention, dense_init, ffn_params,
                     matmul, rmsnorm, self_attention, swiglu)
from .transformer import (_dtype, _index, _layers, _stack, _stacked,
                          attn_specs, ffn_specs, remat_call)

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
# Mamba2 core
# ---------------------------------------------------------------------------

def _split_proj(cfg, proj: torch.Tensor) -> tuple:
    """in_proj's output (..., 2 din + 2 N + nh) -> z, x, B, C, dt."""
    s = _ssm(cfg)
    din = inner_dim(cfg)
    return torch.split(proj, [din, din, s.state_dim, s.state_dim,
                              ssm_heads(cfg)], dim=-1)


def _ssd_scan(bp: dict, cfg, xc: torch.Tensor, Bc: torch.Tensor,
              Cc: torch.Tensor, dt_raw: torch.Tensor,
              H0: torch.Tensor) -> tuple:
    """Sequential SSD over time. xc: (b, s, din); Bc/Cc: (b, s, N);
    dt_raw: (b, s, nh); H0: (b, nh, hd, N) fp32. Returns y (b, s, din) in
    xc's dtype and the final state, which is H0 itself, updated in place
    (the decode state's own layer slice, or a fresh zero state), unless
    autograd records the scan (a training forward): then each token's
    state is a new tensor, with the same arithmetic.

    The terms that do not depend on the state are formed for many tokens
    at once: the fp32 casts, the decays a = exp(dt A), D x, and the
    updates (B outer x) * dt, in the reference's order, SCAN_CHUNK tokens
    at a time (bounding their memory). Only the state update a * H + that
    and its read-out H . C run token by token."""
    nh, hd = ssm_heads(cfg), _ssm(cfg).head_dim
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


def _mamba_block_seq(bp: dict, cfg, h: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block from a zero state. h: (b, s, d)."""
    s = _ssm(cfg)
    din = inner_dim(cfg)
    hn = rmsnorm(h, bp["norm"], cfg.norm_eps)
    z, x, B, C, dtr = _split_proj(cfg, torch.matmul(hn, bp["in_proj"]))
    xBC = _causal_conv(bp["conv_w"], torch.cat([x, B, C], -1))
    xc, Bc, Cc = torch.split(xBC, [din, s.state_dim, s.state_dim], -1)
    H0 = torch.zeros((h.shape[0], ssm_heads(cfg), s.head_dim, s.state_dim),
                     dtype=torch.float32, device=h.device)
    y, _ = _ssd_scan(bp, cfg, xc, Bc, Cc, dtr, H0)
    y = rmsnorm(y * F.silu(z), bp["gate_norm"], cfg.norm_eps)
    return h + torch.matmul(y, bp["out_proj"])


def _shared_block_seq(sp: dict, cfg, h: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """The shared attention + SwiGLU block over a whole sequence."""
    h = h + self_attention(sp["attn"],
                           rmsnorm(h, sp["attn_norm"], cfg.norm_eps),
                           cfg, positions)
    f = swiglu(sp["ffn"], rmsnorm(h, sp["ffn_norm"], cfg.norm_eps),
               torch.matmul)
    return h + f


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _pattern(cfg) -> tuple[int, int]:
    """Layer pattern: shared attention after every `shared_attn_every`
    mamba blocks. Returns (k, number of shared applications)."""
    k = cfg.shared_attn_every or (cfg.n_layers + 1)
    return k, cfg.n_layers // k


def forward(params: dict, cfg, tokens: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """tokens: (b, s) int -> logits (b, s, V_padded). n_shared units of
    (k mamba blocks + the shared block), then the remaining blocks. With
    `remat` each Mamba2 block is recomputed in the backward, as the
    reference checkpoints its Mamba2 block (not the shared one)."""
    b, s = tokens.shape
    h = params["embed"][tokens]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    k, n_shared = _pattern(cfg)
    layers = _layers(params["blocks"])
    for i in range(cfg.n_layers):
        h = remat_call(remat, _mamba_block_seq, layers[i], cfg, h)
        if i < n_shared * k and (i + 1) % k == 0:
            h = _shared_block_seq(params["shared"], cfg, h, positions)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return torch.matmul(h, params["lm_head"])


def init_state(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda", tp: int = 1) -> dict:
    """Decode state: per-layer SSM state (fp32) and conv tail (model
    dtype), plus a KV cache in `dtype` (bf16 by default, also for an fp32
    model, as in the reference) for the shared block at each of its
    application depths: a ring buffer of the window where one is set.
    `tp` changes nothing: the KV heads are not padded."""
    s = _ssm(cfg)
    _, n_shared = _pattern(cfg)
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    hd = cfg.resolved_head_dim
    kv = (n_shared, batch, cfg.n_kv_heads, S, hd)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, ssm_heads(cfg), s.head_dim,
                            s.state_dim), dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, s.conv_width - 1,
                             inner_dim(cfg) + 2 * s.state_dim),
                            dtype=_dtype(cfg), device=device),
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
    }


def state_specs(cfg) -> dict:
    """The decode state's spec tuples (the reference's)."""
    return {
        "ssm": (None, ("pod", "data"), "model", None, None),
        "conv": (None, ("pod", "data"), None, "model"),
        "k": (None, ("pod", "data"), None, "model", None),
        "v": (None, ("pod", "data"), None, "model", None),
    }


def _mamba_block_step(bp: dict, cfg, h: torch.Tensor,
                      ssm_state: torch.Tensor,
                      conv_tail: torch.Tensor) -> torch.Tensor:
    """Single-token mamba block. h: (b, d). Updates this layer's SSM state
    (b, nh, hd, N) and conv tail (b, w - 1, c) in place."""
    s = _ssm(cfg)
    din = inner_dim(cfg)
    hn = rmsnorm(h, bp["norm"], cfg.norm_eps)
    z, x, B, C, dtr = _split_proj(cfg, matmul(hn, bp["in_proj"]))
    xBC = torch.cat([x, B, C], -1)                               # (b, c)
    win = torch.cat([conv_tail, xBC[:, None, :]], 1)             # (b, w, c)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", win, bp["conv_w"]))
    xc, Bc, Cc = torch.split(conv_out, [din, s.state_dim, s.state_dim], -1)
    y, _ = _ssd_scan(bp, cfg, xc[:, None], Bc[:, None], Cc[:, None],
                     dtr[:, None], ssm_state)
    conv_tail.copy_(win[:, 1:])
    y = rmsnorm(y[:, 0] * F.silu(z), bp["gate_norm"], cfg.norm_eps)
    return h + matmul(y, bp["out_proj"])


def _shared_block_step(sp: dict, cfg, h: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, pos: int,
                       slot: int) -> torch.Tensor:
    """One application of the shared attention + SwiGLU block to one
    token. h: (b, d). Writes the token's K/V into this application's
    caches (b, h_kv, S, hd) at `slot`, in place."""
    x = rmsnorm(h[:, None, :], sp["attn_norm"], cfg.norm_eps)
    h = h + decode_attention(sp["attn"], x, cfg, k_cache, v_cache, pos,
                             slot)[:, 0]
    return h + swiglu(sp["ffn"], rmsnorm(h, sp["ffn_norm"], cfg.norm_eps))


def decode_step(params: dict, cfg, token: torch.Tensor, state: dict,
                pos: int) -> tuple:
    """token: (b, 1) int; pos: host int. Returns (logits (b, 1, V_padded),
    state).

    The state is updated in place (JAX returns a new one): each layer's
    SSM state and conv tail, and the new token's K/V at slot ``pos`` (``pos
    % S`` with a sliding window) of the shared block's cache at each of
    its depths. The returned state is the same dict."""
    h = params["embed"][token][:, 0]                             # (b, d)
    k, n_shared = _pattern(cfg)
    S = state["k"].shape[3]
    slot = pos % S if cfg.sliding_window else pos
    blocks, sp = params["blocks"], params["shared"]
    for i in range(cfg.n_layers):
        h = _mamba_block_step(_index(blocks, i), cfg, h, state["ssm"][i],
                              state["conv"][i])
        if i < n_shared * k and (i + 1) % k == 0:
            u = i // k
            h = _shared_block_step(sp, cfg, h, state["k"][u], state["v"][u],
                                   pos, slot)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return matmul(h, params["lm_head"])[:, None, :], state
