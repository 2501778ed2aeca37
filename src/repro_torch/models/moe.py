"""Mixture-of-Experts FFN (granite-moe 40e top-8, phi3.5-moe 16e top-2).

The PyTorch counterpart of ``repro.models.moe``: GShard-style
capacity-based dispatch. Tokens are processed in groups; within a group
each token's top-k experts receive it up to a static per-expert capacity
(overflow tokens are dropped: their combine weight is zero). Expert
weights are stacked (E, d, ff), so the layer is routing plus three batched
expert products.

The port runs on one device, so the reference's cap of the group at a pod
boundary never applies and its sharding hints have no counterpart. The
router product takes ``mm``: the row-stream kernel at decode
(``layers.matmul``), torch.matmul over all rows of a prompt. The expert
products are torch.einsum on both paths, as the reference computes them
outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init, matmul


def moe_params(gen: torch.Generator, cfg, dtype) -> dict:
    """The router is fp32 whatever the model's dtype. (dense_init's fan-in
    is shape[0], so the stacked expert weights are scaled by
    1/sqrt(n_experts), as in the reference.)"""
    m = cfg.moe
    d = cfg.d_model
    return {
        "router": dense_init(gen, (d, m.n_experts), torch.float32),
        "w_gate": dense_init(gen, (m.n_experts, d, m.expert_d_ff), dtype),
        "w_up": dense_init(gen, (m.n_experts, d, m.expert_d_ff), dtype),
        "w_down": dense_init(gen, (m.n_experts, m.expert_d_ff, d), dtype),
    }


def moe_param_specs(cfg, fsdp, tp: int) -> dict:
    """Spec tuples of :func:`moe_params` (the reference's): experts over
    ``model`` when they divide over TP (expert parallelism), else each
    expert's FFN width."""
    m = cfg.moe
    ep = (m.n_experts % tp == 0)
    if ep:
        return {
            "router": (None, None),
            "w_gate": ("model", fsdp, None),
            "w_up": ("model", fsdp, None),
            "w_down": ("model", None, fsdp),
        }
    return {
        "router": (None, None),
        "w_gate": (None, fsdp, "model"),
        "w_up": (None, fsdp, "model"),
        "w_down": (None, "model", fsdp),
    }


def pick_group_size(cfg, cap: int = 512) -> int:
    """Routing-group length bounding dispatch overhead: the largest power
    of two (from 64, at most `cap`) under 0.3 * expert_d_ff /
    capacity_factor, as in the reference."""
    m = cfg.moe
    target = max(64, int(0.3 * m.expert_d_ff / m.capacity_factor))
    g = 64
    while g * 2 <= min(cap, target):
        g *= 2
    return g


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of `idx` over n classes; an index outside 0..n-1 gives
    a zero row, as jax.nn.one_hot does (F.one_hot raises)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """The k largest values over the last dim and their indices, ties
    broken by the lower index first, as jax.lax.top_k breaks them
    (torch.topk does not promise an order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _positions(gi: torch.Tensor, n_experts: int) -> tuple:
    """Position of each (token, slot) within its expert, counted slot-major
    so slot-0 assignments win capacity first. gi: (G, g, k) -> positions
    (G, g, k) int and the one-hot (G, g, k, E)."""
    G, g, k = gi.shape
    oh = _one_hot(gi, n_experts)
    oh_sm = oh.transpose(1, 2).reshape(G, k * g, n_experts)
    pos_sm = torch.cumsum(oh_sm, dim=1) - oh_sm
    pos = pos_sm.reshape(G, k, g, n_experts).transpose(1, 2)
    return torch.sum(pos * oh, -1).to(torch.int64), oh


def _experts(params: dict, ein: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its buffer: ein (G, E, C, d) -> (G, E,
    C, d)."""
    h = F.silu(torch.einsum("gecd,edf->gecf", ein, params["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", ein, params["w_up"])
    return torch.einsum("gecf,efd->gecd", h, params["w_down"])


def moe_ffn(params: dict, x: torch.Tensor, cfg, group_size: int | None = None,
            impl: str = "einsum", mm=matmul) -> torch.Tensor:
    """x: (b, s, d) -> (b, s, d).

    ``impl="einsum"`` (default) moves tokens into and out of the expert
    buffers with one-hot (t x E x C) dispatch and combine products;
    ``impl="gather"`` computes the same routing with an (E, C) table of
    token ids and gathers. `mm` is the router's product."""
    m = cfg.moe
    b, s, d = x.shape
    tokens = b * s
    if group_size is None:
        group_size = pick_group_size(cfg)
    g = min(group_size, tokens)
    while tokens % g:
        g -= 1
    n_groups = tokens // g
    xf = x.reshape(n_groups, g, d)

    # Routing in fp32.
    logits = mm(xf.float(), params["router"])                     # (G, g, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, m.top_k)                   # (G, g, k)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # Floor at top_k so tiny (decode-sized) groups cannot structurally
    # drop a token's every slot.
    capacity = max(m.top_k,
                   int(m.capacity_factor * g * m.top_k / m.n_experts))
    pos_tok, oh = _positions(gate_idx, m.n_experts)

    if impl == "gather":
        keep = pos_tok < capacity                                 # (G, g, k)
        # (E, C) table of source-token ids per group; empty slots point at
        # token 0 and are zeroed by `filled`. Dropped assignments are left
        # out here, where the reference points them at expert E and drops
        # the write.
        grp = torch.arange(n_groups, device=x.device)[:, None, None] \
            .expand_as(gate_idx)
        tok_ids = torch.arange(g, device=x.device)[None, :, None] \
            .expand_as(gate_idx)
        c_idx = torch.clamp(pos_tok, 0, capacity - 1)
        table = torch.zeros((n_groups, m.n_experts, capacity),
                            dtype=torch.int64, device=x.device)
        filled = torch.zeros((n_groups, m.n_experts, capacity),
                             dtype=torch.bool, device=x.device)
        sel = (grp[keep], gate_idx[keep], c_idx[keep])
        table[sel] = tok_ids[keep]
        filled[sel] = True
        ein = xf[torch.arange(n_groups, device=x.device)[:, None, None],
                 table] * filled[..., None].to(x.dtype)           # (G,E,C,d)
        out = _experts(params, ein)
        # Pull each (token, slot)'s result back and weight it.
        back = out[grp, gate_idx, c_idx]                          # (G,g,k,d)
        w = (gate_vals * keep).to(x.dtype)
        y = torch.einsum("gtk,gtkd->gtd", w, back)
    else:
        keep = (pos_tok[..., None] < capacity) & (oh > 0)
        pos_oh = _one_hot(pos_tok, capacity)
        sel = oh * keep
        dispatch = torch.einsum("gtke,gtkc->gtec", sel, pos_oh)
        combine = torch.einsum("gtk,gtke,gtkc->gtec", gate_vals, sel, pos_oh)
        ein = torch.einsum("gtec,gtd->gecd", dispatch, xf.float()).to(x.dtype)
        out = _experts(params, ein)
        y = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), out)
    return y.reshape(b, s, d)


def aux_load_balance_loss(router_probs: torch.Tensor, gate_idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e."""
    oh = _one_hot(gate_idx[..., 0], n_experts)
    f = torch.mean(oh, dim=tuple(range(oh.dim() - 1)))
    p = torch.mean(router_probs, dim=tuple(range(router_probs.dim() - 1)))
    return n_experts * torch.sum(f * p)
