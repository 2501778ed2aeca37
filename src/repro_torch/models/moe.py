"""Mixture-of-Experts FFN (granite-moe 40e top-8, phi3.5-moe 16e top-2).

The PyTorch counterpart of ``repro.models.moe``: GShard-style
capacity-based dispatch. Tokens are processed in groups; within a group
each token's top-k experts receive it up to a static per-expert capacity
(overflow tokens are dropped: their combine weight is zero). Expert
weights are stacked (E, d, ff), so the layer is routing plus three batched
expert products.

The router product takes ``mm``: the row-stream kernel at decode
(``layers.matmul``), torch.matmul over all rows of a prompt. The expert
products are torch.einsum on both paths, as the reference computes them
outside any Pallas kernel.

On a mesh (``moe_ffn`` with ``mesh``) two things follow the reference's
partitioning, where XLA sees the whole batch and splits the work:

* **Groups over the whole batch.** The reference forms its routing
  groups from the global batch's tokens in row order, capped only at a
  ``pod`` boundary, and its capacity from the group's length. Each rank
  here holds its contiguous rows of the batch (the batch axes split
  them, ``sharding.data_rows``), so :func:`route` gathers the ranks' chosen
  experts (integers, no gradient) over the batch axes, counts every
  assignment's position over the whole group, and keeps this rank's
  tokens' decisions. A token's expert output does not depend on which
  other tokens share the expert's buffer, only the drop decisions do, so
  each rank then dispatches its own tokens only, at their places in the
  groups, and gets the reference's output for them.
* **The experts on ``model`` shards** (``moe_param_specs``). Every rank
  of the ``model`` axis holds the same rows and routes them over all E
  experts with the replicated router. Where the axis divides E (expert
  parallelism) a rank holds E / n contiguous experts and computes their
  slices of the dispatch and the combine; otherwise it holds every
  expert's 1 / n of the FFN width (w_gate and w_up by columns, w_down by
  rows). Either way its output is a partial sum, summed over ``model``:
  by ``reduce_from_model`` where autograd records (training, with x and
  the router through ``copy_to_model``, since each rank's combine reaches
  only its own experts or columns, so their gradients are partial), by
  the decode collective ``all_reduce_sum`` otherwise. Both sum in fp32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import (BATCH_AXES, TP_AXIS, all_gather,
                                    all_reduce_sum, copy_to_model, data_rows,
                                    mesh_axis_sizes, model_rank, model_size,
                                    reduce_from_model)
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


def group_length(tokens: int, group_size: int, mesh=None) -> int:
    """The routing group's length for `tokens` tokens in all (the whole
    batch's): at most `group_size`, capped at a ``pod``'s share where the
    mesh has several pods that divide the tokens, then cut until it
    divides them, as in the reference."""
    g = min(group_size, tokens)
    if mesh is not None and "pod" in mesh.mesh_dim_names:
        pods = mesh_axis_sizes(mesh)["pod"]
        if pods > 1 and tokens % pods == 0:
            g = max(1, min(g, tokens // pods))
    while tokens % g:
        g -= 1
    return g


class Route(NamedTuple):
    """The routing of the groups that this rank's tokens fall in, each
    (G, g, ...) in the groups' token order. Where the rank holds every
    token, ``lo`` is 0 and ``own`` None; else its t tokens are tokens
    lo .. lo + t - 1 of the G * g, the others are other ranks' (their
    gates zero)."""
    gate_vals: torch.Tensor     # (G, g, k) fp32, normalised over the k
    gate_idx: torch.Tensor      # (G, g, k) every token's experts
    pos: torch.Tensor           # (G, g, k) position in the expert's buffer
    oh: torch.Tensor            # (G, g, k, E) one-hot of gate_idx
    keep: torch.Tensor          # (G, g, k) this rank's kept assignments
    capacity: int
    lo: int
    own: torch.Tensor | None    # (G, g) this rank's tokens


def _spread(a: torch.Tensor, lo: int, n_groups: int, g: int) -> torch.Tensor:
    """a (t, ...), this rank's tokens, at tokens lo .. lo + t - 1 of
    n_groups groups of g, zeros elsewhere: (n_groups, g, ...)."""
    hi = n_groups * g - lo - a.shape[0]
    if lo or hi:
        a = F.pad(a, (0, 0) * (a.dim() - 1) + (lo, hi))
    return a.reshape(n_groups, g, *a.shape[1:])


def route(router: torch.Tensor, x: torch.Tensor, cfg, group_size: int,
          mm=matmul, mesh=None) -> Route:
    """Top-k routing of x (b, s, d), this rank's rows, in groups of the
    whole batch (see the module docstring): gates in fp32 from `mm` of x
    and the router, positions slot-major over every token of each group,
    capacity from the group's length (at least top_k)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    index, count = data_rows(mesh)
    g = group_length(t * count, group_size, mesh)
    xf = x.reshape(-1, g if count == 1 else t, d)
    logits = mm(xf.float(), router)                               # (., ., E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, m.top_k)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)
    # Floor at top_k so tiny (decode-sized) groups cannot structurally
    # drop a token's every slot.
    capacity = max(m.top_k,
                   int(m.capacity_factor * g * m.top_k / m.n_experts))
    lo, own = 0, None
    if count > 1:
        first, lo = divmod(index * t, g)
        n_groups = -(-(lo + t) // g)
        every = all_gather(gate_idx.reshape(t, m.top_k), mesh, BATCH_AXES,
                           0)                                     # (T, k)
        gate_idx = every[first * g:(first + n_groups) * g].reshape(
            n_groups, g, m.top_k)
        gate_vals = _spread(gate_vals.reshape(t, m.top_k), lo, n_groups, g)
        own = torch.zeros(n_groups * g, dtype=torch.bool, device=x.device)
        own[lo:lo + t] = True
        own = own.reshape(n_groups, g)
    pos, oh = _positions(gate_idx, m.n_experts)
    keep = pos < capacity
    if own is not None:
        keep = keep & own[..., None]
    return Route(gate_vals, gate_idx, pos, oh, keep, capacity, lo, own)


def dropped(r: Route) -> int:
    """This rank's tokens' assignments that their experts' capacity
    drops."""
    own = r.keep.numel() if r.own is None \
        else int(r.own.sum()) * r.keep.shape[-1]
    return own - int(r.keep.sum())


def tp_refusal(cfg, n: int) -> str | None:
    """Why the experts of `cfg` cannot split over a ``model`` axis of n
    ranks (neither the experts nor their FFN width divide), or None."""
    m = cfg.moe
    if m.n_experts % n and m.expert_d_ff % n:
        return (f"{cfg.name}: neither its {m.n_experts} experts nor their "
                f"FFN width {m.expert_d_ff} split over {n} ranks of the "
                f"model axis")
    return None


def shard_shapes(cfg, n: int) -> dict:
    """The expert leaves' shapes on each rank of a ``model`` axis of n
    ranks under ``moe_param_specs`` (experts, or else their FFN width,
    split)."""
    m, d = cfg.moe, cfg.d_model
    E, ff = m.n_experts, m.expert_d_ff
    if E % n == 0:
        E //= n
    else:
        ff //= n
    return {"w_gate": (E, d, ff), "w_up": (E, d, ff), "w_down": (E, ff, d)}


def check_shards(params: dict, cfg, n: int) -> None:
    """Raise unless `params` (a block's or the stacked blocks' ``moe``
    leaves) hold this rank's shards of the experts on a ``model`` axis of
    n ranks (:func:`shard_shapes`); where they cannot split, raise
    :func:`tp_refusal`'s reason."""
    refusal = tp_refusal(cfg, n)
    if refusal is not None:
        raise NotImplementedError(refusal)
    want = shard_shapes(cfg, n)
    got = {k: tuple(params[k].shape[-3:]) for k in want}
    if got != want:
        raise ValueError(f"{cfg.name}: expert leaves hold {got} on this "
                         f"rank; a model axis of {n} ranks needs {want} "
                         f"(parameters placed by moe_param_specs)")


def moe_ffn(params: dict, x: torch.Tensor, cfg, group_size: int | None = None,
            impl: str = "einsum", mm=matmul, mesh=None) -> torch.Tensor:
    """x: (b, s, d) -> (b, s, d).

    ``impl="einsum"`` (default) moves tokens into and out of the expert
    buffers with one-hot (t x E x C) dispatch and combine products;
    ``impl="gather"`` computes the same routing with an (E, C) table of
    token ids and gathers, on one rank's whole batch and whole experts
    only (the reference keeps it for single-device serving research).
    `mm` is the router's product.

    On a `mesh` (see the module docstring) x is this rank's rows of the
    batch, split over the batch axes, and `params` its shards of the
    experts where ``model`` holds several ranks. Without a mesh, or where
    the batch axes and ``model`` each hold one rank, no collective runs
    and the function is the single-process one, call for call."""
    m = cfg.moe
    b, s, d = x.shape
    if group_size is None:
        group_size = pick_group_size(cfg)
    router = params["router"]
    tp = model_size(mesh) > 1
    if impl == "gather" and (tp or data_rows(mesh)[1] > 1):
        raise NotImplementedError("moe_ffn: impl='gather' runs on one "
                                  "rank's whole batch and experts only")
    if tp:
        x, router = copy_to_model(x, mesh), copy_to_model(router, mesh)
    r = route(router, x, cfg, group_size, mm, mesh)
    n_groups, g, k = r.gate_idx.shape
    xf = _spread(x.reshape(b * s, d), r.lo, n_groups, g)
    capacity = r.capacity

    if impl == "gather":
        # (E, C) table of source-token ids per group; empty slots point at
        # token 0 and are zeroed by `filled`. Dropped assignments are left
        # out here, where the reference points them at expert E and drops
        # the write.
        grp = torch.arange(n_groups, device=x.device)[:, None, None] \
            .expand_as(r.gate_idx)
        tok_ids = torch.arange(g, device=x.device)[None, :, None] \
            .expand_as(r.gate_idx)
        c_idx = torch.clamp(r.pos, 0, capacity - 1)
        table = torch.zeros((n_groups, m.n_experts, capacity),
                            dtype=torch.int64, device=x.device)
        filled = torch.zeros((n_groups, m.n_experts, capacity),
                             dtype=torch.bool, device=x.device)
        sel = (grp[r.keep], r.gate_idx[r.keep], c_idx[r.keep])
        table[sel] = tok_ids[r.keep]
        filled[sel] = True
        ein = xf[torch.arange(n_groups, device=x.device)[:, None, None],
                 table] * filled[..., None].to(x.dtype)           # (G,E,C,d)
        out = _experts(params, ein)
        # Pull each (token, slot)'s result back and weight it.
        back = out[grp, r.gate_idx, c_idx]                        # (G,g,k,d)
        w = (r.gate_vals * r.keep).to(x.dtype)
        y = torch.einsum("gtk,gtkd->gtd", w, back)
    else:
        keep = r.keep[..., None] & (r.oh > 0)
        pos_oh = _one_hot(r.pos, capacity)
        sel = r.oh * keep
        # This rank's experts: all E, or E / n contiguous ones under
        # expert parallelism.
        n_local = params["w_gate"].shape[0]
        if n_local < m.n_experts:
            e0 = model_rank(mesh) * n_local
            sel = sel[..., e0:e0 + n_local]
        dispatch = torch.einsum("gtke,gtkc->gtec", sel, pos_oh)
        combine = torch.einsum("gtk,gtke,gtkc->gtec", r.gate_vals, sel,
                               pos_oh)
        ein = torch.einsum("gtec,gtd->gecd", dispatch, xf.float()).to(x.dtype)
        out = _experts(params, ein)
        y = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), out)
    if r.own is not None:
        y = y.reshape(n_groups * g, d)[r.lo:r.lo + b * s]
    if tp:
        y = reduce_from_model(y, mesh) if torch.is_grad_enabled() \
            else all_reduce_sum(y, mesh, TP_AXIS)
    return y.reshape(b, s, d)


def aux_load_balance_loss(router_probs: torch.Tensor, gate_idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e."""
    oh = _one_hot(gate_idx[..., 0], n_experts)
    f = torch.mean(oh, dim=tuple(range(oh.dim() - 1)))
    p = torch.mean(router_probs, dim=tuple(range(router_probs.dim() - 1)))
    return n_experts * torch.sum(f * p)
