"""Plain PyTorch versions of the RWKV6 time-mix scan and of its backward:
the sequential recurrence, one token at a time, in fp32.

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (diag(u) k_t^T v_t + S_{t-1})
"""
from __future__ import annotations

import torch


def rwkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor) -> tuple:
    """r/k/v/w: (b, s, H, hd); u: (H, hd). Returns (o (b, s, H, hd) in
    r's dtype, final state (b, H, hd, hd) fp32), as
    ``repro.kernels.rwkv_scan.ref.rwkv_scan_ref`` does from a zero state."""
    b, s, H, hd = r.shape
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    u32 = u.float()[None, :, :, None]
    S = torch.zeros((b, H, hd, hd), dtype=torch.float32, device=r.device)
    o = torch.empty((b, s, H, hd), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]   # rank-1 update
        o[:, t] = torch.einsum("bhk,bhkv->bhv", r32[:, t], S + u32 * kv)
        S = w32[:, t, :, :, None] * S + kv
    return o.to(r.dtype), S


def rwkv_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                      dS: torch.Tensor | None = None) -> tuple:
    """Gradients of :func:`rwkv_scan_ref` given do (b, s, H, hd), the
    gradient of o, and dS (b, H, hd, hd), the gradient of the final state
    (None: zero). A walk forward keeps every S_{t-1}; the walk back carries
    G_t = dL/dS_t from G_{s-1} = dS:

        dr_t = S_{t-1} do_t + u * k_t (v_t . do_t)
        dk_t = G_t v_t + u * r_t (v_t . do_t)
        dv_t = G_t^T k_t + (sum_i r_t u k_t) do_t
        dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
        du = sum over b and t of r_t * k_t (v_t . do_t)
        G_{t-1} = diag(w_t) G_t + r_t^T do_t

    All in fp32. Returns (dr, dk, dv, dw) (b, s, H, hd) in r's dtype and du
    (H, hd) in u's dtype."""
    b, s, H, hd = r.shape
    r32, k32, v32, w32, do32 = (x.float() for x in (r, k, v, w, do))
    u32 = u.float()
    states = [torch.zeros((b, H, hd, hd), dtype=torch.float32,
                          device=r.device)]
    for t in range(s - 1):
        states.append(w32[:, t, :, :, None] * states[-1]
                      + k32[:, t, :, :, None] * v32[:, t, :, None, :])
    G = (dS.float().clone() if dS is not None
         else torch.zeros_like(states[0]))
    grads = [torch.empty((b, s, H, hd), dtype=torch.float32, device=r.device)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((H, hd), dtype=torch.float32, device=r.device)
    for t in reversed(range(s)):
        rt, kt, vt, wt, dot = (x[:, t] for x in (r32, k32, v32, w32, do32))
        Sp = states[t]
        vdo = (vt * dot).sum(-1, keepdim=True)                  # (b, H, 1)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", Sp, dot) + u32 * kt * vdo
        dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vt) + u32 * rt * vdo
        dv[:, t] = torch.einsum("bhij,bhi->bhj", G, kt) \
            + (rt * u32 * kt).sum(-1, keepdim=True) * dot
        dw[:, t] = (G * Sp).sum(-1)
        du += (rt * kt * vdo).sum(0)
        G = wt[..., None] * G + rt[..., None] * dot[..., None, :]
    return (*(g.to(r.dtype) for g in grads), du.to(u.dtype))


def rwkv_scan_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          w: torch.Tensor, u: torch.Tensor,
                          chunk: int = 16) -> tuple:
    """The CUDA kernel's algebra in fp32 on any device: a test aid on no
    path. The tiles of ``kernel.tile_bounds(s, chunk)`` in order, each
    padded to TILE rows with r = k = v = 0, w = 1, with its decays as
    running products of w (no log or exp):

        A[i, j] = sum_d r[i,d] k[j,d] prod_{j<t<i} w[t,d]   (j < i)
        A[i, i] = sum_d r[i,d] u[d] k[i,d]
        o       = A v + (r * prod_{t<i} w) S
        S       = prod_t w * S + (k * prod_{t>j} w)^T v

    Below the diagonal, A is built as the kernel builds it: for j in an
    earlier block of BLK tokens than i's block b, r~[i] . k~_b[j] with
    r~[i] = r[i] prod_{BLK b <= t < i} w[t] and k~_b[j] = k[j]
    prod_{j < t < BLK b} w[t]; within a block, directly. Same arguments and
    results as :func:`rwkv_scan_ref`."""
    from .kernel import BLK, TILE, tile_bounds
    b, s, H, hd = r.shape
    r32, k32, v32, w32 = (x.float().transpose(1, 2) for x in (r, k, v, w))
    u32 = u.float()[None, :, None, :]                     # (1, H, 1, hd)
    S = torch.zeros((b, H, hd, hd), dtype=torch.float32, device=r.device)
    o = torch.empty((b, H, s, hd), dtype=torch.float32, device=r.device)

    def excl(x):                  # exclusive running product along tokens
        ones = torch.ones_like(x[:, :, :1])
        return torch.cumprod(torch.cat([ones, x[:, :, :-1]], 2), 2)

    for t0, n in tile_bounds(s, chunk):
        pad = [0, 0, 0, TILE - n]
        rt, kt, vt = (torch.nn.functional.pad(x[:, :, t0:t0 + n], pad)
                      for x in (r32, k32, v32))
        wt = torch.nn.functional.pad(w32[:, :, t0:t0 + n], pad, value=1.0)
        before = excl(wt)                                 # prod_{t<i}
        after = excl(wt.flip(2)).flip(2)                  # prod_{t>j}
        A = torch.diag_embed((rt * u32 * kt).sum(-1))
        for blk in range(0, TILE, BLK):
            rtil = rt[:, :, blk:blk + BLK] * excl(wt[:, :, blk:blk + BLK])
            if blk:
                ktil = kt[:, :, :blk] * excl(wt[:, :, :blk].flip(2)).flip(2)
                A[:, :, blk:blk + BLK, :blk] = rtil @ ktil.transpose(2, 3)
            for i in range(blk + 1, blk + BLK):
                for j in range(blk, i):
                    dec = wt[:, :, j + 1:i].prod(2)
                    A[:, :, i, j] = (rt[:, :, i] * kt[:, :, j] * dec).sum(-1)
        o[:, :, t0:t0 + n] = (A @ vt + (rt * before) @ S)[:, :, :n]
        S = (before[:, :, -1] * wt[:, :, -1])[..., None] * S \
            + (kt * after).transpose(2, 3) @ vt
    return o.transpose(1, 2).to(r.dtype), S
