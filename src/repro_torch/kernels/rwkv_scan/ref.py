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


def _excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive running product along tokens (dim 2): prod_{t<i} x[t]."""
    ones = torch.ones_like(x[:, :, :1])
    return torch.cumprod(torch.cat([ones, x[:, :, :-1]], 2), 2)


def _tiles(xs: tuple, t0: int, n: int) -> tuple:
    """Tokens [t0, t0 + n) of (b, H, s, hd) tensors r, k, v, w, ...,
    padded to TILE rows with r = k = v = ... = 0 and w = 1 (the fourth)."""
    from .kernel import TILE
    pad = [0, 0, 0, TILE - n]
    return tuple(torch.nn.functional.pad(x[:, :, t0:t0 + n], pad,
                                         value=1.0 if q == 3 else 0.0)
                 for q, x in enumerate(xs))


def _tile_A(rt: torch.Tensor, kt: torch.Tensor, wt: torch.Tensor,
            u32: torch.Tensor) -> torch.Tensor:
    """The tile's 16 x 16 matrix A as ``csrc/rwkv_scan.cu`` builds it:

        A[i, j] = sum_d r[i,d] k[j,d] prod_{j<t<i} w[t,d]   (j < i)
        A[i, i] = sum_d r[i,d] u[d] k[i,d]

    for j in an earlier block of BLK tokens than i's block b, r~[i] .
    k~_b[j] with r~[i] = r[i] prod_{BLK b <= t < i} w[t] and k~_b[j] =
    k[j] prod_{j < t < BLK b} w[t]; within a block, directly."""
    from .kernel import BLK, TILE
    A = torch.diag_embed((rt * u32 * kt).sum(-1))
    for blk in range(0, TILE, BLK):
        rtil = rt[:, :, blk:blk + BLK] * _excl(wt[:, :, blk:blk + BLK])
        if blk:
            ktil = kt[:, :, :blk] * _excl(wt[:, :, :blk].flip(2)).flip(2)
            A[:, :, blk:blk + BLK, :blk] = rtil @ ktil.transpose(2, 3)
        for i in range(blk + 1, blk + BLK):
            for j in range(blk, i):
                dec = wt[:, :, j + 1:i].prod(2)
                A[:, :, i, j] = (rt[:, :, i] * kt[:, :, j] * dec).sum(-1)
    return A


def rwkv_scan_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          w: torch.Tensor, u: torch.Tensor,
                          chunk: int = 16) -> tuple:
    """The CUDA kernel's algebra in fp32 on any device: a test aid on no
    path. The tiles of ``kernel.tile_bounds(s, chunk)`` in order, each
    padded to TILE rows with r = k = v = 0, w = 1, with its decays as
    running products of w (no log or exp) and A from :func:`_tile_A`:

        o = A v + (r * prod_{t<i} w) S
        S = prod_t w * S + (k * prod_{t>j} w)^T v

    Same arguments and results as :func:`rwkv_scan_ref`."""
    from .kernel import tile_bounds
    b, s, H, hd = r.shape
    xs = tuple(x.float().transpose(1, 2) for x in (r, k, v, w))
    u32 = u.float()[None, :, None, :]                     # (1, H, 1, hd)
    S = torch.zeros((b, H, hd, hd), dtype=torch.float32, device=r.device)
    o = torch.empty((b, H, s, hd), dtype=torch.float32, device=r.device)
    for t0, n in tile_bounds(s, chunk):
        rt, kt, vt, wt = _tiles(xs, t0, n)
        before = _excl(wt)                                # prod_{t<i}
        after = _excl(wt.flip(2)).flip(2)                 # prod_{t>j}
        A = _tile_A(rt, kt, wt, u32)
        o[:, :, t0:t0 + n] = (A @ vt + (rt * before) @ S)[:, :, :n]
        S = (before[:, :, -1] * wt[:, :, -1])[..., None] * S \
            + (kt * after).transpose(2, 3) @ vt
    return o.transpose(1, 2).to(r.dtype), S


def rwkv_scan_bwd_chunked_ref(r: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, w: torch.Tensor,
                              u: torch.Tensor, do: torch.Tensor,
                              dS: torch.Tensor | None = None) -> tuple:
    """The backward kernel's algebra (``csrc/rwkv_scan_bwd.cu``) in fp32
    on any device: a test aid on no path. Same arguments and results as
    :func:`rwkv_scan_bwd_ref`.

    Tiles of TILE tokens from 0, the last one ragged, each padded with
    r = k = v = do = 0, w = 1. A walk forward keeps S_in, the state before
    each tile. The walk back carries G_out, the gradient of the state
    after the tile (dS after the last). Per tile, with before_t = prod_{t'<t}
    w, after_t = prod_{t'>t} w, W = prod w, A from :func:`_tile_A` and
    dA = do v^T on and below the diagonal:

        D = diag(G_out S_in^T),  P = v G_out^T,  Q = do S_in^T
        dv = (k * after) G_out + A^T do
        dr = before * Q + sum_{tau<t} dA[t,tau] k_tau prod_{tau<t'<t} w
             + dA[t,t] u k_t
        dk = after * P + sum_{t>tau} dA[t,tau] r_t prod_{tau<t'<t} w
             + dA[tau,tau] u r_tau
        dw = before after D + after c + before e + g4,
             c_0 = 0, c_{t+1} = w_t c_t + k_t P_t,
             e_15 = 0, e_{t-1} = w_t e_t + r_t Q_t,
             g4_t = sum_{tau<t<t'} r_t' k_tau dA[t',tau]
                    prod_{tau<t''<t', t''!=t} w
        du += sum_t dA[t,t] r_t k_t
        G_in = W * G_out + (r * before)^T do

    dw is dw_t = sum_j G_t[i,j] S_{t-1}[i,j] with G_t and S_{t-1}
    expanded from G_out and S_in: no decay is ever divided, so w may be
    1e-35. g4 runs, for each t', h_{t'}(t) = sum_{tau<t} dA[t',tau] k_tau
    prod_{tau<t''<t} w forward in t (its end h_{t'}(t') is dr's sum) and
    adds r_t' prod_{t<t''<t'} w h_{t'}(t) to g4_t walking back."""
    from .kernel import TILE
    b, s, H, hd = r.shape
    xs = tuple(x.float().transpose(1, 2) for x in (r, k, v, w, do))
    u32 = u.float()[None, :, None, :]                     # (1, H, 1, hd)
    bounds = [(t0, min(TILE, s - t0)) for t0 in range(0, s, TILE)]
    S = torch.zeros((b, H, hd, hd), dtype=torch.float32, device=r.device)
    S_in = []
    for t0, n in bounds:
        S_in.append(S)
        _, kt, vt, wt, _ = _tiles(xs, t0, n)
        after = _excl(wt.flip(2)).flip(2)
        S = (after[:, :, 0] * wt[:, :, 0])[..., None] * S \
            + (kt * after).transpose(2, 3) @ vt
    G = (dS.float().clone() if dS is not None
         else torch.zeros_like(S))
    grads = [torch.empty((b, H, s, hd), dtype=torch.float32, device=r.device)
             for _ in range(4)]
    du = torch.zeros((H, hd), dtype=torch.float32, device=r.device)
    for (t0, n), Sin in zip(reversed(bounds), reversed(S_in)):
        rt, kt, vt, wt, dot = _tiles(xs, t0, n)
        before = _excl(wt)
        after = _excl(wt.flip(2)).flip(2)
        A = _tile_A(rt, kt, wt, u32)
        dA = (dot @ vt.transpose(2, 3)).tril()            # (b, H, T, T)
        D = (G * Sin).sum(-1)                             # (b, H, hd)
        P = vt @ G.transpose(2, 3)                        # (b, H, T, hd)
        Q = dot @ Sin.transpose(2, 3)
        dv = (kt * after) @ G + A.transpose(2, 3) @ dot
        dr_in = torch.zeros_like(rt)
        dk_in = torch.zeros_like(rt)
        g4 = torch.zeros_like(rt)
        for tp in range(TILE):
            h, hs = torch.zeros_like(rt[:, :, 0]), []
            for t in range(tp):
                hs.append(h)                              # h_{tp}(t)
                h = wt[:, :, t] * h + dA[:, :, tp, t, None] * kt[:, :, t]
            dr_in[:, :, tp] = h + dA[:, :, tp, tp, None] * u32[:, :, 0] \
                * kt[:, :, tp]
            rho = rt[:, :, tp]
            for t in range(tp - 1, 0, -1):
                g4[:, :, t] += rho * hs[t]
                rho = rho * wt[:, :, t]
            acc = dA[:, :, tp, tp, None] * u32[:, :, 0] * rt[:, :, tp]
            rho = torch.ones_like(acc)
            for t in range(tp + 1, TILE):
                acc = acc + dA[:, :, t, tp, None] * rt[:, :, t] * rho
                rho = rho * wt[:, :, t]
            dk_in[:, :, tp] = acc
        c = torch.zeros_like(rt[:, :, 0])
        e = torch.zeros_like(c)
        g2, g3 = torch.zeros_like(rt), torch.zeros_like(rt)
        for t in range(TILE):
            g2[:, :, t] = after[:, :, t] * c
            c = wt[:, :, t] * c + kt[:, :, t] * P[:, :, t]
            tb = TILE - 1 - t
            g3[:, :, tb] = before[:, :, tb] * e
            e = wt[:, :, tb] * e + rt[:, :, tb] * Q[:, :, tb]
        dr = before * Q + dr_in
        dk = after * P + dk_in
        dw = before * after * D[:, :, None] + g2 + g3 + g4
        for g, x in zip(grads, (dr, dk, dv, dw)):
            g[:, :, t0:t0 + n] = x[:, :, :n]
        du += (torch.diagonal(dA, dim1=2, dim2=3)[..., None] * rt
               * kt).sum((0, 2))
        G = (before[:, :, -1] * wt[:, :, -1])[..., None] * G \
            + (rt * before).transpose(2, 3) @ dot
    return (*(g.transpose(1, 2).to(r.dtype) for g in grads), du.to(u.dtype))
