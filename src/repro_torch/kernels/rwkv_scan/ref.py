"""Plain PyTorch version of the RWKV6 time-mix scan: the sequential
recurrence, one token at a time, in fp32.

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
