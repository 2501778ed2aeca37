"""Public wrapper of the RWKV6 time-mix scan: the CUDA kernels for CUDA
tensors, the plain PyTorch versions for CPU tensors, forward and
backward."""
from __future__ import annotations

import torch

from .. import DTYPE_CODES, LaunchCounter
from . import kernel
from .ref import rwkv_scan_bwd_ref, rwkv_scan_ref

LAUNCHES = LaunchCounter("rwkv_scan")
BWD_LAUNCHES = LaunchCounter("rwkv_scan_bwd")


class _RwkvScan(torch.autograd.Function):
    """The scan with its gradient: forward through ``csrc/rwkv_scan.cu``
    and backward through ``csrc/rwkv_scan_bwd.cu`` on CUDA tensors, through
    ``rwkv_scan_ref`` and ``rwkv_scan_bwd_ref`` on CPU tensors."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        if r.device.type == "cpu":
            return rwkv_scan_ref(r, k, v, w, u)
        out = kernel.rwkv_scan(r, k, v, w, u, chunk)
        LAUNCHES.count += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, dS):
        r, k, v, w, u = ctx.saved_tensors
        do = torch.zeros_like(r) if do is None else do.to(r.dtype)
        if r.device.type == "cpu":
            grads = rwkv_scan_bwd_ref(r, k, v, w, u, do, dS)
        else:
            grads = kernel.rwkv_scan_bwd(r, k, v, w, u, do, dS)
            BWD_LAUNCHES.count += 1
        return (*grads, None)


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              chunk: int | None = None) -> tuple:
    """The RWKV6 recurrence from a zero state. r/k/v/w: (b, s, H, hd),
    one dtype (float32 or bfloat16), w the per-channel decay in (0, 1);
    u: (H, hd), float32 or r's dtype; all contiguous, on one device,
    hd <= 64. ``chunk`` (1..64) sets the kernel's tokens per chunk;
    the result does not depend on it. Returns (o (b, s, H, hd) in r's
    dtype, final state (b, H, hd, hd) float32).

    Differentiable in r, k, v, w and u, with a gradient for both results
    (a missing one counts as zero): on CUDA tensors the backward kernel
    ``rwkv_scan_bwd`` computes it (counted in BWD_LAUNCHES), on CPU
    tensors ``rwkv_scan_bwd_ref``."""
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape) \
            or 0 in r.shape:
        raise ValueError(f"rwkv_scan: r/k/v/w shapes {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}: four equal non-empty "
                         f"(b, s, H, hd)")
    b, s, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"rwkv_scan: u {tuple(u.shape)}, expected "
                         f"{(H, hd)}")
    if hd > kernel.MAX_HEAD_DIM or b * H > kernel.MAX_HEADS:
        raise ValueError(f"rwkv_scan: head dim {hd} and b * H {b * H} must "
                         f"be at most {kernel.MAX_HEAD_DIM} and "
                         f"{kernel.MAX_HEADS}")
    if chunk is not None and not 1 <= chunk <= kernel.MAX_CHUNK:
        raise ValueError(f"rwkv_scan: chunk {chunk} outside 1.."
                         f"{kernel.MAX_CHUNK}")
    if not (r.dtype == k.dtype == v.dtype == w.dtype) \
            or r.dtype not in DTYPE_CODES \
            or u.dtype not in (torch.float32, r.dtype):
        raise TypeError(f"rwkv_scan: dtypes r/k/v/w {r.dtype}, {k.dtype}, "
                        f"{v.dtype}, {w.dtype}, u {u.dtype}; r/k/v/w all "
                        f"float32 or all bfloat16, u float32 or theirs")
    if not (r.device == k.device == v.device == w.device == u.device):
        raise ValueError("rwkv_scan: inputs on different devices")
    if not all(x.is_contiguous() for x in (r, k, v, w, u)):
        raise ValueError("rwkv_scan: inputs must be contiguous")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rwkv_scan: unsupported device {r.device}")
    return _RwkvScan.apply(r, k, v, w, u, chunk)
