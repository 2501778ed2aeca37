"""Public wrappers of GQA flash decode: the CUDA kernel for CUDA tensors,
the plain PyTorch version for CPU tensors."""
from __future__ import annotations

import torch

from .. import LaunchCounter
from . import kernel
from .ref import NEG_INF, flash_decode_partial_ref, flash_decode_ref

LAUNCHES = LaunchCounter("flash_decode")
MAX_HEAD_DIM = 256
MAX_GROUP_WIDTH = 4096   # g * d: the queries and accumulator of a KV head
_DTYPE_PAIRS = {(torch.float32, torch.float32),
                (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16)}


def _check(name: str, q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor) -> None:
    """Raise on inputs the kernel does not take."""
    if q.dim() != 3 or k_cache.dim() != 4 \
            or k_cache.shape != v_cache.shape or 0 in k_cache.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    b, h, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d \
            or h % k_cache.shape[1]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match "
                         f"caches {tuple(k_cache.shape)}")
    if d > MAX_HEAD_DIM or (h // k_cache.shape[1]) * d > MAX_GROUP_WIDTH:
        raise ValueError(f"{name}: head dim {d} with "
                         f"{h // k_cache.shape[1]} heads per KV head is "
                         f"beyond d <= {MAX_HEAD_DIM}, g * d <= "
                         f"{MAX_GROUP_WIDTH}")
    if (q.dtype, k_cache.dtype) not in _DTYPE_PAIRS \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"{name}: q {q.dtype} against caches "
                        f"{k_cache.dtype} / {v_cache.dtype} is not supported")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError(f"{name}: q and caches on different devices")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError(f"{name}: q and caches must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Single-token GQA attention. q: (b, h, d); caches: (b, h_kv, S, d),
    h a multiple of h_kv; pos: the new token's position, a host int >= 0.
    Slots after ``pos`` are masked; with pos >= S every slot is valid (a
    ring buffer). Returns (b, h, d) in q's dtype."""
    _check("flash_decode", q, k_cache, v_cache)
    if not isinstance(pos, int) or pos < 0:
        raise ValueError(f"flash_decode: pos must be an int >= 0, got "
                         f"{pos!r}")
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, pos)
    out = kernel.flash_decode(q, k_cache, v_cache, pos)
    LAUNCHES.count += 1
    return out


def flash_decode_partial(q: torch.Tensor, k_local: torch.Tensor,
                         v_local: torch.Tensor, n_valid: int) -> tuple:
    """Attention of q (b, h, d) over the first ``n_valid`` slots of one
    shard (b, h_kv, S_loc, d) of a sequence-split cache, 0 <= n_valid <=
    S_loc, with the softmax statistics that merge it with the other
    shards' (``ref.merge_partials``). Returns (out (b, h, d) in q's dtype,
    m (b, h) fp32, l (b, h) fp32) as ``ref.flash_decode_partial_ref``. A
    shard with no valid slot launches nothing: out 0, m -1e30, l 0."""
    _check("flash_decode_partial", q, k_local, v_local)
    if not isinstance(n_valid, int) or not 0 <= n_valid <= k_local.shape[2]:
        raise ValueError(f"flash_decode_partial: n_valid must be an int in "
                         f"0..{k_local.shape[2]}, got {n_valid!r}")
    if q.device.type == "cpu":
        return flash_decode_partial_ref(q, k_local, v_local, n_valid)
    if n_valid == 0:
        b, h, _ = q.shape
        return (torch.zeros_like(q),
                torch.full((b, h), NEG_INF, device=q.device),
                torch.zeros((b, h), device=q.device))
    out = kernel.flash_decode_partial(q, k_local, v_local, n_valid)
    LAUNCHES.count += 1
    return out
