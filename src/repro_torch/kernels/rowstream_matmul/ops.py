"""Public wrapper of the row-stream matmul: the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors."""
from __future__ import annotations

import torch

from .. import DTYPE_CODES, LaunchCounter
from . import kernel
from .ref import rowstream_matmul_ref

LAUNCHES = LaunchCounter("rowstream_matmul")


def rowstream_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (m, k) @ w: (k, n) -> (m, n), fp32 accumulation, cast to x's
    dtype. x and w are contiguous, on one device, both float32 or both
    bfloat16."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or 0 in x.shape or 0 in w.shape:
        raise ValueError(f"rowstream_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not multiply or are empty")
    if x.dtype != w.dtype or x.dtype not in DTYPE_CODES:
        raise TypeError(f"rowstream_matmul: dtypes {x.dtype}, {w.dtype}; "
                        f"both float32 or both bfloat16 are supported")
    if x.device != w.device:
        raise ValueError(f"rowstream_matmul: x on {x.device}, w on "
                         f"{w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rowstream_matmul: x and w must be contiguous")
    if x.device.type == "cpu":
        return rowstream_matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"rowstream_matmul: unsupported device {x.device}")
    out = kernel.rowstream_matmul(x, w)
    LAUNCHES.count += 1
    return out
