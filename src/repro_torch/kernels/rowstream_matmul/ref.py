"""Plain PyTorch version of the row-stream matmul."""
from __future__ import annotations

import torch


def rowstream_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (m, k) @ w: (k, n) -> (m, n) accumulated in fp32, cast to x's
    dtype (``repro.kernels.rowstream_matmul.ref``)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)
