"""Int8 gradient compression with error feedback: the counterpart of
``repro.train.grad_compress``.

Per-tensor symmetric quantization: q = round(g / s) with s = max|g| / 127
(+ 1e-12). The quantization residual is carried in an error-feedback
buffer and added back before the next compression, so the scheme is
unbiased over time (Seide et al. / EF-SGD). ``torch.round``, like
``jnp.round``, rounds half to even. No driver uses it yet, in either
package: it is meant for the slow cross-pod reduce of the distributed
slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .optimizer import _leaves, _unflatten, tree_map


class ErrorFeedback(NamedTuple):
    buf: dict      # residual tree (fp32), like grads


def ef_init(grads_like: dict) -> ErrorFeedback:
    return ErrorFeedback(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, fp32 scale). Scale is per-tensor."""
    g32 = g.float()
    s = torch.max(torch.abs(g32)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g32 / s), -127, 127).to(torch.int8)
    return q, s


def decompress_int8(q: torch.Tensor, s: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * s).to(dtype)


def compress_tree(grads: dict, ef: ErrorFeedback) -> tuple:
    """Quantize grads + residual; returns ((q, s) trees, new
    ErrorFeedback). The residuals are matched to the grads by key path."""
    qs, ss, rs = [], [], []
    err = dict(_leaves(ef.buf))
    for path, g in _leaves(grads):
        corrected = g.float() + err[path]
        q, s = compress_int8(corrected)
        qs.append(q)
        ss.append(s)
        rs.append(corrected - decompress_int8(q, s))
    return (_unflatten(grads, qs), _unflatten(grads, ss)), \
        ErrorFeedback(_unflatten(grads, rs))


def decompress_tree(qs: dict, scales: dict, dtype=torch.float32) -> dict:
    s = dict(_leaves(scales))
    return _unflatten(qs, [decompress_int8(q, s[path], dtype)
                           for path, q in _leaves(qs)])
