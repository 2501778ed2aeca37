"""Launch of the CUDA row-stream matmul (``csrc/rowstream_matmul.cu``).

Replaces the Pallas TPU kernel ``rowstream_matmul``
(``src/repro/kernels/rowstream_matmul/kernel.py``). The CUDA source says
how the weight is tiled; this module picks the tiling for a shape and
launches it on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...serve.kv_cache import ROW_BYTES
from .. import DTYPE_CODES, build, sm_count

MAX_THREADS = 256      # threads per block; MAX_THREADS * 16 B = ROW_BYTES
BLOCKS_PER_SM = 2      # blocks of MAX_THREADS the registers allow per SM
MIN_ROWS = 32          # fewest weight rows a K split streams
assert MAX_THREADS * 16 == ROW_BYTES


@functools.cache
def _function():
    fn = build.load("rowstream_matmul").rowstream_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(m: int, k: int, n: int, itemsize: int, aligned: bool,
         sms: int) -> tuple[int, int, int, int, int]:
    """(vec, threads, mt, kchunk, splits) for an (m, k) @ (k, n) product.

    A thread loads `vec` columns (16 bytes) of a weight row when the rows
    start on 16-byte boundaries, else one. A block of `threads` threads
    covers the full N width or 4096 bytes of it. K is split until the grid
    holds about BLOCKS_PER_SM blocks per SM, each streaming at least
    MIN_ROWS rows."""
    vec = 16 // itemsize
    if not aligned or n % vec:
        vec = 1
    vectors = -(-n // vec)
    threads = min(MAX_THREADS, -(-vectors // 32) * 32)
    mt = next(t for t in (1, 2, 4, 8) if t >= min(m, 8))
    tiles = -(-n // (threads * vec)) * -(-m // mt)
    splits = max(1, min(-(-BLOCKS_PER_SM * sms // tiles), k // MIN_ROWS))
    kchunk = -(-k // splits)
    return vec, threads, mt, kchunk, -(-k // kchunk)


def rowstream_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors (see ``ops``)."""
    m, k = x.shape
    n = w.shape[1]
    itemsize = w.element_size()
    aligned = w.data_ptr() % 16 == 0 and (n * itemsize) % 16 == 0
    vec, threads, mt, kchunk, splits = plan(
        m, k, n, itemsize, aligned, sm_count(x.device.index or 0))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    err = _function()(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        m, k, n, DTYPE_CODES[x.dtype], vec, threads, mt, kchunk, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rowstream_matmul launch failed: CUDA error "
                           f"{err} for x {tuple(x.shape)} @ w "
                           f"{tuple(w.shape)} {x.dtype}")
    return out
