"""Launch of the CUDA flash-decode kernel (``csrc/flash_decode.cu``).

Replaces the Pallas TPU kernel ``flash_decode``
(``src/repro/kernels/flash_decode/kernel.py``). The CUDA source says how the
cache is split; this module picks the chunk length for a shape and launches
it on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ...serve.kv_cache import ROW_BYTES
from .. import DTYPE_CODES, build, sm_count

TILE = 32              # tokens a block stages at a time (csrc TILE)
BLOCKS_PER_SM = 2      # split blocks wanted per SM
MAX_ROW_TOKENS = 256   # longest chunk granule kept for the row contract


@functools.cache
def _function():
    fn = build.load("flash_decode").flash_decode
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pick_chunk(n_valid: int, pairs: int, d: int, itemsize: int,
               sms: int) -> int:
    """Tokens per split of the valid cache prefix.

    Enough splits that the ``pairs`` (batch, KV head) pairs give about
    BLOCKS_PER_SM blocks per SM, at least one tile each, and a multiple of
    the tokens that fill whole 4 KB rows of one head's K, so every chunk
    starts on a row. Head dims whose rows take more than MAX_ROW_TOKENS
    tokens to fill use the tile as the granule instead."""
    row_tokens = ROW_BYTES // math.gcd(d * itemsize, ROW_BYTES)
    granule = row_tokens if row_tokens <= MAX_ROW_TOKENS else TILE
    splits = -(-BLOCKS_PER_SM * sms // pairs)
    chunk = max(TILE, -(-n_valid // splits))
    return -(-chunk // granule) * granule


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors (see ``ops``)."""
    b, h, d = q.shape
    hkv, S = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    n_valid = min(pos + 1, S)
    chunk = pick_chunk(n_valid, b * hkv, d, k_cache.element_size(),
                       sm_count(q.device.index or 0))
    nsplit = -(-n_valid // chunk)
    out = torch.empty_like(q)
    ws_m, ws_l = (torch.empty((b, hkv, nsplit, g), dtype=torch.float32,
                              device=q.device) for _ in range(2))
    ws_acc = torch.empty((b, hkv, nsplit, g, d), dtype=torch.float32,
                         device=q.device)
    err = _function()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        ws_m.data_ptr(), ws_l.data_ptr(), ws_acc.data_ptr(),
        b, hkv, g, S, d, n_valid, chunk, nsplit, 1.0 / math.sqrt(d),
        DTYPE_CODES[q.dtype], DTYPE_CODES[k_cache.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err} "
                           f"for q {tuple(q.shape)} {q.dtype}, cache "
                           f"{tuple(k_cache.shape)} {k_cache.dtype}")
    return out
