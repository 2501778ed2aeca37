"""Launch of the CUDA RWKV6 scan (``csrc/rwkv_scan.cu``).

Replaces the Pallas TPU kernel ``rwkv_scan``
(``src/repro/kernels/rwkv_scan/kernel.py``). The CUDA source says how the
scan is split; this module picks the chunk length, moves the operands to
the (b, H, s, hd) layout the kernel streams, and launches it on PyTorch's
current stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...serve.kv_cache import ROW_BYTES
from .. import DTYPE_CODES, build

MAX_HEAD_DIM = 64      # csrc MAX_HD
MAX_CHUNK = 64         # csrc MAX_CHUNK
MAX_HEADS = 65535      # b * H: the grid's y dimension


@functools.cache
def _function():
    fn = build.load("rwkv_scan").rwkv_scan
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _row_chunk(hd: int, itemsize: int) -> int:
    """Tokens whose operand chunk (C x hd x itemsize) fills whole DRAM
    rows: the first step of :func:`pick_chunk`."""
    c = max(8, ROW_BYTES // (hd * itemsize))
    while (c * hd * itemsize) % ROW_BYTES and c > 8:
        c -= 8
    return c


def pick_chunk(s: int, hd: int, itemsize: int = 4) -> int:
    """Chunk length: whole DRAM rows per operand chunk and divides s (a
    copy of ``repro.kernels.rwkv_scan.kernel.pick_chunk``)."""
    c = _row_chunk(hd, itemsize)
    while s % c and c > 1:
        c //= 2
    return max(1, c)


def default_chunk(hd: int) -> int:
    """The kernel's chunk when none is given: the row-sized length of
    :func:`pick_chunk` without its divisor step (the kernel masks a ragged
    last chunk, so an odd s keeps whole-row chunks), at most MAX_CHUNK."""
    return min(MAX_CHUNK, _row_chunk(hd, 4))


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              chunk: int | None = None) -> tuple:
    """Launch the kernel on checked CUDA tensors (see ``ops``)."""
    b, s, H, hd = r.shape
    C = chunk if chunk is not None else default_chunk(hd)
    rr, kk, vv, ww = (x.transpose(1, 2).contiguous() for x in (r, k, v, w))
    u32 = u.float().contiguous()
    o = torch.empty((b, H, s, hd), dtype=r.dtype, device=r.device)
    s_final = torch.empty((b, H, hd, hd), dtype=torch.float32,
                          device=r.device)
    err = _function()(
        rr.data_ptr(), kk.data_ptr(), vv.data_ptr(), ww.data_ptr(),
        u32.data_ptr(), o.data_ptr(), s_final.data_ptr(),
        b, H, s, hd, C, DTYPE_CODES[r.dtype],
        torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"rwkv_scan launch failed: CUDA error {err} for "
                           f"r {tuple(r.shape)} {r.dtype}, chunk {C}")
    return o.transpose(1, 2), s_final
