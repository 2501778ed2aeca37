"""Launch of the CUDA RWKV6 scan (``csrc/rwkv_scan.cu``) and of its
backward (``csrc/rwkv_scan_bwd.cu``).

The forward replaces the Pallas TPU kernel ``rwkv_scan``
(``src/repro/kernels/rwkv_scan/kernel.py``); the backward computes the
gradient that the JAX package takes by autodiff of its jnp scan. The CUDA
sources say how each is split; this module plans the forward's launch (one
block per (b, h), the tiles a chunk is cut into, the block's shared
memory), moves the operands to the (b, H, s, 64) layout both kernels
stream (padding a smaller head dim to 64 with r = k = v = 0, w = 1 and
u = 0, and do = dS = 0 for the backward), launches them on PyTorch's
current stream, and copies the gradients back to (b, s, H, hd).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ...serve.kv_cache import ROW_BYTES
from .. import DTYPE_CODES, build

MAX_HEAD_DIM = 64      # csrc HD: the kernel's head dim; smaller ones padded
MAX_CHUNK = 64         # csrc MAX_CHUNK
MAX_HEADS = 65535      # b * H
TILE = 16              # csrc TILE: tokens per tile
BLK = 4                # csrc BLK: tokens per block of the tile's matrix A
STAGES = 3             # csrc STAGES: copies of whole tiles in flight
THREADS = 256          # csrc THREADS: four state and four prep warps
# csrc prep buffer, in floats: r_dec, k_dec, v, A (hi, lo pairs) in
# padded rows, and W.
PREP_FLOATS = TILE * (3 * (MAX_HEAD_DIM + 8) + (2 * TILE + 8)) + MAX_HEAD_DIM
O_FLOATS = TILE * (MAX_HEAD_DIM + 4)    # csrc o staging rows
# csrc prep scratch for A: 96 rows of MAX_HEAD_DIM + 4 floats.
SCRATCH_FLOATS = 96 * (MAX_HEAD_DIM + 4)
# One SM of an H100: shared memory, the most one block may take, and what
# the runtime reserves per block.
SM_SMEM = 233472
BLOCK_SMEM_MAX = 232448
SMEM_RESERVED = 1024
BWD_CHUNK = TILE       # csrc/rwkv_scan_bwd.cu: tokens per checkpoint


@dataclass(frozen=True)
class Plan:
    """One launch: `blocks` blocks (one per (b, h)) of THREADS threads,
    each walking `tiles` tiles of at most TILE tokens, with `smem` bytes of
    dynamic shared memory."""
    blocks: int
    tiles: int
    smem: int

    @property
    def blocks_per_sm(self) -> int:
        return SM_SMEM // (self.smem + SMEM_RESERVED)


def smem_bytes(itemsize: int) -> int:
    """csrc ``smem_bytes<T>``: the ring of STAGES tiles of r, k, v, w, two
    prep buffers, the o staging rows, the prep scratch, u and one mbarrier
    per stage."""
    return (STAGES * 4 * TILE * MAX_HEAD_DIM * itemsize
            + (2 * PREP_FLOATS + O_FLOATS + SCRATCH_FLOATS + MAX_HEAD_DIM) * 4
            + STAGES * 8)


def tile_bounds(s: int, chunk: int) -> list[tuple[int, int]]:
    """(start, length) of each tile the kernel walks, in order (csrc
    ``tile_at``): chunks of `chunk` tokens, each cut into tiles of TILE
    tokens and a ragged rest, so no tile straddles a chunk."""
    out = []
    for c0 in range(0, s, chunk):
        end = min(c0 + chunk, s)
        out += [(t0, min(TILE, end - t0)) for t0 in range(c0, end, TILE)]
    return out


def plan(b: int, H: int, s: int, chunk: int, itemsize: int) -> Plan:
    return Plan(blocks=b * H, tiles=len(tile_bounds(s, chunk)),
                smem=smem_bytes(itemsize))


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


def _heads_major(x: torch.Tensor, fill: float) -> torch.Tensor:
    """(b, s, H, hd) -> contiguous (b, H, s, 64); channels past hd hold
    `fill`."""
    b, s, H, hd = x.shape
    if hd == MAX_HEAD_DIM:
        return x.transpose(1, 2).contiguous()
    out = torch.full((b, H, s, MAX_HEAD_DIM), fill, dtype=x.dtype,
                     device=x.device)
    out[..., :hd] = x.transpose(1, 2)
    return out


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              chunk: int | None = None) -> tuple:
    """Launch the kernel on checked CUDA tensors (see ``ops``)."""
    return launch(_function(), r, k, v, w, u, chunk)


def launch(fn, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, chunk: int | None = None):
    """:func:`rwkv_scan` through the C entry point `fn` (the built
    library's, or a variant's with the same signature)."""
    b, s, H, hd = r.shape
    C = chunk if chunk is not None else default_chunk(hd)
    p = plan(b, H, s, C, r.element_size())
    rr, kk, vv = (_heads_major(x, 0.0) for x in (r, k, v))
    ww = _heads_major(w, 1.0)
    u32 = torch.zeros((H, MAX_HEAD_DIM), dtype=torch.float32,
                      device=r.device)
    u32[:, :hd] = u
    o = torch.empty((b, H, s, MAX_HEAD_DIM), dtype=r.dtype, device=r.device)
    s_final = torch.empty((b, H, MAX_HEAD_DIM, MAX_HEAD_DIM),
                          dtype=torch.float32, device=r.device)
    err = fn(
        rr.data_ptr(), kk.data_ptr(), vv.data_ptr(), ww.data_ptr(),
        u32.data_ptr(), o.data_ptr(), s_final.data_ptr(),
        b, H, s, C, DTYPE_CODES[r.dtype], p.smem,
        torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"rwkv_scan launch failed: CUDA error {err} for "
                           f"r {tuple(r.shape)} {r.dtype}, chunk {C}")
    if hd < MAX_HEAD_DIM:
        o = o[..., :hd]
        s_final = s_final[:, :, :hd, :hd].contiguous()
    return o.transpose(1, 2), s_final


@functools.cache
def _bwd_function():
    fn = build.load("rwkv_scan_bwd").rwkv_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bwd_scratch_floats(b: int, H: int, s: int) -> int:
    """Floats of the backward's checkpoint scratch: the (64, 64) fp32
    state before each tile of BWD_CHUNK tokens of each (b, h) but the
    first, whose state is zero."""
    return b * H * (-(-s // BWD_CHUNK) - 1) * MAX_HEAD_DIM * MAX_HEAD_DIM


def rwkv_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                  dS: torch.Tensor | None) -> tuple:
    """Launch the backward kernel on checked CUDA tensors (see ``ops``):
    r/k/v/w and do (b, s, H, hd) in one dtype, u (H, hd), dS (b, H, hd,
    hd) or None for zero. Returns (dr, dk, dv, dw) contiguous (b, s, H, hd)
    in r's dtype and du (H, hd) in u's dtype. du is summed over b from the
    kernel's per-(b, h) partials by ``sum(0)``, a fixed-order reduction,
    so two calls give identical bits."""
    return bwd_launch(_bwd_function(), r, k, v, w, u, do, dS)


def bwd_launch(fn, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
               dS: torch.Tensor | None) -> tuple:
    """:func:`rwkv_scan_bwd` through the C entry point `fn` (the built
    library's, or a variant's with the same signature)."""
    b, s, H, hd = r.shape
    rr, kk, vv, dd = (_heads_major(x, 0.0) for x in (r, k, v, do))
    ww = _heads_major(w, 1.0)
    u32 = torch.zeros((H, MAX_HEAD_DIM), dtype=torch.float32,
                      device=r.device)
    u32[:, :hd] = u
    dS32 = None
    if dS is not None:
        dS32 = torch.zeros((b, H, MAX_HEAD_DIM, MAX_HEAD_DIM),
                           dtype=torch.float32, device=r.device)
        dS32[:, :, :hd, :hd] = dS
    grads = torch.empty((4, b, H, s, MAX_HEAD_DIM), dtype=r.dtype,
                        device=r.device)
    du_part = torch.empty((b, H, MAX_HEAD_DIM), dtype=torch.float32,
                          device=r.device)
    ckpt = torch.empty((bwd_scratch_floats(b, H, s),), dtype=torch.float32,
                       device=r.device)
    dr, dk, dv, dw = grads.unbind(0)
    err = fn(
        rr.data_ptr(), kk.data_ptr(), vv.data_ptr(), ww.data_ptr(),
        u32.data_ptr(), dd.data_ptr(),
        dS32.data_ptr() if dS32 is not None else None,
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du_part.data_ptr(), ckpt.data_ptr(), b, H, s, DTYPE_CODES[r.dtype],
        torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"rwkv_scan_bwd launch failed: CUDA error {err} "
                           f"for r {tuple(r.shape)} {r.dtype}")
    back = grads[..., :hd].transpose(2, 3).contiguous()   # (4, b, s, H, hd)
    du = du_part.sum(0)[:, :hd].to(u.dtype)
    return (*back.unbind(0), du)
