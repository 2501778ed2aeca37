"""Launch of the CUDA flash-decode kernel (``csrc/flash_decode.cu``).

Replaces the Pallas TPU kernel ``flash_decode``
(``src/repro/kernels/flash_decode/kernel.py``). The CUDA source says how a
pair's valid prefix is split over the blocks of one thread-block cluster;
this module plans the split for a shape (cached) and launches the kernel on
PyTorch's current stream, allocating only the output (and, for the partial
entry over one shard of a sequence-split cache, the softmax statistics).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ...serve.kv_cache import ROW_BYTES
from .. import DTYPE_CODES, build, sm_count

MAX_SPLITS = 8         # blocks of a pair: one cluster of the portable size
MAX_HEADS = 8          # query heads per block (csrc MAX_HG)
MAX_ROW_TOKENS = 256   # longest chunk granule kept for the row contract
GRANULE = 16           # chunk granule where a row takes more tokens
MIN_CHUNK = 32         # tokens: the fastest at 128 slots on an H100 80GB
                       # HBM3 at 700 W (scripts/flash_decode_latency.py)


@functools.cache
def _function():
    fn = build.load("flash_decode").flash_decode
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def valid_tokens(pos: int, S: int) -> int:
    """Slots attended to: 0..pos, or all S of a full ring buffer."""
    return min(pos + 1, S)


def head_groups(g: int) -> int:
    """Blocks per (batch, KV head) pair and chunk: the g query heads in
    groups of at most MAX_HEADS."""
    return -(-g // MAX_HEADS)


@functools.lru_cache(maxsize=4096)
def plan(n_valid: int, clusters: int, d: int, itemsize: int, sms: int,
         min_chunk: int = MIN_CHUNK) -> tuple[int, int]:
    """(chunk, nsplit): tokens per block and blocks per cluster for
    ``clusters`` (pair, head group) clusters over ``n_valid`` tokens.

    nsplit is about one wave of ``sms`` blocks over the clusters, at most
    MAX_SPLITS, and no chunk is shorter than ``min_chunk``: each block has
    a fixed cost (its first tile's latency, the merges, the cluster
    barrier), so short prefixes take fewer, longer chunks. The chunk is a
    multiple of the tokens that fill whole 4 KB rows of one head's K, so
    every chunk but the last starts on a row; head dims whose rows take
    more than MAX_ROW_TOKENS tokens to fill use GRANULE instead. Chunks past the valid prefix are
    not launched."""
    row_tokens = ROW_BYTES // math.gcd(d * itemsize, ROW_BYTES)
    granule = row_tokens if row_tokens <= MAX_ROW_TOKENS else GRANULE
    want = max(1, min(MAX_SPLITS, sms // clusters))
    chunk = max(min_chunk, -(-n_valid // want))
    chunk = -(-chunk // granule) * granule
    return chunk, -(-n_valid // chunk)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors (see ``ops``)."""
    return launch(_function(), q, k_cache, v_cache, pos)


def flash_decode_partial(q: torch.Tensor, k_local: torch.Tensor,
                         v_local: torch.Tensor, n_valid: int) -> tuple:
    """Launch the kernel over the first ``n_valid`` >= 1 slots of a cache
    shard (checked CUDA tensors, see ``ops``); returns (out, m, l)."""
    b, h, _ = q.shape
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    out = _launch(_function(), q, k_local, v_local, n_valid, MIN_CHUNK, m, l)
    return out, m, l


def launch(function, q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor, pos: int,
           min_chunk: int = MIN_CHUNK) -> torch.Tensor:
    """Launch ``function``, the C entry point of a build of
    ``csrc/flash_decode.cu``, as :func:`flash_decode` does."""
    return _launch(function, q, k_cache, v_cache,
                   valid_tokens(pos, k_cache.shape[2]), min_chunk)


def _launch(function, q: torch.Tensor, k_cache: torch.Tensor,
            v_cache: torch.Tensor, n_valid: int, min_chunk: int,
            m: torch.Tensor | None = None,
            l: torch.Tensor | None = None) -> torch.Tensor:
    """One launch over the first `n_valid` slots; the statistics go to `m`
    and `l` (b, h) fp32 where they are given."""
    b, h, d = q.shape
    hkv, S = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    chunk, nsplit = plan(n_valid, b * hkv * head_groups(g), d,
                         k_cache.element_size(),
                         sm_count(q.device.index or 0), min_chunk)
    vec = d % 8 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (q, k_cache, v_cache))
    out = torch.empty_like(q)
    err = function(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(),
        b, hkv, g, S, d, n_valid, chunk, nsplit, int(vec),
        1.0 / math.sqrt(d), DTYPE_CODES[q.dtype], DTYPE_CODES[k_cache.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err} "
                           f"for q {tuple(q.shape)} {q.dtype}, cache "
                           f"{tuple(k_cache.shape)} {k_cache.dtype}")
    return out
