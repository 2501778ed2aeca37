"""Launch of the CUDA row-stream matmul (``csrc/rowstream_matmul.cu``).

Replaces the Pallas TPU kernel ``rowstream_matmul``
(``src/repro/kernels/rowstream_matmul/kernel.py``). The CUDA source says how
a block streams its share of the weight and how the K split is summed; this
module plans the grid for a shape (cached per shape, dtype, alignment and
device) and launches the kernel on PyTorch's current stream.

The plan cuts the weight into column tiles and each tile's K rows into
splits, one block each:
* A tile is 4096 bytes of every row where a row is wider (the last tile
  takes the rest), or the full row width, in which case a split's rows are
  a whole number of 4 KB rows where the row width divides 4096.
* The splits of a tile form clusters of up to 8 blocks that add their sums
  on chip. Where a tile has several clusters, each leaves its sum in an
  fp32 workspace that the last cluster to finish adds up; the workspace is
  at most 1/WS_SHARE of the weight's bytes.
* Every block holds about the same weight bytes (a narrower last tile takes
  proportionally more rows), and the grid fits in one wave of the card, no
  more clusters than it holds at once: at two blocks per SM with a block on
  every SM, or, for products under SMALL_BYTES, at one block per SM with a
  block on half the SMs (such products are latency more than bytes).
* A product too small for that many blocks of whole 4 KB rows (rwkv6's
  w_lora_b, 80 rows of 4 KB) takes narrower column tiles.

A call allocates its output only. The workspace and the arrival counters
are allocated once per device, grown when a plan needs more, and reused,
so calls that need them must share one stream (as the port's calls do).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ...serve.kv_cache import ROW_BYTES
from .. import DTYPE_CODES, build, sm_count

THREADS = 256          # threads per block (csrc THREADS)
STAGE_BYTES = 16384    # bytes of w per ring stage: four 4 KB rows
STAGES = 2             # ring stages (csrc STAGES)
MAX_CLUSTER = 8        # blocks of a cluster (the portable size)
X_BYTES = 16384        # most shared memory a block's slice of x may take
WS_SHARE = 16          # workspace bytes <= weight bytes / WS_SHARE
BLOCKS_PER_SM = 2      # __launch_bounds__(THREADS, BLOCKS_PER_SM)
SMEM_PER_BLOCK = 227 * 1024
ONE_PER_SM_SMEM = 160 * 1024   # leaves room for one block per SM only
# Below this many weight bytes a product is latency (its blocks' cluster
# and workspace sums) more than bytes in flight: its grid fits the card at
# one block per SM, so no two of its blocks share an SM, and it needs a
# block on half the SMs only. Above, the grid fits at BLOCKS_PER_SM and
# gives every SM a block. On an H100 80GB HBM3 at 700 W, 4 slots, bf16:
# 2560 x 2560 took 13.6 us at 120 blocks (one per SM) and 14.8 us at 136
# or 200; 3584 x 512 8.6-8.8 us at 56-112 blocks and 9.9 at 224; 3584 x
# 18944 took 59 us at 224 blocks and 64 us at 112.
SMALL_BYTES = 32 << 20
assert THREADS * 16 == ROW_BYTES and STAGE_BYTES % ROW_BYTES == 0


@dataclass(frozen=True)
class Plan:
    """Grid of one (m, k) @ (k, n) product. Blocks are (rank in cluster,
    cluster, tile of mt rows of x); clusters run over the full tiles
    (``groups`` each) and then the last, narrower tile (``groups_r``)."""
    m: int
    k: int
    n: int
    itemsize: int
    vec: int        # columns per 16-byte chunk; 1: the scalar kernel
    mt: int         # rows of x per block (1, 2, 4 or 8)
    cluster: int    # blocks per cluster: consecutive K splits of a tile
    tiles: int      # full column tiles
    cols: int       # columns of a full tile
    groups: int     # clusters per full tile
    cols_r: int = 0     # columns of the narrower last tile (0: none)
    groups_r: int = 0   # clusters of the last tile
    granule: int = 1    # rows per split unit: splits start on its multiples

    @property
    def mtiles(self) -> int:
        return -(-self.m // self.mt)

    @property
    def classes(self) -> list[tuple[int, int, int]]:
        """(tiles, columns, clusters per tile) of the full tiles and of
        the last tile."""
        out = [(self.tiles, self.cols, self.groups)]
        if self.cols_r:
            out.append((1, self.cols_r, self.groups_r))
        return out

    @property
    def clusters(self) -> int:
        return self.mtiles * sum(t * g for t, _, g in self.classes)

    @property
    def blocks(self) -> int:
        return self.clusters * self.cluster

    @property
    def units(self) -> int:
        return -(-self.k // self.granule)

    def k_ranges(self, groups: int) -> list[tuple[int, int]]:
        """[kb, ke) of each of the groups * cluster splits of a tile, as the
        kernel computes them: whole units, as even as they divide."""
        s_all, u, g = groups * self.cluster, self.units, self.granule
        return [(min(self.k, s * u // s_all * g),
                 min(self.k, (s + 1) * u // s_all * g))
                for s in range(s_all)]

    def rows_max(self) -> int:
        """Most K rows a block streams."""
        s_min = self.cluster * min(g for _, _, g in self.classes)
        return min(self.k, -(-self.units // s_min) * self.granule)

    def block_bytes(self) -> list[int]:
        """Weight bytes of every block of one tile of x, all tiles."""
        return [(ke - kb) * c * self.itemsize
                for t, c, g in self.classes for _ in range(t)
                for kb, ke in self.k_ranges(g)]

    @property
    def run_bytes(self) -> int:
        """Contiguous bytes of w in a streamed run: a row segment of a full
        tile, or a split unit of full-width rows."""
        return self.granule * self.cols * self.itemsize

    @property
    def ws_floats(self) -> int:
        """fp32 workspace: (tile of x, cluster, mt rows, n) where a tile has
        several clusters, else none."""
        return (self.mtiles * self.groups * self.mt * self.n
                if self.groups > 1 else 0)

    @property
    def counters(self) -> int:
        """Arrival counters: (tile of x, tiles + 1, cluster) where a tile
        has several clusters, else none."""
        return (self.mtiles * (self.tiles + 1) * self.cluster
                if self.groups > 1 else 0)

    @property
    def smem(self) -> int:
        """Dynamic shared memory of a block, as the kernel lays it out: the
        ring, the cluster sum's receive region, x's slice (csrc
        `smem_bytes`)."""
        if self.vec == 1:
            return 0
        return smem_bytes(self.cluster, self.cols // self.vec, self.vec,
                          self.mt, self.rows_max() * self.mt * self.itemsize)


def smem_bytes(cluster: int, cpr: int, vec: int, mt: int, x_bytes: int
               ) -> int:
    cs = -(-cpr // cluster)
    region0 = max(STAGES * STAGE_BYTES, THREADS * mt * vec * 4)
    return region0 + cluster * cs * vec * mt * 4 + -(-x_bytes // 16) * 16


def m_tile(m: int) -> int:
    return next(t for t in (1, 2, 4, 8) if t >= min(m, 8))


def uniform_slots(sms: int, per_sm: int = BLOCKS_PER_SM
                  ) -> tuple[int, ...]:
    """Clusters of 1..MAX_CLUSTER blocks a card of `sms` SMs holds at once
    at `per_sm` blocks per SM, were clusters placed freely (a card places a
    cluster's blocks within one GPC, so it may hold fewer:
    :func:`cluster_slots` asks it)."""
    return tuple(sms * per_sm // c for c in range(1, MAX_CLUSTER + 1))


def _layouts(n: int, itemsize: int):
    """(cols, tiles, cols_r, granule) to try, best first: runs of whole
    4 KB rows, then ever narrower runs."""
    row = n * itemsize
    seen = set()
    width = ROW_BYTES
    while width >= 16:
        if row > width:
            cols = width // itemsize
            layout = (cols, n // cols, n % cols, 1)
        else:
            layout = (n, 1, 0, max(1, width // row))
        if layout not in seen:
            seen.add(layout)
            yield layout
        width //= 2


def _best_for(m, k, n, itemsize, vec, mt, layout, cluster, gmax, slots
              ) -> Plan | None:
    """The plan of this layout and cluster size with the most clusters per
    tile that fit one wave, the workspace bound and x's shared memory, or
    None."""
    cols, tiles, cols_r, granule = layout
    hi = min(gmax, -(-k // granule) // cluster)
    for g in range(hi, 0, -1):
        g_r = -(-g * cols_r // cols) if cols_r else 0
        p = Plan(m, k, n, itemsize, vec, mt, cluster, tiles, cols, g, cols_r,
                 g_r, granule)
        if p.clusters > slots[cluster - 1]:
            continue
        if p.rows_max() * mt * itemsize > X_BYTES \
                or p.smem > SMEM_PER_BLOCK:
            return None    # fewer clusters only lengthen the rows
        return p
    return None


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, itemsize: int, aligned: bool, sms: int,
         slots: tuple[int, ...] | None = None,
         slots1: tuple[int, ...] | None = None) -> Plan:
    """The grid of an (m, k) @ (k, n) product on a card of `sms` SMs that
    holds slots[c - 1] clusters of c blocks at once, and slots1[c - 1] at
    one block per SM (default :func:`uniform_slots`). Below SMALL_BYTES
    the grid fits slots1 and needs blocks on half the SMs, else it fits
    slots and needs a block on every SM.

    Where a row of w is not a whole number of 16-byte chunks, or w is not
    16-byte aligned, the scalar kernel runs (one thread per column).
    Otherwise the layouts of :func:`_layouts` are tried in order and, for
    each, cluster sizes from the largest down (:func:`_best_for`); the
    first plan with a block for every SM is taken, else the one with the
    most blocks. Larger clusters come first because they sum more of the
    split on chip: fewer clusters per tile leave less in the workspace for
    the last cluster to add.
    Where no plan fits one wave (x's slice would outgrow X_BYTES: fp32
    heads), the fewest whole waves that fit one are used."""
    mt = m_tile(m)
    if not aligned or (n * itemsize) % 16:
        return Plan(m, k, n, itemsize, 1, mt, 1, -(-n // THREADS), THREADS,
                    1)
    if k * n * itemsize < SMALL_BYTES:
        slots, sms = slots1 or uniform_slots(sms, 1), -(-sms // 2)
    else:
        slots = slots or uniform_slots(sms)
    vec = 16 // itemsize
    # ws = groups * mt * mtiles * n * 4 bytes <= k * n * itemsize / WS_SHARE
    gmax = max(1, k * itemsize // (4 * WS_SHARE * mt * -(-m // mt)))
    for waves in range(1, 65):
        p = _plan_in(m, k, n, itemsize, vec, mt, gmax, sms,
                     tuple(s * waves for s in slots))
        if p is not None:
            return p
    raise ValueError(f"rowstream_matmul: no plan for ({m}, {k}) @ ({k}, "
                     f"{n}), itemsize {itemsize}")


def _plan_in(m, k, n, itemsize, vec, mt, gmax, sms, slots) -> Plan | None:
    fallback = None
    for layout in _layouts(n, itemsize):
        for cluster in range(MAX_CLUSTER, 0, -1):
            p = _best_for(m, k, n, itemsize, vec, mt, layout, cluster, gmax,
                          slots)
            if p is None:
                continue
            if p.blocks >= sms:
                return p
            if fallback is None or p.blocks > fallback.blocks:
                fallback = p
    return fallback


@functools.cache
def _library():
    lib = build.load("rowstream_matmul")
    fn = lib.rowstream_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    probe = lib.rowstream_max_clusters
    probe.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    probe.restype = ctypes.c_int
    return lib


def _function():
    return _library().rowstream_matmul


@functools.cache
def cluster_slots(index: int, dtype_code: int, mt: int, per_sm: int = 2
                  ) -> tuple[int, ...]:
    """Clusters of 1..MAX_CLUSTER blocks device `index` holds at once
    (cudaOccupancyMaxActiveClusters): at the most shared memory a plan
    gives a block of this dtype and mt, or, for `per_sm` 1, at
    ONE_PER_SM_SMEM, more than half an SM's shared memory."""
    itemsize = 4 if dtype_code == 0 else 2
    vec = 16 // itemsize
    out = []
    with torch.cuda.device(index):
        for c in range(1, MAX_CLUSTER + 1):
            smem = (smem_bytes(c, ROW_BYTES // 16, vec, mt, X_BYTES)
                    if per_sm > 1 else ONE_PER_SM_SMEM)
            count = ctypes.c_int(0)
            err = _library().rowstream_max_clusters(dtype_code, mt, c, smem,
                                                    ctypes.byref(count))
            if err:
                raise RuntimeError(f"rowstream_matmul: occupancy query "
                                   f"failed with CUDA error {err}")
            out.append(count.value)
    return tuple(out)


_SCRATCH: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def scratch(device: torch.device, ws_floats: int, counters: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's fp32 workspace and int32 arrival counters, at least
    this large: allocated at the first call that needs more, then reused.
    New counters are zero; the kernel leaves them zero."""
    index = device.index
    ws, cnt = _SCRATCH.get(index, (None, None))
    if ws is None or ws.numel() < ws_floats:
        ws = torch.empty(ws_floats, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(counters, dtype=torch.int32, device=device)
    _SCRATCH[index] = (ws, cnt)
    return ws, cnt


def plan_for(x: torch.Tensor, w: torch.Tensor) -> Plan:
    """The plan of ``x @ w`` on x's device."""
    m, k = x.shape
    n = w.shape[1]
    itemsize = w.element_size()
    aligned = w.data_ptr() % 16 == 0 and (n * itemsize) % 16 == 0
    index = x.device.index
    code, mt = DTYPE_CODES[x.dtype], m_tile(m)
    return plan(m, k, n, itemsize, aligned, sm_count(index),
                cluster_slots(index, code, mt),
                cluster_slots(index, code, mt, 1))


def rowstream_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors (see ``ops``)."""
    return launch(_function(), x, w)


def launch(function, x: torch.Tensor, w: torch.Tensor,
           p: Plan | None = None) -> torch.Tensor:
    """Launch ``function``, the C entry point of a build of
    ``csrc/rowstream_matmul.cu``, as :func:`rowstream_matmul` does, with
    plan `p` where it is given."""
    p = p or plan_for(x, w)
    out = torch.empty((p.m, p.n), dtype=x.dtype, device=x.device)
    ws = cnt = None
    if p.groups > 1:
        ws, cnt = scratch(x.device, p.ws_floats, p.counters)
    err = function(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        cnt.data_ptr() if cnt is not None else None,
        p.m, p.k, p.n, DTYPE_CODES[x.dtype], p.vec, p.mt, p.cluster,
        p.tiles, p.cols, p.groups, p.cols_r, p.groups_r, p.granule,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rowstream_matmul launch failed: CUDA error "
                           f"{err} for x {tuple(x.shape)} @ w "
                           f"{tuple(w.shape)} {x.dtype}")
    return out
