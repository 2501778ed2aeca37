"""Row-paged KV cache: pages are whole 4 KB DRAM rows.

The PyTorch counterpart of ``repro.serve.kv_cache``. The serving system
allocates KV storage in pages whose byte size is an exact multiple of the
4 KB DRAM row, so every KV read a decode kernel issues is a whole-row
stream and every append fills rows sequentially: the software side of the
RoMe contract, which the port's kernels also tile by (``ROW_BYTES``).

The host-side bookkeeping (page table, sequence lengths, the free list and
its order) and the memory-system records (:class:`ExtentStream`) are the
reference's, record for record. The two pools are torch tensors on
``device`` (``cuda`` unless the caller asks for the CPU): ``write`` stores
one token in place, ``gather_seq`` gathers a sequence's pages with one
index operation per pool.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..workloads.stream import ExtentRecord, ExtentStream

ROW_BYTES = 4096

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tokens_per_row(head_dim: int, n_kv_heads: int, itemsize: int = 2,
                   rows_per_page: int = 1) -> int:
    """Tokens that fill exactly `rows_per_page` DRAM rows of K (or V) for
    one layer: tokens * n_kv_heads * head_dim * itemsize == rows * 4096.
    Raises if no integral packing exists (pick rows_per_page accordingly).
    """
    page_bytes = rows_per_page * ROW_BYTES
    per_tok = n_kv_heads * head_dim * itemsize
    if page_bytes % per_tok:
        raise ValueError(
            f"page of {page_bytes} B not an integral number of "
            f"{per_tok} B tokens; use rows_per_page divisible by "
            f"{per_tok // np.gcd(per_tok, ROW_BYTES)}")
    return page_bytes // per_tok


@dataclass
class RowPagedKVCache:
    """Paged KV storage for one layer group.

    pool_k/pool_v: (n_pages, page_tokens, n_kv_heads, head_dim) on device
    page_table:    (max_seqs, max_pages) int32, -1 = unmapped
    seq_lens:      (max_seqs,) int32
    """

    n_pages: int
    page_tokens: int
    n_kv_heads: int
    head_dim: int
    max_seqs: int
    max_pages_per_seq: int
    dtype: str = "bfloat16"
    device: str | torch.device = "cuda"

    pool_k: torch.Tensor = field(init=False)
    pool_v: torch.Tensor = field(init=False)
    page_table: np.ndarray = field(init=False)
    seq_lens: np.ndarray = field(init=False)
    _free: list = field(init=False)

    def __post_init__(self) -> None:
        # The RoMe contract the whole memory-system view rides on: pages
        # are exact row multiples (size via tokens_per_row).
        if self.page_bytes % ROW_BYTES:
            raise ValueError(
                f"page of {self.page_bytes} B is not a whole number of "
                f"{ROW_BYTES} B DRAM rows; size page_tokens with "
                f"tokens_per_row()")
        self.device = resolve_device(self.device)
        shape = (self.n_pages, self.page_tokens, self.n_kv_heads,
                 self.head_dim)
        dt = _DTYPES[self.dtype]
        self.pool_k = torch.zeros(shape, dtype=dt, device=self.device)
        self.pool_v = torch.zeros(shape, dtype=dt, device=self.device)
        self.page_table = np.full((self.max_seqs, self.max_pages_per_seq),
                                  -1, np.int32)
        self.seq_lens = np.zeros((self.max_seqs,), np.int32)
        self._free = list(range(self.n_pages - 1, -1, -1))

    # -- bookkeeping (host-side, O(1) per token) -----------------------------

    @property
    def itemsize(self) -> int:
        return _DTYPES[self.dtype].itemsize

    @property
    def page_bytes(self) -> int:
        return (self.page_tokens * self.n_kv_heads * self.head_dim
                * self.itemsize)

    def rows_per_page(self) -> int:
        assert self.page_bytes % ROW_BYTES == 0
        return self.page_bytes // ROW_BYTES

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` of one sequence (a request's
        worst case is ``pages_for(prompt + max_new)``)."""
        return -(-n_tokens // self.page_tokens)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc_seq(self, seq_id: int, n_tokens: int) -> None:
        """Reserve pages for a new sequence of n_tokens (prefill)."""
        n_pages = self.pages_for(n_tokens)
        if n_pages > self.max_pages_per_seq:
            raise ValueError("sequence exceeds max_pages_per_seq")
        if n_pages > len(self._free):
            raise MemoryError("KV pool exhausted")
        for i in range(n_pages):
            self.page_table[seq_id, i] = self._free.pop()
        self.seq_lens[seq_id] = n_tokens

    def append_token(self, seq_id: int) -> tuple[int, int]:
        """Account one decoded token; returns (page_id, slot_in_page).
        Grabs a fresh page on a row boundary: appends never straddle."""
        pos = int(self.seq_lens[seq_id])
        page_idx, slot = divmod(pos, self.page_tokens)
        if self.page_table[seq_id, page_idx] < 0:
            if not self._free:
                raise MemoryError("KV pool exhausted")
            self.page_table[seq_id, page_idx] = self._free.pop()
        self.seq_lens[seq_id] = pos + 1
        return int(self.page_table[seq_id, page_idx]), slot

    def append_chunk(self, seq_id: int,
                     n_tokens: int) -> list[tuple[int, int, int]]:
        """Account ``n_tokens`` appended tokens in bulk (a prefill chunk);
        returns the contiguous (page_id, first_slot, n_slots) runs they
        landed in. Pages are grabbed lazily like :meth:`append_token`;
        runs never straddle a page, so every run is a row-aligned write
        target."""
        runs: list[tuple[int, int, int]] = []
        pos = int(self.seq_lens[seq_id])
        remaining = int(n_tokens)
        while remaining > 0:
            page_idx, slot = divmod(pos, self.page_tokens)
            if page_idx >= self.max_pages_per_seq:
                raise ValueError("sequence exceeds max_pages_per_seq")
            if self.page_table[seq_id, page_idx] < 0:
                if not self._free:
                    raise MemoryError("KV pool exhausted")
                self.page_table[seq_id, page_idx] = self._free.pop()
            take = min(remaining, self.page_tokens - slot)
            runs.append((int(self.page_table[seq_id, page_idx]), slot,
                         take))
            pos += take
            remaining -= take
        self.seq_lens[seq_id] = pos
        return runs

    def free_seq(self, seq_id: int) -> None:
        for i in range(self.max_pages_per_seq):
            p = self.page_table[seq_id, i]
            if p >= 0:
                self._free.append(int(p))
                self.page_table[seq_id, i] = -1
        self.seq_lens[seq_id] = 0

    def utilization(self) -> float:
        return 1.0 - len(self._free) / self.n_pages

    # -- memory-system view (unified workload records) -----------------------
    #
    # The two pools are contiguous device allocations laid out back to
    # back: page p's K rows live at base_addr + p * page_bytes and its V
    # rows at base_addr + pool_span + p * page_bytes. page_bytes is an
    # exact row multiple, so every record below is row-aligned by
    # construction.

    @property
    def pool_span_bytes(self) -> int:
        """Byte span of one pool (K or V)."""
        return self.n_pages * self.page_bytes

    def page_addr(self, page_id: int, base_addr: int = 0,
                  pool: str = "k") -> int:
        if pool not in ("k", "v"):
            raise ValueError(f"pool must be 'k' or 'v', got {pool!r}")
        off = 0 if pool == "k" else self.pool_span_bytes
        return base_addr + off + int(page_id) * self.page_bytes

    def read_stream(self, seq_id: int, base_addr: int = 0,
                    arrival_ns: float = 0.0) -> ExtentStream:
        """One decode step's KV gather for a sequence: one whole-page read
        per mapped page *per pool* (a decode kernel streams full rows of
        both K and V), tagged with the sequence id."""
        n_pages = self.pages_for(int(self.seq_lens[seq_id]))
        return ExtentStream(
            ExtentRecord(self.page_addr(p, base_addr, pool),
                         self.page_bytes, "read", arrival_ns, seq_id)
            for pool in ("k", "v")
            for p in self.page_table[seq_id, :n_pages])

    def write_stream(self, seq_id: int, page_id: int, slot: int,
                     base_addr: int = 0,
                     arrival_ns: float = 0.0) -> ExtentStream:
        """Pure record emission: the K and V write records for a token at
        ``(page_id, slot)``; no bookkeeping, safe to call repeatedly."""
        per_tok = self.n_kv_heads * self.head_dim * self.itemsize
        return ExtentStream(
            ExtentRecord(self.page_addr(page_id, base_addr, pool)
                         + slot * per_tok, per_tok, "write",
                         arrival_ns, seq_id)
            for pool in ("k", "v"))

    def append_chunk_stream(self, seq_id: int, n_tokens: int,
                            base_addr: int = 0,
                            arrival_ns: float = 0.0) -> ExtentStream:
        """Account one prefill chunk (side effect: see
        :meth:`append_chunk`) and return its K/V write records, coalesced
        to one record per page run per pool: each page's K (and V) slots
        are written as one sequential, row-granular burst."""
        per_tok = self.n_kv_heads * self.head_dim * self.itemsize
        runs = self.append_chunk(seq_id, n_tokens)
        return ExtentStream(
            ExtentRecord(self.page_addr(page_id, base_addr, pool)
                         + slot * per_tok, n_slots * per_tok, "write",
                         arrival_ns, seq_id)
            for page_id, slot, n_slots in runs
            for pool in ("k", "v"))

    def append_stream(self, seq_id: int, base_addr: int = 0,
                      arrival_ns: float = 0.0) -> ExtentStream:
        """Account one decoded token (side effect: see
        :meth:`append_token`; the token is accounted exactly once) and
        return its write records. To re-emit records for an
        already-accounted token use :meth:`write_stream`."""
        page_id, slot = self.append_token(seq_id)
        return self.write_stream(seq_id, page_id, slot, base_addr,
                                 arrival_ns)

    # -- device-side ops -----------------------------------------------------

    def write(self, page_id: int, slot: int, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """Write one token's K/V (n_kv_heads, head_dim) into its page, in
        place."""
        self.pool_k[page_id, slot] = k
        self.pool_v[page_id, slot] = v

    def gather_seq(self, seq_id: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Materialise a sequence's KV as (seq, n_kv_heads, head_dim): one
        index operation per pool over the sequence's pages."""
        n = int(self.seq_lens[seq_id])
        pages = torch.from_numpy(
            self.page_table[seq_id, :self.pages_for(n)].astype(np.int64)
        ).to(self.device)
        k = self.pool_k[pages].reshape(-1, self.n_kv_heads, self.head_dim)
        v = self.pool_v[pages].reshape(-1, self.n_kv_heads, self.head_dim)
        return k[:n], v[:n]
