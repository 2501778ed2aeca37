"""Timed, typed extent streams: the unified workload description.

A copy of ``repro.workloads.stream`` (NumPy only), so that the port's
row-paged KV cache (``serve/kv_cache.py``) emits the same records as the
reference's without importing the JAX package. An :class:`ExtentStream` is
an ordered sequence of :class:`ExtentRecord` entries, each one contiguous
memory transfer at the software level::

    ExtentRecord(addr, nbytes, kind, arrival_ns, stream_id)

``addr``/``nbytes`` address the row-aligned virtual address space that the
paged KV cache hands out; ``kind`` is ``"read"`` or ``"write"``;
``arrival_ns`` is when the transfer becomes visible to the memory
controller; ``stream_id`` tags the issuing software stream (layer op,
tenant, sequence) for grouping and stats.

Streams are immutable values: slicing, merging, shifting, and retagging
return new streams.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterable, Iterator

KINDS = ("read", "write")


@dataclass(frozen=True)
class ExtentRecord:
    """One contiguous transfer in the software address space."""

    addr: int
    nbytes: int
    kind: str = "read"          # "read" | "write"
    arrival_ns: float = 0.0
    stream_id: int = 0

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.nbytes <= 0:
            raise ValueError(f"nbytes must be positive, got {self.nbytes}")
        if self.addr < 0:
            raise ValueError(f"addr must be non-negative, got {self.addr}")

    @property
    def is_write(self) -> bool:
        return self.kind == "write"

    @property
    def end(self) -> int:
        return self.addr + self.nbytes


class ExtentStream:
    """Ordered, immutable sequence of :class:`ExtentRecord` entries.

    Order is *issue order* — the order transactions reach the memory
    controller for records with equal arrival times. Builders emit
    records in non-decreasing ``arrival_ns``; :meth:`interleave` and
    :meth:`sorted_by_arrival` restore that invariant after merging.
    """

    __slots__ = ("_records", "_memo")

    def __init__(self, records: Iterable[ExtentRecord] = ()) -> None:
        recs = tuple(records)
        for r in recs:
            if not isinstance(r, ExtentRecord):
                raise TypeError(f"expected ExtentRecord, got {type(r)!r}")
        object.__setattr__(self, "_records", recs)
        # Per-instance scratch for derived immutable views (numpy arrays,
        # queue-model features). Never part of equality/hashing.
        object.__setattr__(self, "_memo", {})

    # -- sequence protocol ---------------------------------------------------

    @property
    def records(self) -> tuple[ExtentRecord, ...]:
        return self._records

    def __len__(self) -> int:
        return len(self._records)

    def __iter__(self) -> Iterator[ExtentRecord]:
        return iter(self._records)

    def __bool__(self) -> bool:
        return bool(self._records)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ExtentStream(self._records[i])
        return self._records[i]

    def __add__(self, other: "ExtentStream") -> "ExtentStream":
        return ExtentStream(self._records + tuple(other))

    def __eq__(self, other) -> bool:
        return (isinstance(other, ExtentStream)
                and self._records == other._records)

    def __hash__(self) -> int:
        return hash(self._records)

    def __repr__(self) -> str:
        return (f"ExtentStream({len(self)} records, "
                f"{self.read_bytes} B read, {self.write_bytes} B write, "
                f"span {self.span_ns:.0f} ns)")

    # -- aggregate views -----------------------------------------------------

    @property
    def total_bytes(self) -> int:
        return sum(r.nbytes for r in self._records)

    @property
    def read_bytes(self) -> int:
        return sum(r.nbytes for r in self._records if not r.is_write)

    @property
    def write_bytes(self) -> int:
        return sum(r.nbytes for r in self._records if r.is_write)

    @property
    def span_ns(self) -> float:
        """Arrival span (last arrival - first arrival); 0 for <=1 record."""
        if len(self._records) < 2:
            return 0.0
        ts = [r.arrival_ns for r in self._records]
        return max(ts) - min(ts)

    @property
    def last_arrival_ns(self) -> float:
        return max((r.arrival_ns for r in self._records), default=0.0)

    @property
    def stream_ids(self) -> tuple[int, ...]:
        seen: dict[int, None] = {}
        for r in self._records:
            seen.setdefault(r.stream_id, None)
        return tuple(seen)

    def extents(self, kind: str | None = None) -> list[tuple[int, int]]:
        """(addr, nbytes) pairs, optionally filtered by kind — the legacy
        extent-list view consumed by ``channel_bytes``/``transfer_time_ns``."""
        if kind is not None and kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        return [(r.addr, r.nbytes) for r in self._records
                if kind is None or r.kind == kind]

    @property
    def memo(self) -> dict:
        """Per-instance cache for derived views keyed by the deriver.

        Streams are immutable, so anything computed from the records
        (feature censuses, pricing signatures) stays valid for the
        stream's lifetime. Excluded from ``__eq__``/``__hash__``.
        """
        return self._memo

    def arrays(self):
        """Columnar numpy view ``(addr, nbytes, is_write, arrival_ns)``
        of the records, computed once per instance — the input format of
        the vectorized censuses (:func:`repro.core.address_map
        .extent_census`) and the batched queue-model pricer."""
        cached = self._memo.get("arrays")
        if cached is None:
            import numpy as np
            n = len(self._records)
            addr = np.empty(n, np.int64)
            nbytes = np.empty(n, np.int64)
            is_write = np.empty(n, bool)
            arrival = np.empty(n, np.float64)
            for i, r in enumerate(self._records):
                addr[i] = r.addr
                nbytes[i] = r.nbytes
                is_write[i] = r.kind == "write"
                arrival[i] = r.arrival_ns
            for a in (addr, nbytes, is_write, arrival):
                a.setflags(write=False)
            cached = self._memo["arrays"] = (addr, nbytes, is_write, arrival)
        return cached

    # -- derivation ----------------------------------------------------------

    def of_kind(self, kind: str) -> "ExtentStream":
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        return ExtentStream(r for r in self._records if r.kind == kind)

    def of_stream(self, stream_id: int) -> "ExtentStream":
        return ExtentStream(r for r in self._records
                            if r.stream_id == stream_id)

    def shifted(self, dt_ns: float) -> "ExtentStream":
        """Every arrival moved by ``dt_ns``."""
        return ExtentStream(replace(r, arrival_ns=r.arrival_ns + dt_ns)
                            for r in self._records)

    def retagged(self, stream_id: int) -> "ExtentStream":
        return ExtentStream(replace(r, stream_id=stream_id)
                            for r in self._records)

    def rebased(self, base_addr: int) -> "ExtentStream":
        """Addresses translated so the lowest address becomes ``base_addr``."""
        if not self._records:
            return self
        lo = min(r.addr for r in self._records)
        return ExtentStream(replace(r, addr=r.addr - lo + base_addr)
                            for r in self._records)

    def sorted_by_arrival(self) -> "ExtentStream":
        """Stable sort by arrival time (preserves issue order within ties)."""
        return ExtentStream(sorted(self._records,
                                   key=lambda r: r.arrival_ns))

    def limit_bytes(self, budget: int) -> "ExtentStream":
        """Longest prefix whose total bytes do not exceed ``budget``
        (always keeps at least one record if the stream is non-empty)."""
        out, tot = [], 0
        for r in self._records:
            if out and tot + r.nbytes > budget:
                break
            out.append(r)
            tot += r.nbytes
        return ExtentStream(out)

    def coalesced(self, granularity: int = 1) -> "ExtentStream":
        """Merge same-kind records whose ranges overlap or touch once
        rounded out to ``granularity`` (e.g. the 4 KB row): the MC-side
        request merge that deduplicates row fetches for a sparse gather.
        Merged records keep the earliest arrival and the first
        contributor's stream id; output is ordered by (arrival, addr).
        """
        if granularity < 1:
            raise ValueError(f"granularity must be >= 1, got {granularity}")
        merged: list[list] = []
        for kind in KINDS:
            recs = sorted((r for r in self._records if r.kind == kind),
                          key=lambda r: r.addr)
            cur: list | None = None
            for r in recs:
                lo = (r.addr // granularity) * granularity
                hi = -(-r.end // granularity) * granularity
                if cur is not None and lo <= cur[1]:
                    cur[1] = max(cur[1], hi)
                    cur[2] = min(cur[2], r.arrival_ns)
                else:
                    if cur is not None:
                        merged.append(cur)
                    cur = [lo, hi, r.arrival_ns, r.stream_id, kind]
            if cur is not None:
                merged.append(cur)
        merged.sort(key=lambda c: (c[2], c[0]))
        return ExtentStream(
            ExtentRecord(lo, hi - lo, kind, t, sid)
            for lo, hi, t, sid, kind in merged)

    @staticmethod
    def interleave(streams: Iterable["ExtentStream"]) -> "ExtentStream":
        """Merge streams by arrival time into one multi-tenant stream.

        The merge is stable: records with equal arrivals keep the order of
        the input streams, so per-stream issue order survives. Callers are
        responsible for tagging tenants apart (:meth:`retagged`) if the
        inputs share stream ids.
        """
        tagged = []
        for si, s in enumerate(streams):
            for ri, r in enumerate(s):
                tagged.append((r.arrival_ns, si, ri, r))
        tagged.sort(key=lambda t: (t[0], t[1], t[2]))
        return ExtentStream(t[3] for t in tagged)


__all__ = ["ExtentRecord", "ExtentStream", "KINDS"]
