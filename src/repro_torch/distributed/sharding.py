"""Integer padding helpers, copied from ``repro.distributed.sharding``
(that module imports JAX; these functions do not). The port has no
tensor parallelism yet, so the query-head padding to a multiple of TP
(``padded_heads``) waits for the slice that adds it."""
from __future__ import annotations


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    """Vocab padded to a lane-aligned multiple (whisper: 51865 -> 51968)."""
    return pad_to_multiple(vocab, multiple)
