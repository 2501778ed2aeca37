"""Serving layer of the port: the row-paged KV cache and continuous
batching with chunked prefill."""
from .kv_cache import RowPagedKVCache, ROW_BYTES, tokens_per_row
from .batching import ContinuousBatcher, Request, RequestTimeline

__all__ = ["RowPagedKVCache", "ROW_BYTES", "tokens_per_row",
           "ContinuousBatcher", "Request", "RequestTimeline"]
