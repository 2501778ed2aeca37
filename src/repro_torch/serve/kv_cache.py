"""Row granularity of the KV cache.

The row-paged cache itself (``repro.serve.kv_cache.RowPagedKVCache``) is
not on the decode path the port serves yet; this module holds the DRAM row
size that the serve driver reports against and that the kernels tile by.
"""
ROW_BYTES = 4096
