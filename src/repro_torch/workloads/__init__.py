"""Workload descriptions of the port: the extent stream that the row-paged
KV cache emits (``stream.py``, copied from ``repro.workloads.stream``). The
reference's stream generators (layer-op traces, synthetic streams) and its
package re-exports are not ported."""
