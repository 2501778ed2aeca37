"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each ``kernels/<name>/`` holds ``kernel.py`` (launches the CUDA C++ kernel
in ``csrc/<name>.cu`` through ctypes), ``ref.py`` (the plain PyTorch
version) and ``ops.py`` (the wrapper: the kernel for CUDA tensors, the
plain version for CPU tensors). Every wrapper counts its kernel launches in
a :class:`LaunchCounter`, so a run can show that its path went through the
kernels.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

#: dtype codes of the kernels' C entry points.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass
class LaunchCounter:
    """Number of times a wrapper launched its CUDA kernel."""
    name: str
    count: int = 0


def launch_counters() -> dict[str, LaunchCounter]:
    from .flash_decode.ops import LAUNCHES as fd
    from .rowstream_matmul.ops import LAUNCHES as rm
    from .rwkv_scan.ops import BWD_LAUNCHES as rsb
    from .rwkv_scan.ops import LAUNCHES as rs
    return {c.name: c for c in (fd, rm, rs, rsb)}


def reset_launch_counters() -> None:
    for c in launch_counters().values():
        c.count = 0


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count
