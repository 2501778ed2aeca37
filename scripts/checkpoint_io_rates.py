#!/usr/bin/env python3
"""The rates a checkpoint of the port moves at on a machine with a CUDA
card: the free disk and host memory, ``np.savez`` of 4.29 GB in four
arrays with an fsync and ``np.load`` of it back (the calls
``repro_torch.distributed.checkpoint`` makes), and pageable copies of
4.29 GB from the card to the host and back. Run from the repo root:

    python3 scripts/checkpoint_io_rates.py

It writes 4.29 GB to a temporary directory and removes it. Exits non-zero
without a card.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def shell(cmd: str) -> None:
    print(f"$ {cmd}")
    print(subprocess.run(cmd, shell=True, capture_output=True,
                         text=True).stdout, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    shell("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
    tmp = tempfile.mkdtemp(prefix="ckpt_rates_")
    shell(f"df -h {tmp}; free -g")
    arrays = {f"leaf_{i}": np.ones(256 << 20, np.float32) for i in range(4)}
    gb = sum(a.nbytes for a in arrays.values()) / 1e9
    path = os.path.join(tmp, "host_000.npz")
    try:
        t = time.perf_counter()
        with open(path, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        with np.load(path) as data:
            total = sum(float(data[k][0]) for k in data.files)
        read_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp)
    print(f"np.savez {gb:.2f} GB with fsync: {write_s:.2f} s "
          f"({gb / write_s:.2f} GB/s); np.load {read_s:.2f} s "
          f"({gb / read_s:.2f} GB/s); {total:.0f}")
    dev = torch.empty(1 << 30, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    host = dev.cpu()
    d2h_s = time.perf_counter() - t
    t = time.perf_counter()
    dev.copy_(host)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t
    print(f"pageable copies of {gb:.2f} GB: card to host {d2h_s:.2f} s "
          f"({gb / d2h_s:.2f} GB/s), host to card {h2d_s:.2f} s "
          f"({gb / h2d_s:.2f} GB/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
