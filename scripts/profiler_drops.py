#!/usr/bin/env python3
"""How many kernel records torch.profiler keeps as a process ages, on one
NVIDIA GPU, from the root of a checkout:

    python3 scripts/profiler_drops.py [--seconds 150] [--idle]

Every 8 s or so it opens four windows and prints the kernel records each
kept: 28 flash_decode launches at qwen2-7b's serve shape alone ("bare");
the same 28 after 28 rowstream_matmul launches ("after 28 others"),
which shows which records go; the same 28 after 32 pad kernels of about
0.5 ms each ("long pads"), which tells a lost count of records from a
lost stretch of time; and the same 28 in ``chip_smoke.profiled``, whose
window opens with 256 tiny pad kernels ("padded"). In between it keeps
the card busy with the plain flash_decode, or with ``--idle`` sleeps.
It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--idle", action="store_true",
                    help="sleep between the windows instead of running "
                         "the plain flash_decode")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_drops: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.rowstream_matmul.ops import rowstream_matmul
    print(f"[card] {cs.card_line()}; torch {torch.__version__}")
    build.build(("flash_decode", "rowstream_matmul"))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q = torch.randn((4, 28, 128), generator=gen, device="cuda").bfloat16()
    kc, vc = (torch.randn((4, 4, cs.MAX_SEQ, 128), generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    x = torch.randn((4, 3584), generator=gen, device="cuda").bfloat16()
    w = torch.randn((3584, 512), generator=gen, device="cuda").bfloat16()

    def flash():
        for _ in range(28):
            flash_decode(q, kc, vc, cs.MAX_SEQ - 1)

    def kept(prof) -> str:
        n = {name: cs._device_kernels(prof, names)[1]
             for name, names in (("flash_decode", cs.FD_KERNELS),
                                 ("rowstream_matmul", cs.RM_KERNELS))}
        return (f"{n['flash_decode']}/28 flash_decode, "
                f"{n['rowstream_matmul']} rowstream_matmul")

    flash()
    rowstream_matmul(x, w)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        age = time.perf_counter() - t0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as bare:
            flash()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as after:
            for _ in range(28):
                rowstream_matmul(x, w)
            flash()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as long_pads:
            for _ in range(32):
                torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
            flash()
            torch.cuda.synchronize()
        with cs.profiled() as padded:
            flash()
        print(f"[drops] {age:6.1f} s into the loop: bare {kept(bare)}; "
              f"after 28 others {kept(after)}; long pads {kept(long_pads)} "
              f"({cs.pads_kept(long_pads)}/32 pads kept); padded "
              f"{kept(padded)} ({cs.pads_kept(padded)}/{cs.PAD_LAUNCHES} "
              f"pads kept)", flush=True)
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < 8:
            if args.idle:
                time.sleep(0.1)
            else:
                flash_decode_ref(q, kc, vc, cs.MAX_SEQ - 1)
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
