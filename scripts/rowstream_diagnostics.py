#!/usr/bin/env python3
"""Diagnostics of the port's rowstream_matmul kernel on one NVIDIA GPU,
from the root of a checkout:

    python3 scripts/rowstream_diagnostics.py

1. Ablation: variants of ``csrc/rowstream_matmul.cu`` with a part cut out,
   built into ``build/rowstream_ablation/`` and timed per launch at each
   product shape of the qwen2-7b and rwkv6-3b decode steps (4 slots, bf16,
   weights cold in L2, as ``chip_smoke.py --only rowstream_matmul`` times
   them): an empty kernel, loads only (no arithmetic), no pushes (the
   blocks of a cluster send each other nothing; the rest of the cluster
   sum runs), no workspace sum (no arrival count, and the last cluster of
   a tile does not add the clusters' sums). Their outputs are wrong by
   design; only their times mean anything.
2. Planted faults: variants that leave out one K chunk (the first block of
   the first tile streams nothing) or one ring stage (that block skips its
   first stage), run at ``chip_smoke.py``'s decode-path shapes in bf16.
   Each case prints the error, whether the elementwise check of
   ``check_rowstream`` passes, and the norm-wise error per 256 columns
   against its bound (``RM_NORM_BOUND``). The script fails unless the
   whole kernel passes both checks and gives identical bits from two calls
   everywhere, and each fault fails the norm-wise check at every shape.

3. Plans: the planner's grid beside other grids for a few decode-path
   shapes, timed as in 1 (the numbers behind ``kernel.SMALL_BYTES``).

A source edit whose text is not found exactly once is an error. Device
times come from torch.profiler, as in ``chip_smoke.py``. It imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "rowstream_ablation"

LOOP = ("    if (active) {\n"
        "      const int rows = min(sr, nrows - st * sr);\n")
# Ablation: (name, source text, replacement).
CUTS = {
    "empty kernel": (
        "  cluster_arrive();\n  cg::cluster_group cluster",
        "  if (p.m > 0) return;\n"
        "  cluster_arrive();\n  cg::cluster_group cluster"),
    "loads only": (
        LOOP,
        "    if (active && p.m < 0) {\n"
        "      const int rows = min(sr, nrows - st * sr);\n"),
    "no pushes": (
        "  if (phases == 1) {\n    if (active) {\n",
        "  if (phases == 1) {\n    if (active && p.m < 0) {\n"),
    "no workspace sum": (
        "  if (G == 1) return;\n\n",
        "  return;\n\n"),
}
# Planted faults: (name, source text, replacement).
FIRST_BLOCK = "blockIdx.y == 0 && blockIdx.z == 0 && rank == 0"
FAULTS = {
    "one K chunk left out": (
        "  const int nrows = ke - kb;\n",
        f"  const int nrows = {FIRST_BLOCK} ? 0 : ke - kb;\n"),
    "one ring stage left out": (
        LOOP,
        f"    if (active && !(st == 0 && {FIRST_BLOCK})) {{\n"
        "      const int rows = min(sr, nrows - st * sr);\n"),
}


# Other grids: (cluster, clusters per full tile, tile columns, granule).
PLANS = {
    (4, 2560, 2560): [(8, 20, 2048, 1), (8, 16, 2048, 1), (8, 10, 2048, 1)],
    (4, 3584, 512): [(8, 28, 512, 4), (8, 7, 512, 4)],
    (4, 3584, 3584): [(8, 17, 2048, 1), (8, 12, 2048, 1)],
    (4, 2560, 64): [(8, 20, 64, 16), (8, 5, 64, 32)],
    (4, 64, 2560): [(8, 1, 128, 1), (8, 1, 2048, 1), (1, 1, 128, 1)],
    (4, 3584, 18944): [(4, 3, 2048, 1), (2, 7, 2048, 1)],
}


def edited(src: str, old: str, new: str, name: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"variant '{name}': its source text is found "
                           f"{src.count(old)} times, not once: {old!r}")
    return src.replace(old, new)


def variants(edits: dict) -> dict:
    """The C entry point of each edit {name: (old, new)} of the source,
    one nvcc each, in parallel."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rowstream_matmul import kernel
    src = (build.CSRC / "rowstream_matmul.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in edits.items():
        stem = OUT / name.replace(" ", "_")
        stem.with_suffix(".cu").write_text(edited(src, old, new, name))
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o",
               str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       stem.with_suffix(".so"))
    whole = kernel._function()
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the variant '{name}':\n{log}")
        fn = ctypes.CDLL(str(lib)).rowstream_matmul
        fn.argtypes, fn.restype = whole.argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def ablation(torch, cs, kernel) -> None:
    fns = {"whole kernel": kernel._function()}
    fns.update(variants(CUTS))
    for m, k, n in cs.RM_PATH:
        times = per_launch_us(torch, cs, kernel, (m, k, n),
                              [(fn, None) for fn in fns.values()])
        text = "; ".join(f"{name} {' / '.join(f'{t:.3f}' for t in ts)}"
                         for name, ts in zip(fns, times))
        print(f"[ablation] ({m}, {k}) @ ({k}, {n}), us per launch: {text}")


def per_launch_us(torch, cs, kernel, shape, runs) -> list:
    """Device time per launch of each run (C entry point, plan or None for
    the planner's) at `shape`, over ROUND_BYTES or more of distinct cold
    weights, each run timed twice, in turns."""
    m, k, n = shape
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 10)
    copies = -(-cs.ROUND_BYTES // (2 * k * n))
    x, w = cs.rowstream_inputs(torch, gen, m, k, n, torch.bfloat16)
    ws = [w] + [cs.rowstream_inputs(torch, gen, 1, k, n, torch.bfloat16)[1]
                for _ in range(copies - 1)]
    times = [[] for _ in runs]
    for i in list(range(len(runs))) + list(range(len(runs)))[::-1]:
        fn, p = runs[i]
        times[i].append(cs.device_ms(
            lambda: [kernel.launch(fn, x, w_, p) for w_ in ws], 3,
            cs.RM_KERNELS) / copies * 1e3)
    del x, ws
    torch.cuda.empty_cache()
    return times


def grids(torch, cs, kernel) -> None:
    fn = kernel._function()
    for (m, k, n), alts in PLANS.items():
        x = torch.empty((m, k), dtype=torch.bfloat16, device="cuda")
        w = torch.empty((k, n), dtype=torch.bfloat16, device="cuda")
        plans = [kernel.plan_for(x, w)]
        for cluster, groups, cols, granule in alts:
            cols_r = n % cols if cols < n else 0
            plans.append(kernel.Plan(
                m, k, n, 2, 8, kernel.m_tile(m), cluster, n // cols, cols,
                groups, cols_r, -(-groups * cols_r // cols), granule))
        times = per_launch_us(torch, cs, kernel, (m, k, n),
                              [(fn, p) for p in plans])
        text = "; ".join(
            f"{'planner: ' if i == 0 else ''}clusters of {p.cluster}, "
            f"{p.groups}/{p.groups_r} per tile, {p.cols}-column tiles, "
            f"{p.blocks} blocks {' / '.join(f'{t:.3f}' for t in times[i])}"
            for i, p in enumerate(plans))
        print(f"[plans] ({m}, {k}) @ ({k}, {n}), us per launch: {text}")


def faults(torch, cs, kernel) -> None:
    from repro_torch.kernels.rowstream_matmul.ref import rowstream_matmul_ref
    fns = {"whole kernel": kernel._function()}
    fns.update(variants(FAULTS))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    bound = cs.RM_NORM_BOUND["bfloat16"]
    for m, k, n in cs.RM_PATH:
        x, w = cs.rowstream_inputs(torch, gen, m, k, n, torch.bfloat16)
        ref = rowstream_matmul_ref(x, w)
        for name, fn in fns.items():
            out = kernel.launch(fn, x, w)
            again = kernel.launch(fn, x, w)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            elementwise = bool((err <= 0.16 + 2e-2 * ref.float().abs()).all())
            norm = cs.slice_norm_error(torch, out, ref)
            same = torch.equal(out, again)
            print(f"[faults] {name}, ({m}, {k}) @ ({k}, {n}): max err "
                  f"{err.max().item()!r}; elementwise check "
                  f"{'passes' if elementwise else 'fails'}; norm-wise error "
                  f"{norm!r} (bound {bound}) "
                  f"{'passes' if norm <= bound else 'fails'}; two calls "
                  f"{'identical' if same else 'differ'}")
            if name == "whole kernel":
                cs.check(elementwise and norm <= bound and same,
                         f"the whole kernel fails at {(m, k, n)}")
            else:
                cs.check(norm > bound, f"the planted fault '{name}' passes "
                                       f"the norm-wise check at {(m, k, n)}")
        del x, w, ref
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rowstream_diagnostics: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.rowstream_matmul import kernel
    print(f"[card] {cs.card_line()}")
    faults(torch, cs, kernel)
    ablation(torch, cs, kernel)
    grids(torch, cs, kernel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
