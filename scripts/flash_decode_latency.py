#!/usr/bin/env python3
"""Diagnostics of the port's flash_decode kernel on one NVIDIA GPU, from
the root of a checkout:

    python3 scripts/flash_decode_latency.py

1. Clusters: how many thread-block clusters of 1, 2, 4 and 8 blocks the
   card holds at once at one and at two blocks per SM
   (cudaOccupancyMaxActiveClusters on a small kernel built with nvcc).
2. Chunks: device time per launch at qwen2-7b's serve shape (4 slots, 128
   cache slots, 28 layers' caches) for each minimum chunk of the
   planner, beside scaled_dot_product_attention's.
3. Ablation: variants of ``csrc/flash_decode.cu`` with a part cut out,
   built into ``build/flash_decode_ablation/`` and timed at the same
   shape: no merges, no cluster merge, no arithmetic, an empty kernel.
   Their outputs are wrong by design; only their times mean anything.
4. Planted faults: variants of the tensor-core kernel that leave out one
   chunk of each pair, or the last tile of each chunk, run on
   ``chip_smoke.py``'s long-context bf16 cases. Each case prints whether
   the elementwise check and the scaled check of ``flash_verdict`` pass;
   the script fails unless the whole kernel passes both everywhere and
   each fault fails the scaled check in some case.

A source edit whose text is not found exactly once is an error. Device
times come from torch.profiler, as in ``chip_smoke.py``. It imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "flash_decode_ablation"

CLUSTER_PROBE = r"""
#include <cstdio>
#include <cuda_runtime.h>
__global__ void probe(float* x) { if (x) x[threadIdx.x] = 0.f; }
int main() {
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       200 * 1024);
  const int smem_kb[] = {100, 120};   // two blocks per SM fit, one fits
  for (int kb : smem_kb) {
    printf("[clusters] 256 threads, %d KB of shared memory a block:", kb);
    for (int c = 1; c <= 8; c *= 2) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(c, 16, 1);
      cfg.blockDim = dim3(256);
      cfg.dynamicSmemBytes = kb * 1024;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = c;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      int n = -1;
      cudaOccupancyMaxActiveClusters(&n, probe, &cfg);
      printf(" clusters of %d: %d;", c, n);
    }
    printf("\n");
  }
  return 0;
}
"""

# Ablation: (name, marker in the source, text put before the marker).
CUTS = {
    "no merges": (
        "  // The warps' states go to the stage after the last tile's",
        "  { float z = l_run;\n"
        "    for (int n = 0; n < NTILES; ++n) z += o[n][0];\n"
        "    if (z == -1.f) out[threadIdx.x] = __float2bfloat16(z);\n"
        "    return; }\n"),
    "no cluster merge": (
        "  cluster_wait_started();\n",
        "  if (wacc[threadIdx.x] == -1.f) op[0] = from_float<QT>(0.f);\n"
        "  return;\n"),
    "no arithmetic": (
        "    if (warp * 16 >= nt) continue;",
        "    continue;\n"),
    "empty kernel": (
        "  constexpr int KSTEPS = D / 16;",
        "  if (g >= 0) return;\n"),
}

# Planted faults of flash_decode_mma: (name, source text, replacement).
MMA_TILES = "  const int ntiles = (t_end - t_begin + MMA_TT - 1) / MMA_TT;\n"
FAULTS = {
    "one chunk left out": (
        MMA_TILES,
        "  const int ntiles = split == 1 ? 0\n"
        "      : (t_end - t_begin + MMA_TT - 1) / MMA_TT;\n"),
    "last tile of each chunk left out": (
        MMA_TILES,
        "  const int ntiles = (t_end - t_begin - 1) / MMA_TT;\n"),
}


def clusters() -> None:
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "cluster_probe.cu").write_text(CLUSTER_PROBE)
    subprocess.run([build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-o", str(OUT / "cluster_probe"),
                    str(OUT / "cluster_probe.cu")], check=True)
    subprocess.run([str(OUT / "cluster_probe")], check=True)


def edited(src: str, old: str, new: str, name: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"variant '{name}': its source text is found "
                           f"{src.count(old)} times, not once: {old!r}")
    return src.replace(old, new)


def variants(edits: dict) -> dict:
    """The C entry point of each edit {name: (old, new)} of the source,
    one nvcc each, in parallel."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import kernel
    src = (build.CSRC / "flash_decode.cu").read_text()
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
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the variant '{name}':\n{log}")
        fn = ctypes.CDLL(str(lib)).flash_decode
        fn.argtypes, fn.restype = whole.argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def chunks(torch, cs, cfg, kernel) -> None:
    n = cfg.n_layers
    sweep = (16, 32, 64, 128)
    for mc in sweep + sweep[::-1]:
        work = cs.flash_work(torch, cfg, cs.SLOTS, cs.MAX_SEQ,
                             kernel=functools.partial(
                                 kernel.launch, kernel._function(),
                                 min_chunk=mc))
        ms = cs.device_ms(work["kernel"], 50, cs.FD_KERNELS)
        chunk, nsplit = kernel.plan(cs.MAX_SEQ, 16, 128, 2, 132, mc)
        print(f"[chunks] minimum chunk {mc}: {nsplit} splits of {chunk} "
              f"tokens, {ms / n * 1e3!r} us per launch"
              + (" (the planner's)" if mc == kernel.MIN_CHUNK else ""))
    lib = cs.device_ms(work["library"], 50)
    print(f"[chunks] scaled_dot_product_attention: {lib / n * 1e3!r} us "
          f"per launch")


def ablation(torch, cs, cfg, kernel) -> None:
    fns = {"whole kernel": kernel._function()}
    fns.update(variants({name: (marker, cut + marker)
                         for name, (marker, cut) in CUTS.items()}))
    n = cfg.n_layers
    for name in list(fns) + list(fns)[::-1]:
        work = cs.flash_work(torch, cfg, cs.SLOTS, cs.MAX_SEQ,
                             kernel=functools.partial(kernel.launch,
                                                      fns[name]))
        ms = cs.device_ms(work["kernel"], 50, cs.FD_KERNELS)
        print(f"[ablation] {name}: {ms / n * 1e3!r} us per launch")


def faults(torch, cs, kernel) -> None:
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    fns = {"whole kernel": kernel._function()}
    fns.update(variants(FAULTS))
    cases = [c for c in cs.flash_cases()
             if c[6] == c[7] == "bfloat16" and c[3] >= 4096 and c[4] == 128
             and c[2] == 4]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    caught = {name: False for name in FAULTS}
    for case in cases:
        q, kc, vc, pos = cs.flash_inputs(torch, gen, case)
        ref = flash_decode_ref(q, kc, vc, pos)
        for name, fn in fns.items():
            out = kernel.launch(fn, q, kc, vc, pos)
            torch.cuda.synchronize()
            elementwise, scaled, err, scale = cs.flash_verdict(torch, out,
                                                               ref)
            print(f"[faults] {name}, S {case[3]} pos {pos}: max err {err!r}, "
                  f"max |ref| {scale!r}; elementwise check "
                  f"{'passes' if elementwise else 'fails'}, scaled check "
                  f"{'passes' if scaled else 'fails'}")
            if name == "whole kernel":
                cs.check(elementwise and scaled,
                         f"the whole kernel fails case {case}")
            elif not scaled:
                caught[name] = True
        del q, kc, vc, ref
        torch.cuda.empty_cache()
    for name, hit in caught.items():
        cs.check(hit, f"the planted fault '{name}' passes every long-context "
                      f"case")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_decode_latency: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.kernels.flash_decode import kernel
    print(f"[card] {cs.card_line()}")
    clusters()
    cfg = ALL_ARCHS["qwen2-7b"]
    chunks(torch, cs, cfg, kernel)
    ablation(torch, cs, cfg, kernel)
    faults(torch, cs, kernel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
