#!/usr/bin/env python3
"""Diagnostics of the port's rwkv_scan kernel on one NVIDIA GPU, from the
root of a checkout:

    python3 scripts/rwkv_scan_diagnostics.py [--old OLD.cu] [--bwd]

1. Planted faults: variants of ``csrc/rwkv_scan.cu``, built into
   ``build/rwkv_scan_diagnostics/``, that leave out one tile's intra-chunk
   term (A = 0 in block 0's tile 1), drop the carried state at one tile
   (block 0, before tile 2), or take one channel's decay product one token
   too far (channel 5 of r_dec, in every tile). Each runs through every
   case of ``chip_smoke.check_rwkv_scan`` and prints, per case, the errors
   and whether the unchanged check passes. The script fails unless the
   whole kernel passes every case and each fault fails at least one. The
   1xTF32 variant below runs through the same cases, reported only.
2. Ablation of this kernel, timed over the 32 launches of one rwkv6-3b
   forward (``chip_smoke.scan_phase``'s inputs): the whole kernel, loads
   only (the walk, copies and barriers, no arithmetic), no dot products of
   A, no per-channel walks (decays, r~, k~, v), no state products, and one
   TF32 product where three are summed
   (1xTF32: its time and its error against the plain version at full
   width, reported only), and the state products on CUDA cores
   (``SIMT_STATE``, register-tiled, with its error). Outputs of the cut
   variants are wrong by design. Then the kernel alone at b * H = 132,
   160 and 264 (one, one or two, two blocks on every SM).
3. With ``--old``: the same timing of an earlier source whose kernel,
   ``rwkv_scan_kernel`` (a block per 16 value columns), has the C
   signature ``rwkv_scan(r, k, v, w, u, o, s_final, b, H, s, hd, chunk,
   dtype, stream)``: whole, its C x C loop left out, and loads only.

4. Planted faults in the backward, ``csrc/rwkv_scan_bwd.cu``: one dw group
   that skips a decay (after_t left out of after_t c_t), a tile whose S_in
   is one tile stale (tile 3 copies the state before tile 2), and g4's
   walk back that skips its decays. Each runs through every case of
   ``chip_smoke.check_rwkv_scan_bwd`` (with and without dS in turns); the
   script fails unless the whole kernel passes every case and each fault
   fails at least one. Then the backward's ablation over the 32 launches
   of one rwkv6-3b training microbatch (``chip_smoke.scan_bwd_phase``'s
   shape and decays): the whole kernel; no per-channel epilogue of the
   state warps; no state-free per-channel terms of the prep warps (dr's
   and dk's dA sums, g4); no A or dA; prep warps that only wait for their
   tile; state warps that do nothing on the walk back, or on the walk
   forward; 1xTF32. Outputs of the cut variants are wrong by design. And
   the whole kernel at b * H = 132 (one block on every SM, one wave) and
   160 (the training shape: 28 SMs take a second block after the first).
   ``--bwd`` runs only this part.

A source edit whose text is not found exactly once is an error. Device
times come from torch.profiler, as in ``chip_smoke.py``. It imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "rwkv_scan_diagnostics"

# Source texts the edits below replace (the kernel's markers).
A_DOTS = "  float* A = pb + A_OFF;\n"
WALKS = "  {\n    const int d = pt & (HD - 1);\n    if (pt < HD) {\n"
WAITED = "  mbar_wait(&ring.full[st], (t / STAGES) & 1);\n"
STATE_START = "  const int g = lane >> 2, t = lane & 3;\n  // v^T fragments"
STATE_PRODUCTS = "  // o^T = S^T r_dec^T + v^T A^T, in accumulators"
STATE_TILE = ("    if (state) {\n"
              "      const Tile tl = tile_at(m, s, C, tpc);\n")
R_DEC = "pb[RD_OFF + i * RD_STRIDE + d] = rv * p;"
SMALL = "  mma(small, al, b0h, b1h);\n  mma(small, ah, b0l, b1l);\n"

# The backward's planted faults (csrc/rwkv_scan_bwd.cu).
BWD_FAULTS = {
    "dw's after_t c_t without after_t": (
        "gs[s * HD + i] = fmaf(bef[s] * aft[s], D, aft[s] * c)",
        "gs[s * HD + i] = fmaf(bef[s] * aft[s], D, c)"),
    "tile 3's S_in one tile stale": (
        "ck + static_cast<size_t>(m1 - 1) * STATE_FLOATS,",
        "ck + static_cast<size_t>(m1 == 3 ? m1 - 2 : m1 - 1) * STATE_FLOATS,"),
    "g4 without its decays": (
        "        g4[t] = fmaf(rho, hs[t], g4[t]);\n        rho *= wv[t];\n",
        "        g4[t] = fmaf(rho, hs[t], g4[t]);\n"),
}
# Cuts of the backward for its ablation (csrc/rwkv_scan_bwd.cu).
BWD_EPILOGUE = ("  // Per channel: dk (role 0), dr (2), dv's halves summed "
                "(3); dw's terms\n")
BWD_TERMS = "  if (role < 2) {\n    const int tp0"
BWD_PREP = ("  ring.wait(x);\n  const int d = pt & (HD - 1), role = pt / HD;\n"
            "  const float ud = u_s[d];\n")
BWD_STATE = ("  const int q = warp & 3, h = warp >> 2, c0 = 16 * q, n0 = 4 * h;\n"
             "\n  // G_out to shared memory")
BWD_FORWARD = "  unsigned vh[2][4], vl[2][4];\n  token_a(pb + V_OFF"
BWD_CUTS = {
    "no state epilogue": [(BWD_EPILOGUE,
                           "  if (len >= 0) return;\n" + BWD_EPILOGUE)],
    "no state-free terms": [(BWD_TERMS,
                             "  if (len >= 0) return;\n" + BWD_TERMS)],
    "no A or dA": [
        ("  if (pt < A_ITEMS) {\n", "  if (pt < 0) {\n"),
        ("  if (pt >= PREP_THREADS - 64) {\n", "  if (pt < 0) {\n")],
    "prep waits only": [(BWD_PREP, BWD_PREP + "  if (len >= 0) return;\n")],
    "state idle on the walk back": [
        (BWD_STATE, BWD_STATE.replace("\n\n", "\n  if (len >= 0) return;\n"))],
    "state idle on the walk forward": [
        (BWD_FORWARD, "  if (lane >= 0) return;\n" + BWD_FORWARD)],
    "1xTF32": [("  mma(small, al, b0h, b1h);\n  mma(small, ah, b0l, b1l);\n",
                "")],
}
FAULTS = {
    "one tile's intra term left out": (
        A_DOTS,
        "  if (t == 1 && blockIdx.x == 0) return;\n" + A_DOTS),
    "carried state dropped at one tile": (
        STATE_TILE,
        STATE_TILE + "      if (m == 2 && bh == 0)\n"
                     "        for (auto& n : S) for (float& x : n) x = 0.f;\n"),
    "one channel's decay one token too far": (
        R_DEC, "pb[RD_OFF + i * RD_STRIDE + d] = d == 5 ? rv * p * wv "
               ": rv * p;"),
}
CUTS = {
    "loads only": [
        (WAITED, WAITED + "  if (len >= 0) return;\n"),
        (STATE_START, "  if (len >= 0) return;\n" + STATE_START)],
    "no A dot products": [(A_DOTS, "  if (len >= 0) return;\n" + A_DOTS)],
    "no per-channel walks": [(WALKS, "  if (len < 0) {\n" + WALKS[4:])],
    "no state products": [(STATE_PRODUCTS,
                           "  if (len >= 0) return;\n" + STATE_PRODUCTS)],
    "1xTF32": [(SMALL, "")],
}
# The state products on CUDA cores, register-tiled, as a drop-in for
# state_tile: the same ownership of S^T (2 value columns x 16 key channels
# a thread), fp32 FMAs; o^T summed over
# the 4 lanes that share value columns, the intra term split over them by j.
SIMT_STATE = r"""template <typename T>
__device__ __forceinline__ void state_tile(float (&S)[8][4], const float* pb,
                                           float* os, T* og, int len,
                                           int lane, int c0, int st_tid) {
  const int g = lane >> 2, t = lane & 3;
  const float* V = pb + V_OFF;
  const float* RD = pb + RD_OFF;
  const float* KD = pb + KD_OFF;
  const float* A = pb + A_OFF;
  const float* W = pb + W_OFF;
  float p[2][TILE];
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 q = *reinterpret_cast<const float2*>(
          RD + i * RD_STRIDE + 8 * n + 2 * t);
      const float r0 = q.x, r1 = q.y;
      a0 = fmaf(S[n][0], r0, fmaf(S[n][1], r1, a0));
      a1 = fmaf(S[n][2], r0, fmaf(S[n][3], r1, a1));
    }
    p[0][i] = a0;
    p[1][i] = a1;
  }
#pragma unroll
  for (int jq = 0; jq < TILE / 4; ++jq) {
    const int j = 4 * jq + t;
    const float v0 = V[j * V_STRIDE + c0 + g], v1 = V[j * V_STRIDE + c0 + g + 8];
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      const float2 a = *reinterpret_cast<const float2*>(A + i * A_STRIDE + 2 * j);
      const float aij = a.x + a.y;
      p[0][i] = fmaf(v0, aij, p[0][i]);
      p[1][i] = fmaf(v1, aij, p[1][i]);
    }
  }
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    for (int c = 0; c < 2; ++c) {
      p[c][i] += __shfl_xor_sync(0xffffffffu, p[c][i], 1);
      p[c][i] += __shfl_xor_sync(0xffffffffu, p[c][i], 2);
    }
    if ((i & 3) == t) {
      os[i * O_STRIDE + c0 + g] = p[0][i];
      os[i * O_STRIDE + c0 + g + 8] = p[1][i];
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 wv = *reinterpret_cast<const float2*>(W + 8 * n + 2 * t);
    S[n][0] *= wv.x;
    S[n][1] *= wv.y;
    S[n][2] *= wv.x;
    S[n][3] *= wv.y;
  }
#pragma unroll 4
  for (int i = 0; i < TILE; ++i) {
    const float v0 = V[i * V_STRIDE + c0 + g], v1 = V[i * V_STRIDE + c0 + g + 8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 q = *reinterpret_cast<const float2*>(
          KD + i * KD_STRIDE + 8 * n + 2 * t);
      const float k0 = q.x, k1 = q.y;
      S[n][0] = fmaf(v0, k0, S[n][0]);
      S[n][1] = fmaf(v0, k1, S[n][1]);
      S[n][2] = fmaf(v1, k0, S[n][2]);
      S[n][3] = fmaf(v1, k1, S[n][3]);
    }
  }
  state_barrier();
  for (int q = st_tid; q < len * (HD / 4); q += STATE_THREADS) {
    const int i = q >> 4, c = (q & 15) * 4;
    store4(og + i * HD + c, *reinterpret_cast<const float4*>(os + i * O_STRIDE + c));
  }
}

"""
STATE_FN = ("template <typename T>\n__device__ __forceinline__ void "
            "state_tile(")
KERNEL_FN = "template <typename T>\n__global__ void __launch_bounds__"
OLD_CUTS = {
    "C x C loop left out": [
        ("    for (int p = tid; p < C * C; p += THREADS) {",
         "    for (int p = tid; p < 0; p += THREADS) {")],
    "loads only": [
        ("    __syncthreads();\n\n    // Cumulative log decay",
         "    __syncthreads();\n    if (s > 0) continue;\n\n"
         "    // Cumulative log decay")],
}


def source(name: str) -> str:
    """csrc/<name>.cu with its shared header written in place, so that a
    variant compiles on its own and an edit may reach the header's
    functions (the mma3 of the 1xTF32 cuts)."""
    from repro_torch.kernels import build
    header = "scan_tile.cuh"
    src = (build.CSRC / f"{name}.cu").read_text()
    text = (build.CSRC / header).read_text().replace("#pragma once\n", "")
    return src.replace(f'#include "{header}"\n', text)


def simt_state(src: str) -> str:
    """`src` with state_tile replaced by SIMT_STATE."""
    a, b = src.find(STATE_FN), src.find(KERNEL_FN)
    if a < 0 or b < a or src.count(STATE_FN) != 1:
        raise RuntimeError("state_tile not found once before the kernel")
    return src[:a] + SIMT_STATE + src[b:]


def edited(src: str, edits: list, name: str) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant '{name}': its source text is found "
                               f"{src.count(old)} times, not once: {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str, edits: dict, argtypes, tag: str,
             entry: str = "rwkv_scan") -> dict:
    """The C entry point `entry` of each variant {name: [(old, new), ...]}
    of `src`, one nvcc each, in parallel."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, ed in edits.items():
        stem = OUT / f"{tag}_{name.replace(' ', '_').replace(chr(39), '')}"
        stem.with_suffix(".cu").write_text(edited(src, ed, name))
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o",
               str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       stem.with_suffix(".so"))
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the variant '{name}':\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def old_launch(torch, fn, r, k, v, w, u, chunk=None):
    """The earlier kernel's wrapper: (b, H, s, hd) copies, u in fp32,
    chunk 16."""
    from repro_torch.kernels import DTYPE_CODES
    b, s, H, hd = r.shape
    rr, kk, vv, ww = (x.transpose(1, 2).contiguous() for x in (r, k, v, w))
    o = torch.empty((b, H, s, hd), dtype=r.dtype, device=r.device)
    S = torch.empty((b, H, hd, hd), dtype=torch.float32, device=r.device)
    err = fn(rr.data_ptr(), kk.data_ptr(), vv.data_ptr(), ww.data_ptr(),
             u.float().contiguous().data_ptr(), o.data_ptr(), S.data_ptr(),
             b, H, s, hd, chunk or 16, DTYPE_CODES[r.dtype],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old rwkv_scan launch failed: CUDA error {err}")
    return o.transpose(1, 2), S


def faults(torch, cs, kernel) -> None:
    src = source("rwkv_scan")
    fns = {"whole kernel": kernel._function()}
    fns.update(variants(src, {n: [e] for n, e in FAULTS.items()},
                        kernel._function().argtypes, "fault"))
    fns.update(variants(src, {"1xTF32": CUTS["1xTF32"]},
                        kernel._function().argtypes, "check"))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
    cases = cs.rwkv_scan_cases()
    inputs = [cs.scan_inputs(torch, gen, *shape, dtype=dt, decay=decay)
              for shape, _, decay, dt in cases]
    for name, fn in fns.items():
        fails = 0
        for (shape, chunk, decay, dt), x in zip(cases, inputs):
            o, S = kernel.launch(fn, *x, chunk)
            torch.cuda.synchronize()
            ok, err_o, err_s = cs.scan_verdict(torch, x, o, S, decay, dt)
            fails += not ok
            print(f"[faults] {name}, {shape} chunk {chunk} {dt} decay "
                  f"{decay}: max err o {err_o!r}, S {err_s!r}; check "
                  f"{'passes' if ok else 'fails'}")
        print(f"[faults] {name}: fails {fails} of {len(cases)} cases")
        if name == "whole kernel":
            cs.check(fails == 0, "the whole kernel fails a case")
        elif name in FAULTS:
            cs.check(fails > 0, f"the planted fault '{name}' passes every "
                                f"case of check_rwkv_scan")
    del inputs
    torch.cuda.empty_cache()


def bwd_faults(torch, cs, kernel) -> None:
    """The backward's planted faults through check_rwkv_scan_bwd's cases,
    each case on the same inputs for every variant."""
    src = source("rwkv_scan_bwd")
    base = kernel._bwd_function()
    fns = {"whole kernel": base}
    fns.update(variants(src, {n: [e] for n, e in BWD_FAULTS.items()},
                        base.argtypes, "bwd_fault", "rwkv_scan_bwd"))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 15)
    cases = cs.rwkv_scan_bwd_cases()
    fails = dict.fromkeys(fns, 0)
    for n, (shape, decay, dt) in enumerate(cases):
        b, s, H, hd = shape
        x = cs.scan_inputs(torch, gen, *shape, dtype=dt, decay=decay)
        do = torch.randn(shape, generator=gen, device="cuda").to(x[0].dtype)
        dS = torch.randn((b, H, hd, hd), generator=gen, device="cuda") \
            if n % 2 == 0 else None
        want = None
        for name, fn in fns.items():
            got = kernel.bwd_launch(fn, *x, do, dS)
            torch.cuda.synchronize()
            if want is None:
                from repro_torch.kernels.rwkv_scan.ref import \
                    rwkv_scan_bwd_ref
                want = rwkv_scan_bwd_ref(*x, do, dS)
            ok, errs = cs.scan_bwd_verdict(torch, x, got, want, decay, dt)
            fails[name] += not ok
            print(f"[bwd faults] {name}, {shape} {dt} decay {decay} dS "
                  f"{dS is not None}: max err dr dk dv dw du "
                  f"{['%.3g' % e for e in errs]}; check "
                  f"{'passes' if ok else 'fails'}")
            del got
        del x, do, dS, want
    for name, n in fails.items():
        print(f"[bwd faults] {name}: fails {n} of {len(cases)} cases")
    cs.check(fails["whole kernel"] == 0, "the whole backward fails a case")
    for name in BWD_FAULTS:
        cs.check(fails[name] > 0, f"the planted fault '{name}' passes every "
                                  f"case of check_rwkv_scan_bwd")
    torch.cuda.empty_cache()


def bwd_ablation(torch, cs, kernel) -> None:
    """Device ms per microbatch of each cut of the backward, two windows
    each, in turns; then the whole kernel at one and two waves."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    src = source("rwkv_scan_bwd")
    base = kernel._bwd_function()
    fns = {"whole kernel": base}
    fns.update(variants(src, BWD_CUTS, base.argtypes, "bwd_cut",
                        "rwkv_scan_bwd"))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 17)
    shape = cs.train_scan_shape()
    launches = []
    for _ in range(ALL_ARCHS[cs.TRAIN_ARCH].n_layers):
        x = cs.scan_inputs(torch, gen, *shape, decay="model")
        launches.append((*x, torch.randn(shape, generator=gen,
                                         device="cuda"), None))
    times = time_variants(torch, cs, launches, fns, kernel.bwd_launch,
                          cs.RS_BWD_KERNELS)
    for name, ts in times.items():
        print(f"[bwd ablation] {name}: ms per microbatch "
              f"{' / '.join(f'{t:.4f}' for t in ts)}")
    del launches
    b, s, _, hd = shape
    for heads in (33, 40):
        xs = []
        for _ in range(8):
            x = cs.scan_inputs(torch, gen, b, s, heads, hd, decay="model")
            xs.append((*x, torch.randn((b, s, heads, hd), generator=gen,
                                       device="cuda"), None))
        ms = cs.device_ms(lambda: [kernel.rwkv_scan_bwd(*x) for x in xs], 2,
                          cs.RS_BWD_KERNELS) / 8
        print(f"[bwd occupancy] b * H = {b * heads}: {ms!r} ms per launch")
        del xs
    torch.cuda.empty_cache()


def forward_launches(torch, cs) -> list:
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.models.rwkv6 import HEAD_DIM, n_heads
    cfg = ALL_ARCHS["rwkv6-3b"]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
    return [tuple(cs.scan_inputs(torch, gen, cs.PREFILL_B, cs.PREFILL_S,
                                 n_heads(cfg), HEAD_DIM, decay="model"))
            for _ in range(cfg.n_layers)]


def time_variants(torch, cs, launches, fns: dict, run, names) -> dict:
    """Device ms per forward of each variant, two windows each, in turns."""
    times = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for name in order:
        fn = fns[name]
        times[name].append(cs.device_ms(
            lambda: [run(fn, *x) for x in launches], 2, names))
    return times


def ablation(torch, cs, kernel, launches) -> None:
    from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref
    src = source("rwkv_scan")
    fns = {"whole kernel": kernel._function()}
    fns.update(variants(src, CUTS, kernel._function().argtypes, "cut"))
    fns.update(variants(simt_state(src), {"state products on CUDA cores": []},
                        kernel._function().argtypes, "simt"))
    times = time_variants(torch, cs, launches, fns, kernel.launch,
                          cs.RS_KERNELS)
    for name, ts in times.items():
        print(f"[ablation] new kernel, {name}: ms per forward "
              f"{' / '.join(f'{t:.4f}' for t in ts)}")
    x = launches[0]
    ro, rS = rwkv_scan_ref(*x)
    for name in ("whole kernel", "1xTF32", "state products on CUDA cores"):
        o, S = kernel.launch(fns[name], *x)
        print(f"[ablation] {name} at full width, rwkv6's decays: max err o "
              f"{(o - ro).abs().max().item()!r} (max |o| "
              f"{ro.abs().max().item()!r}), S {(S - rS).abs().max().item()!r}")


def occupancy(torch, cs, kernel) -> None:
    """Device ms per launch at b 4 x s 1024 x hd 64 and b * H = 132 (one
    block on every SM of an H100), 160 (rwkv6-3b: 28 SMs hold two) and
    264 (two on every SM), rwkv6's decays, 8 launches on distinct
    inputs: what the SMs that hold two blocks cost."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 14)
    for heads in (33, 40, 66):
        xs = [cs.scan_inputs(torch, gen, cs.PREFILL_B, cs.PREFILL_S, heads,
                             64, decay="model") for _ in range(8)]
        ms = cs.device_ms(lambda: [kernel.launch(kernel._function(), *x)
                                   for x in xs], 2, cs.RS_KERNELS) / 8
        print(f"[occupancy] b * H = {cs.PREFILL_B * heads}: {ms!r} ms per "
              f"launch, {ms / (cs.PREFILL_B * heads) * 1e3!r} us per head")
        del xs
    torch.cuda.empty_cache()


def old_ablation(torch, cs, launches, path: Path) -> None:
    src = path.read_text()
    argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fns = variants(src, {"whole kernel": [], **OLD_CUTS}, argtypes, "old")
    times = time_variants(torch, cs, launches, fns,
                          lambda fn, *x: old_launch(torch, fn, *x),
                          cs.BASELINE_RS_KERNELS)
    for name, ts in times.items():
        print(f"[ablation] earlier kernel, {name}: ms per forward "
              f"{' / '.join(f'{t:.4f}' for t in ts)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path,
                    help="an earlier rwkv_scan.cu with rwkv_scan_kernel's "
                         "C signature, to ablate beside this one")
    ap.add_argument("--bwd", action="store_true",
                    help="only the backward's planted faults")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rwkv_scan_diagnostics: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.rwkv_scan import kernel
    print(f"[card] {cs.card_line()}")
    bwd_faults(torch, cs, kernel)
    bwd_ablation(torch, cs, kernel)
    if args.bwd:
        return 0
    faults(torch, cs, kernel)
    launches = forward_launches(torch, cs)
    ablation(torch, cs, kernel, launches)
    occupancy(torch, cs, kernel)
    if args.old is not None:
        old_ablation(torch, cs, launches, args.old)
    return 0


if __name__ == "__main__":
    sys.exit(main())
