#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU, from the root of a checkout:

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/csrc`` with nvcc and prints the build time.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes of qwen2-7b's decode step and at odd ones, with the tolerances of
   tests/test_kernels.py.
3. Serves qwen2-7b at full width in bf16 with random weights from a seed,
   through ``repro_torch.launch.serve`` with the driver's defaults (12
   requests, 4 slots, prompt 16, 24 new tokens, max_seq 128), and shows
   through the launch counters that every step went through both kernels.
   One decode step's logits on the kernel path are held against the same
   step with both kernels' plain versions; the plain path also serves the
   same requests, to count the greedy tokens that agree.
4. Times each kernel, its plain version and one library call (a yardstick
   only; the port never calls it) over the kernel's launches of one decode
   step: the kernel's wall time on the device's clock from CUDA events,
   then device times from torch.profiler, and a profiled run of a few
   steps that splits a step's device time by kernel.
5. Prints a ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without a CUDA card, or a directory without the
repo's ``src/``. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# Logits of one bf16 decode step, kernel path against plain path: the
# repo's bf16 decode tolerance (tests/test_models_smoke.py, decode against
# forward). The two paths round to bf16 at the same places and differ only
# in the order of fp32 sums.
LOGITS_ATOL = 0.15
SEED = 0
# Device kernels of each port kernel, by name (csrc/*.cu).
FD_KERNELS = ("flash_decode_split", "flash_decode_combine")
RM_KERNELS = ("rowstream_kernel", "splitk_reduce")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Wall time of one call of `fn` on the device's clock: CUDA events
    around `reps` calls after one warm-up call. Where the host launches
    more slowly than the device runs, this includes the device's idle
    gaps; :func:`device_ms` does not."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(prof, names=None) -> float:
    """Self device time of the GPU kernels a profile recorded, all of
    them or those whose name contains one of `names`."""
    import torch
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if names is None or any(n in e.key for n in names):
            total += e.self_device_time_total
    return total


def device_ms(fn, reps: int, names=None) -> float:
    """Device time of one call of `fn`: the kernels' own time from
    torch.profiler (CUPTI) over `reps` calls after a warm-up call, gaps
    between kernels left out. `names` picks kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = _device_us(prof, names)
    check(us > 0, f"the profiler recorded no device time for {names}")
    return us / reps / 1e3


def bound(bytes_moved: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_path():
    """Route the model's products and attention to the plain versions for
    the duration (a comparison only; the port itself never does this)."""
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.rowstream_matmul.ref import rowstream_matmul_ref
    from repro_torch.models import layers
    saved = layers.flash_decode, layers.rowstream_matmul
    layers.flash_decode = flash_decode_ref
    layers.rowstream_matmul = rowstream_matmul_ref
    try:
        yield
    finally:
        layers.flash_decode, layers.rowstream_matmul = saved


# --- phase 2: kernels against their plain versions ---------------------------

def check_rowstream(torch, dev) -> float:
    """Returns the largest error at the decode path's shapes."""
    from repro_torch.kernels.rowstream_matmul.ops import rowstream_matmul
    from repro_torch.kernels.rowstream_matmul.ref import rowstream_matmul_ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    path = [(4, 3584, 3584), (4, 3584, 512), (4, 3584, 18944),
            (4, 18944, 3584), (4, 3584, 152064)]
    odd = [(m, k, n) for m in (1, 4, 33)
           for k, n in ((1000, 1000), (100, 37), (777, 4100), (64, 2056))]
    cases = [(s, "bfloat16") for s in path + odd] \
        + [(s, "float32") for s in path[:2] + odd]
    worst_path = 0.0
    for (m, k, n), dt in cases:
        dtype = getattr(torch, dt)
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(dtype)
        out = rowstream_matmul(x, w)
        torch.cuda.synchronize()
        ref = rowstream_matmul_ref(x, w)
        tol = 2e-2 if dt == "bfloat16" else 1e-5
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= tol * 8 + tol * ref.float().abs()).all())
        check(ok and out.dtype == dtype and out.shape == (m, n),
              f"rowstream_matmul {dt} ({m},{k})@({k},{n}): max err "
              f"{err.max().item()}")
        if (m, k, n) in path and dt == "bfloat16":
            worst_path = max(worst_path, err.max().item())
    print(f"[kernels] rowstream_matmul: {len(cases)} shapes agree with the "
          f"plain version (bf16 rtol 2e-2 atol 0.16, fp32 rtol 1e-5 atol "
          f"8e-5); max abs err at the path's shapes {worst_path!r}")
    return worst_path


def check_flash_decode(torch, dev) -> float:
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = [(4, 28, 4, 128, 128, p, "bfloat16", "bfloat16")
             for p in (0, 63, 127)]
    n_path = len(cases)
    # g * d = 4096, the widest group the wrapper takes: over 48 KB of
    # shared memory, which the kernel opts into.
    cases += [(1, 32, 2, 300, 256, 150, qt, kt) for qt, kt in
              (("bfloat16", "bfloat16"), ("float32", "float32"))]
    for g in (1, 7, 8):
        for d in (64, 80, 128):
            for S, pos in ((200, 0), (200, 99), (200, 199), (200, 450),
                           (4096, 2047), (4096, 4095)):
                for qt, kt in (("bfloat16", "bfloat16"),
                               ("float32", "bfloat16"),
                               ("float32", "float32")):
                    cases.append((2, 2 * g, 2, S, d, pos, qt, kt))
    worst_path = 0.0
    for i, (b, h, hkv, S, d, pos, qt, kt) in enumerate(cases):
        q = torch.randn((b, h, d), generator=gen, device=dev).to(
            getattr(torch, qt))
        kc, vc = (torch.randn((b, hkv, S, d), generator=gen,
                              device=dev).to(getattr(torch, kt))
                  for _ in range(2))
        out = flash_decode(q, kc, vc, pos)
        torch.cuda.synchronize()
        ref = flash_decode_ref(q, kc, vc, pos)
        tol = 3e-2 if kt == "bfloat16" and qt == "bfloat16" else 1e-5
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= tol + tol * ref.float().abs()).all())
        check(ok and out.dtype == q.dtype and out.shape == q.shape,
              f"flash_decode q {qt} kv {kt} b{b} h{h} hkv{hkv} S{S} d{d} "
              f"pos{pos}: max err {err.max().item()}")
        if i < n_path:
            worst_path = max(worst_path, err.max().item())
    # Slots after pos must not leak, whatever they hold.
    q = torch.randn((4, 28, 128), generator=gen, device=dev)
    kc, vc = (torch.randn((4, 4, 128, 128), generator=gen, device=dev)
              for _ in range(2))
    out1 = flash_decode(q, kc, vc, 10)
    kc[:, :, 11:] = 1e9
    vc[:, :, 11:] = -1e9
    out2 = flash_decode(q, kc, vc, 10)
    check(torch.allclose(out1, out2, rtol=1e-6, atol=0),
          "flash_decode: slots after pos leak into the output")
    print(f"[kernels] flash_decode: {len(cases) + 2} cases agree with the "
          f"plain version (bf16 3e-2, fp32 1e-5), future slots masked; max "
          f"abs err at the path's shape {worst_path!r}")
    return worst_path


# --- timing over one decode step's launches ----------------------------------

def rowstream_work(torch, cfg, params, slots: int) -> dict:
    """The 197 products of one qwen2-7b decode step, in step order, each
    layer's own weights (so every weight is cold in L2, as in the step):
    on the kernel, on the plain version and on torch.matmul."""
    from repro_torch.kernels.rowstream_matmul.ops import rowstream_matmul
    from repro_torch.kernels.rowstream_matmul.ref import rowstream_matmul_ref
    dev = params["embed"].device
    blocks = params["blocks"]
    names = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
             ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]
    ws = [blocks[a][w][i] for i in range(cfg.n_layers) for a, w in names]
    ws.append(params["lm_head"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    xs = {k: torch.randn((slots, k), generator=gen, device=dev).to(
        torch.bfloat16) for k in {w.shape[0] for w in ws}}
    pairs = [(xs[w.shape[0]], w) for w in ws]

    def run(fn):
        return lambda: [fn(x, w) for x, w in pairs]

    nbytes = sum(2 * (x.numel() + w.numel() + x.shape[0] * w.shape[1])
                 for x, w in pairs)
    ops = sum(2 * x.shape[0] * w.numel() for x, w in pairs)
    bound_ms, bound_by = bound(nbytes, ops, "bfloat16")
    return {"launches_per_step": len(pairs), "names": RM_KERNELS,
            "reps": 5, "kernel": run(rowstream_matmul),
            "plain": run(rowstream_matmul_ref), "library": run(torch.matmul),
            "bound_ms": bound_ms, "bound_by": bound_by}


def flash_work(torch, cfg, slots: int, max_seq: int) -> dict:
    """28 launches (one per layer, each its own cache) at the serve
    shape, with every slot valid (pos = max_seq - 1): on the kernel, on
    the plain version and on scaled_dot_product_attention with the KV
    heads expanded beforehand."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    dev = torch.device("cuda")
    L, h, hkv, d = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    q = torch.randn((L, slots, h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kc, vc = (torch.randn((L, slots, hkv, max_seq, d), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    pos = max_seq - 1
    g = h // hkv
    kx = [kc[i].repeat_interleave(g, dim=1) for i in range(L)]
    vx = [vc[i].repeat_interleave(g, dim=1) for i in range(L)]
    q4 = q[:, :, :, None, :]

    def run(fn):
        return lambda: [fn(q[i], kc[i], vc[i], pos) for i in range(L)]

    def library():
        return [F.scaled_dot_product_attention(q4[i], kx[i], vx[i])
                for i in range(L)]

    n_valid = pos + 1
    nbytes = L * 2 * (2 * slots * h * d + 2 * slots * hkv * n_valid * d)
    ops = L * 4 * slots * h * n_valid * d
    bound_ms, bound_by = bound(nbytes, ops, "bfloat16")
    return {"launches_per_step": L, "names": FD_KERNELS, "reps": 20,
            "kernel": run(flash_decode), "plain": run(flash_decode_ref),
            "library": library, "bound_ms": bound_ms, "bound_by": bound_by}


# --- phase 3: serve ------------------------------------------------------------

def serve_phase(torch, cfg, params, slots, max_seq, n_requests, prompt_len,
                max_new) -> dict:
    from repro_torch.kernels import launch_counters, reset_launch_counters
    from repro_torch.launch.serve import make_requests, serve
    requests = make_requests(n_requests, prompt_len, max_new, cfg.vocab,
                             SEED)
    reset_launch_counters()
    run = serve(cfg, params, requests, slots, max_seq, "cuda")
    counts = {name: c.count for name, c in launch_counters().items()}
    b = run.batcher
    check(len(b.completed) == n_requests,
          f"serve answered {len(b.completed)} of {n_requests} requests")
    V = params["lm_head"].shape[1]
    for req in b.completed:
        check(len(req.out_tokens) == max_new
              and all(0 <= t < V for t in req.out_tokens),
              f"request {req.rid}: tokens {req.out_tokens}")
    check(counts["flash_decode"] == cfg.n_layers * b.steps,
          f"flash_decode launched {counts['flash_decode']} times in "
          f"{b.steps} steps")
    check(counts["rowstream_matmul"] == (7 * cfg.n_layers + 1) * b.steps,
          f"rowstream_matmul launched {counts['rowstream_matmul']} times in "
          f"{b.steps} steps")
    generated = sum(len(r.out_tokens) for r in b.completed)
    warm = sorted(run.step_seconds[1:])
    return {"run": run, "counts": counts, "steps": b.steps,
            "generated": generated,
            "tokens_per_s": generated / run.seconds,
            "first_step_ms": run.step_seconds[0] * 1e3,
            "median_step_ms": warm[len(warm) // 2] * 1e3,
            "mean_step_ms": sum(warm) / len(warm) * 1e3,
            "tokens": {r.rid: r.out_tokens for r in b.completed}}


def logits_phase(torch, cfg, params, requests_tokens, slots, max_seq):
    """Feed 8 steps on the kernel path, then run step 8 from copies of the
    same cache on the kernel path and on the plain path."""
    from repro_torch.launch.serve import greedy_sample
    from repro_torch.models.registry import get_adapter
    ad = get_adapter(cfg)
    cache = ad.init_decode_state(slots, max_seq, device="cuda")
    tok = torch.tensor([[t[0]] for t in requests_tokens[:slots]],
                       dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        for pos in range(8):
            logits, cache = ad.decode(params, {"tokens": tok}, cache, pos)
            tok = greedy_sample(logits)[:, None]
        plain_cache = {k: v.clone() for k, v in cache.items()}
        lk, _ = ad.decode(params, {"tokens": tok}, cache, 8)
        with plain_path():
            lp, _ = ad.decode(params, {"tokens": tok}, plain_cache, 8)
    torch.cuda.synchronize()
    V = params["lm_head"].shape[1]
    check(tuple(lk.shape) == (slots, 1, V) and bool(lk.isfinite().all()),
          f"kernel-path logits {tuple(lk.shape)} not finite")
    diff = (lk.float() - lp.float()).abs().max().item()
    scale = lp.float().abs().max().item()
    check(diff <= LOGITS_ATOL,
          f"kernel-path logits differ from the plain path by {diff} "
          f"(> {LOGITS_ATOL})")
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum().item())
    print(f"[logits] step at pos 8, {slots} slots: max |kernel - plain| = "
          f"{diff!r} (tolerance {LOGITS_ATOL}; max |logit| {scale!r}); "
          f"greedy argmax agrees in {agree}/{slots} slots")
    return diff


def step_breakdown(torch, cfg, params, slots, max_seq, steps=5) -> dict:
    """Device time of one decode step (after the first few), by kernel
    group, from torch.profiler over `steps` steps that each end with the
    sampled tokens on the host."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import greedy_sample
    from repro_torch.models.registry import get_adapter
    ad = get_adapter(cfg)
    cache = ad.init_decode_state(slots, max_seq, device="cuda")
    tok = torch.ones((slots, 1), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        for pos in range(2):
            ad.decode(params, {"tokens": tok}, cache, pos)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for pos in range(2, 2 + steps):
                logits, cache = ad.decode(params, {"tokens": tok}, cache,
                                          pos)
                greedy_sample(logits).cpu()
    total = _device_us(prof) / steps / 1e3
    check(total > 0, "the profiler recorded no device time for the step")
    rm = _device_us(prof, RM_KERNELS) / steps / 1e3
    reduce = _device_us(prof, ("splitk_reduce",)) / steps / 1e3
    fd = _device_us(prof, FD_KERNELS) / steps / 1e3
    return {"device_ms": total, "rowstream_ms": rm, "reduce_ms": reduce,
            "flash_ms": fd, "other_ms": total - rm - fd}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_adapter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(build.KERNELS)} kernels, nvcc in parallel: "
          f"{build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    fd_err = check_flash_decode(torch, dev)
    rm_err = check_rowstream(torch, dev)

    slots, max_seq, n_req, prompt_len, max_new = 4, 128, 12, 16, 24
    cfg = ALL_ARCHS["qwen2-7b"]
    t0 = time.perf_counter()
    params = get_adapter(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size()
                  for t in _tensors(params))
    print(f"[init] qwen2-7b full width, bf16, {n_bytes / 1e9:.2f} GB of "
          f"weights in {time.perf_counter() - t0:.1f} s")

    # Everything timed on the host clock or with CUDA events comes before
    # the first use of the profiler: its hooks stay behind and slow later
    # launches from the host.
    sv = serve_phase(torch, cfg, params, slots, max_seq, n_req, prompt_len,
                     max_new)
    print(f"[serve] qwen2-7b bf16: {n_req} requests, {sv['steps']} steps, "
          f"{sv['generated']} tokens, {sv['tokens_per_s']!r} tok/s; step "
          f"median {sv['median_step_ms']!r} ms, mean {sv['mean_step_ms']!r} "
          f"ms, first {sv['first_step_ms']!r} ms; launches "
          f"{sv['counts']} ({sv['counts']['flash_decode'] // sv['steps']} "
          f"and {sv['counts']['rowstream_matmul'] // sv['steps']} per step)")

    prompts = [r.prompt for r in sorted(sv["run"].batcher.completed,
                                        key=lambda r: r.rid)]
    logits_phase(torch, cfg, params, prompts, slots, max_seq)

    # The same requests on the plain path: greedy tokens that agree.
    from repro_torch.launch.serve import make_requests, serve
    with plain_path():
        plain = serve(cfg, params, make_requests(n_req, prompt_len, max_new,
                                                 cfg.vocab, SEED),
                      slots, max_seq, "cuda")
    agree = sum(a == b for r in plain.batcher.completed
                for a, b in zip(r.out_tokens, sv["tokens"][r.rid]))
    print(f"[serve] plain path: {agree}/{sv['generated']} greedy tokens "
          f"agree with the kernel path, position by position")

    works = {"flash_decode": flash_work(torch, cfg, slots, max_seq),
             "rowstream_matmul": rowstream_work(torch, cfg, params, slots)}
    for w in works.values():
        w["wall_ms"] = timed_ms(w["kernel"], w["reps"])
    for name, w in works.items():
        w["ms"] = device_ms(w["kernel"], w["reps"], w["names"])
        w["plain_ms"] = device_ms(w["plain"], w["reps"])
        w["library_ms"] = device_ms(w["library"], w["reps"])
        print(f"[time] {name}, {w['launches_per_step']} launches of one "
              f"decode step, device time: kernel {w['ms']!r} ms (wall "
              f"{w['wall_ms']!r} ms), plain {w['plain_ms']!r} ms, library "
              f"{w['library_ms']!r} ms, bound {w['bound_ms']!r} ms "
              f"({w['bound_by']})")

    bd = step_breakdown(torch, cfg, params, slots, max_seq)
    print(f"[profile] decode step device time {bd['device_ms']!r} ms: "
          f"rowstream_matmul {bd['rowstream_ms']!r} (of which split-K "
          f"reduce {bd['reduce_ms']!r}), flash_decode "
          f"{bd['flash_ms']!r}, other torch kernels {bd['other_ms']!r}; "
          f"device idle share at the median step "
          f"{1 - bd['device_ms'] / sv['median_step_ms']!r}")

    kernels = []
    for name, err, line in (
            ("flash_decode", fd_err,
             "src/repro/kernels/flash_decode/kernel.py:74"),
            ("rowstream_matmul", rm_err,
             "src/repro/kernels/rowstream_matmul/kernel.py:49")):
        t = works[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": line,
            "launches": sv["counts"][name], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "wall_ms": t["wall_ms"],
            "per": f"one qwen2-7b decode step at {slots} slots: "
                   f"{t['launches_per_step']} launches"})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
