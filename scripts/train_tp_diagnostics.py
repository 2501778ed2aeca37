#!/usr/bin/env python3
"""How far fp32 rounding alone moves rwkv6-3b's training gradients at full
width, beside what the tensor-parallel step moves them, on one NVIDIA GPU,
from the root of a checkout:

    python3 scripts/train_tp_diagnostics.py

Two ranks share the card over gloo on a 1x2 mesh, as ``chip_smoke.py
--only train_tp`` runs them. For rwkv6-3b in fp32 at full width cut to 4
and to 2 layers (parameters and the first batch from chip_smoke's seed),
each rank computes the first step's loss and gradients four ways: the
single-process step and the step on its model shards, each on the kernel
path (``rwkv_scan``/``rwkv_scan_bwd``) and on the plain path
(``rwkv_scan_ref`` under autograd). Per leaf and rank it prints max
|diff| over the whole leaf's largest |gradient| and ||diff|| over
||gradient|| (over the rank's part of a split leaf) for: the sharded step
against the single-process step on each path, and the single-process
step's plain path against its kernel path (the same function in fp32,
rounded in other orders). It imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

LAYERS = (4, 2)


def _rank(rank: int, world: int, store: str, tmp: str) -> None:
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_adapter
    from repro_torch.train.optimizer import _leaves
    from repro_torch.train.train_step import accumulate
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    mesh = make_mesh((1, world), ("data", "model"), "cuda")
    out = {}
    for n_layers in LAYERS:
        cfg = dataclasses.replace(cs.train_cfg(), dtype="float32",
                                  n_layers=n_layers)
        ad = get_adapter(cfg)
        params = ad.init(torch.Generator(device="cuda").manual_seed(cs.SEED),
                         tp=world)
        batch = cs._tp_batch(torch, cfg, 0)
        placed = sharding.constrain_like(params, ad.param_specs("data",
                                                                world), mesh)

        def loss_fn(p, b, mesh=None):
            return ad.loss(p, b, remat=True, mesh=mesh)

        got = {}
        for path_name, ctx in (("kernel", contextlib.nullcontext),
                               ("plain", cs.plain_path)):
            with ctx():
                single = accumulate(loss_fn, params, batch, cs.TRAIN_MICRO)
                tp = accumulate(loss_fn, placed, batch, cs.TRAIN_MICRO,
                                shards=True)
            got[path_name] = (float(single[0]), float(tp[0]),
                              dict(_leaves(single[1])), dict(_leaves(tp[1])))
        rows = {}
        for key, p in _leaves(placed):

            def part(t):
                return sharding.local_shard(t, mesh, p.placements)

            def errs(d, ref):
                return ((d.abs().max() / ref.abs().max()).item(),
                        (d.norm() / part(ref).norm()).item())

            sk, tk = got["kernel"][2][key], sharding.local(
                got["kernel"][3][key])
            sp, tpl = got["plain"][2][key], sharding.local(
                got["plain"][3][key])
            rows["/".join(key)] = {
                "tp-single kernel": errs(tk - part(sk), sk),
                "tp-single plain": errs(tpl - part(sp), sp),
                "single plain-kernel": errs(part(sp) - part(sk), sk)}
        out[n_layers] = {"losses": {k: v[:2] for k, v in got.items()},
                         "rows": rows}
        del params, placed, got
        torch.cuda.empty_cache()
    torch.save(out, Path(tmp) / f"rank_{rank}.pt")
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("train_tp_diagnostics: no CUDA card", file=sys.stderr)
        return 2
    print(f"[card] {cs.card_line()}")
    tmp = tempfile.mkdtemp(prefix="train_tp_diag_")
    mp.start_processes(_rank, args=(2, tmp + "/store", tmp), nprocs=2,
                       start_method="spawn")
    for rank in range(2):
        out = torch.load(Path(tmp) / f"rank_{rank}.pt", weights_only=False)
        for n_layers, o in out.items():
            print(f"[diag] rank {rank}, {n_layers} layers: losses (single, "
                  f"tp) {o['losses']}")
            for leaf, row in o["rows"].items():
                print(f"[diag] rank {rank}, {n_layers} layers, {leaf}: "
                      + "; ".join(f"{k} max {m:.3e} norm {n:.3e}"
                                  for k, (m, n) in row.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
