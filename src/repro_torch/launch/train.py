"""Training driver: the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --steps 10                                  # on cuda (the default)
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --reduced --device cpu --steps 6 --ckpt-dir /tmp/ckpt \
        --ckpt-every 3 --async-ckpt

The reference's flags plus ``--device``, and its output: a ``[train] step
i loss ...`` line every 5 steps and at the last one, ``[train] resumed
from step k`` when it resumed, then, after 10 steps or more, ``[train]
loss a -> b (improved)`` (the means of the first and the last three
losses). The loss is built with ``remat=True``, microbatched grads are
accumulated in fp32 and AdamW updates the parameters in place
(``repro_torch.train``). Parameters come from
``torch.Generator(device).manual_seed(seed)``: other numbers than the
reference's ``jax.random`` init, the same structure and scales, the query
heads padded to a multiple of TP (the mesh's last dim).

``--mesh DATAxMODEL`` (default 1x1) lays the state out on a named-axis
mesh: parameters and AdamW moments as DTensors under the family's
``param_specs`` with ZeRO over ``data`` (``fsdp="data"``) and
tensor-parallel storage over ``model`` (``train/train_step.py``). On a
``model`` axis of several ranks the dense and MoE families and rwkv6
compute on each rank's shards (the MoE's experts, or each expert's FFN
width, split over the ranks), their gathers over ``data`` only; the other
families, and shapes the axis does not divide, gather every parameter
whole. Rank 0 prints which (``[train] ...`` from
``models.registry.train_tp_path``). Where ``data`` holds several ranks
the MoE family's routing groups span their rows, as the reference's span
the whole microbatch.
As in the reference, ``--mesh 4`` gives the
axes ``("data",)`` with TP 4. The mesh covers the process group
(``launch/mesh.py``): a 2x2 mesh runs on 4 ranks, each running this
driver with the whole global batch. On ``cuda`` a mesh holds one card:
the multi-rank path is checked on the CPU over gloo. ``--ckpt-dir``
resumes from its latest complete step k at step k + 1 and saves every
``--ckpt-every`` steps (after step i when i + 1 divides), in the
reference's format (``distributed/checkpoint.py``); ``--async-ckpt``
writes each save on a worker thread.

rwkv6's forward runs each layer's recurrence through the ``rwkv_scan``
kernel and its gradient through ``rwkv_scan_bwd`` on the card; the other
families' forwards are plain torch ops, as their prefills are. As in the
reference, whose batches hold only ``tokens`` and ``labels``,
whisper-small and llama-3.2-vision-90b cannot be trained by this driver:
their forward also reads audio frames or vision embeddings. The driver
refuses them.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..configs.base import ArchConfig, reduced
from ..configs.registry_configs import ALL_ARCHS
from ..data.pipeline import make_pipeline
from ..distributed import checkpoint as ckpt
from ..distributed.sharding import (constrain_like, local_tree, model_size,
                                    use_mesh)
from ..models.registry import get_adapter, train_tp_path
from ..train.train_step import TrainState, make_train_step, train_state_init
from .mesh import driver_mesh, make_mesh, parse_mesh, process_group_scope


def build(arch, use_reduced: bool, microbatches: int, lr: float,
          mesh_shape: tuple = (1, 1), device="cuda"):
    """(cfg, adapter, mesh, step, tp) for `arch` (a name or an
    ArchConfig) on a mesh of `mesh_shape`; the loss recomputes each layer
    in the backward, as the reference's does, and the step keeps the
    state under the family's ``param_specs(fsdp="data", tp)``."""
    cfg = arch if isinstance(arch, ArchConfig) else ALL_ARCHS[arch]
    if use_reduced:
        cfg = reduced(cfg)
    adapter = get_adapter(cfg)
    if adapter.extra_inputs:
        raise ValueError(
            f"{cfg.name}: its forward also reads "
            f"{', '.join(adapter.extra_inputs)}, which the token pipeline "
            f"does not make (the reference's train driver cannot train it "
            f"either)")
    dev = resolve_device(device)
    axes, tp = driver_mesh(mesh_shape, dev)
    mesh = make_mesh(mesh_shape, axes, dev)
    step = make_step(adapter, mesh, tp, microbatches, lr)
    return cfg, adapter, mesh, step, tp


def make_step(adapter, mesh, tp: int, microbatches: int, lr: float):
    """The driver's train step for `adapter` on `mesh` (parameters from
    ``init(tp)``): the loss recomputes each layer in the backward and
    takes the mesh where the family computes on ``model`` shards
    (``train_tp_path``), and the state stays under
    ``param_specs(fsdp="data", tp)``. On a ``model`` axis of several ranks
    rank 0 prints the path taken."""
    model = model_size(mesh)
    shards, why = train_tp_path(adapter.cfg, model)
    if model > 1 and _first_rank():
        print(f"[train] {why}", flush=True)

    def loss_fn(params, batch, mesh=None):
        return adapter.loss(params, batch, remat=True, mesh=mesh)

    return make_train_step(loss_fn, microbatches=microbatches, lr=lr,
                           param_specs=adapter.param_specs("data", tp),
                           shards=shards)


def init_state(adapter, mesh, tp: int, seed: int, device) -> TrainState:
    """Parameters from `seed` (the same on every rank), their query heads
    padded to a multiple of `tp`, placed on `mesh` under the family's
    ``param_specs(fsdp="data", tp)``, and AdamW's zero moments placed
    alike."""
    dev = resolve_device(device)
    params = adapter.init(torch.Generator(device=dev).manual_seed(seed),
                          tp=tp)
    return train_state_init(constrain_like(
        params, adapter.param_specs("data", tp), mesh))


def _first_rank() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclass
class TrainRun:
    """What :func:`train` ran: the config, the mesh, the final state, each
    step's loss and host time (each ends in reading the loss back, so it
    waits for the device); with ``ckpt_dir``, the step it started from,
    the seconds its restore took (None when it started afresh) and one
    record per save (``distributed.checkpoint.AsyncCheckpointer.saves``;
    a synchronous save's ``block_s`` is its whole time)."""
    cfg: object
    mesh: object
    state: TrainState
    losses: list = field(default_factory=list)
    step_s: list = field(default_factory=list)
    start_step: int = 0
    restore_s: float | None = None
    saves: list = field(default_factory=list)


def train(arch, *, use_reduced: bool = False, steps: int = 20,
          seq_len: int = 128, global_batch: int = 8, microbatches: int = 2,
          lr: float = 1e-3, seed: int = 0, device="cuda", mesh="1x1",
          ckpt_dir: str | None = None, ckpt_every: int = 10,
          async_ckpt: bool = False) -> TrainRun:
    """The driver's loop: prints its ``[train]`` lines (on rank 0) and
    returns the run. `arch` is a name or an ArchConfig. A process group
    it had to create (one process, no launcher) is destroyed when it
    returns, and the run's state is then plain tensors (the 1-rank
    mesh's local shards are whole); a group that existed is left as it
    was, and the state as DTensors on it."""
    dev = resolve_device(device)
    with process_group_scope() as own_group:
        cfg, adapter, dmesh, step, tp = build(
            arch, use_reduced, microbatches, lr, parse_mesh(mesh), dev)
        pipe = make_pipeline(cfg.vocab, seq_len, global_batch, seed=seed)
        loud = _first_rank()

        with use_mesh(dmesh):
            run = TrainRun(cfg, dmesh, init_state(adapter, dmesh, tp, seed,
                                                  dev))
            if ckpt_dir:
                latest = ckpt.latest_step(ckpt_dir)
                if latest is not None:
                    t = time.perf_counter()
                    ckpt.restore(ckpt_dir, latest, run.state)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    run.restore_s = time.perf_counter() - t
                    run.start_step = latest + 1
                    if loud:
                        print(f"[train] resumed from step {latest}")
            saver = ckpt.AsyncCheckpointer() if async_ckpt else None

            t0 = time.time()
            end = run.start_step + steps - 1
            for i in range(run.start_step, end + 1):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in pipe.batch_at(i).items()}
                ts = time.perf_counter()
                run.state, metrics = step(run.state, batch)
                loss = float(metrics["loss"])
                run.step_s.append(time.perf_counter() - ts)
                run.losses.append(loss)
                if loud and (i % 5 == 0 or i == end):
                    print(f"[train] step {i} loss {loss:.4f} "
                          f"({(time.time()-t0):.1f}s)", flush=True)
                if ckpt_dir and (i + 1) % ckpt_every == 0:
                    if saver:
                        saver.save(ckpt_dir, i, run.state)
                    else:
                        t = time.perf_counter()
                        ckpt.save(ckpt_dir, i, run.state)
                        run.saves.append({"step": i,
                                          "block_s": time.perf_counter() - t})
            if saver:
                saver.close()
                run.saves = saver.saves
        if own_group:
            run.state = local_tree(run.state)

    if loud and len(run.losses) >= 10:
        first = np.mean(run.losses[:3])
        last = np.mean(run.losses[-3:])
        print(f"[train] loss {first:.3f} -> {last:.3f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=sorted(ALL_ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL (or one number: data, with that TP); "
                         "its size is the number of ranks")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    train(args.arch, use_reduced=args.reduced, steps=args.steps,
          seq_len=args.seq_len, global_batch=args.global_batch,
          microbatches=args.microbatches, lr=args.lr, seed=args.seed,
          device=args.device, mesh=args.mesh, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every, async_ckpt=args.async_ckpt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
