"""Training driver on one card: the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --steps 10                                  # on cuda (the default)
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --reduced --device cpu --steps 3

The reference's flags (less the ones below) plus ``--device``, and its
output: a ``[train] step i loss ...`` line every 5 steps and at the last
one, then, after 10 steps or more, ``[train] loss a -> b (improved)`` (the
means of the first and the last three losses). The loss is built with
``remat=True``, microbatched grads are accumulated in fp32 and AdamW
updates the parameters in place (``repro_torch.train``). Parameters come
from ``torch.Generator(device).manual_seed(seed)``: other numbers than
the reference's ``jax.random`` init, the same structure and scales.

rwkv6's forward runs each layer's recurrence through the ``rwkv_scan``
kernel and its gradient through ``rwkv_scan_bwd`` on the card; the other
families' forwards are plain torch ops, as their prefills are.

Left to the distributed slice, with the port's ``distributed/checkpoint``
and a mesh: ``--mesh`` and the checkpoint flags (``--ckpt-dir``,
``--ckpt-every``, ``--async-ckpt``). As in the reference, whose batches
hold only ``tokens`` and ``labels``, whisper-small and
llama-3.2-vision-90b cannot be trained by this driver: their forward also
reads audio frames or vision embeddings. The driver refuses them.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import reduced
from ..configs.registry_configs import ALL_ARCHS
from ..data.pipeline import make_pipeline
from ..models.registry import get_adapter
from ..train.train_step import TrainState, make_train_step, train_state_init


def build(arch: str, use_reduced: bool, microbatches: int, lr: float):
    """(cfg, adapter, step) for `arch`; the loss recomputes each layer in
    the backward, as the reference's does."""
    cfg = ALL_ARCHS[arch]
    if use_reduced:
        cfg = reduced(cfg)
    adapter = get_adapter(cfg)
    if adapter.extra_inputs:
        raise ValueError(
            f"{arch}: its forward also reads {', '.join(adapter.extra_inputs)}"
            f", which the token pipeline does not make (the reference's "
            f"train driver cannot train it either)")

    def loss_fn(params, batch):
        return adapter.loss(params, batch, remat=True)

    step = make_train_step(loss_fn, microbatches=microbatches, lr=lr)
    return cfg, adapter, step


@dataclass
class TrainRun:
    """What :func:`train` ran: the config, the final state, each step's
    loss and host time (each ends in reading the loss back, so it waits
    for the device)."""
    cfg: object
    state: TrainState
    losses: list = field(default_factory=list)
    step_s: list = field(default_factory=list)


def train(arch: str, *, use_reduced: bool = False, steps: int = 20,
          seq_len: int = 128, global_batch: int = 8, microbatches: int = 2,
          lr: float = 1e-3, seed: int = 0, device="cuda") -> TrainRun:
    """The driver's loop: prints its ``[train]`` lines and returns the
    run."""
    dev = resolve_device(device)
    cfg, adapter, step = build(arch, use_reduced, microbatches, lr)
    pipe = make_pipeline(cfg.vocab, seq_len, global_batch, seed=seed)
    params = adapter.init(torch.Generator(device=dev).manual_seed(seed))
    run = TrainRun(cfg, train_state_init(params))

    t0 = time.time()
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(i).items()}
        ts = time.perf_counter()
        run.state, metrics = step(run.state, batch)
        loss = float(metrics["loss"])
        run.step_s.append(time.perf_counter() - ts)
        run.losses.append(loss)
        if i % 5 == 0 or i == steps - 1:
            print(f"[train] step {i} loss {loss:.4f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)

    if len(run.losses) >= 10:
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    train(args.arch, use_reduced=args.reduced, steps=args.steps,
          seq_len=args.seq_len, global_batch=args.global_batch,
          microbatches=args.microbatches, lr=args.lr, seed=args.seed,
          device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
