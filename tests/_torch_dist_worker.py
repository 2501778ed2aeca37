"""Worker processes for tests/test_torch_distributed.py. Each joins a gloo
process group through a ``FileStore`` (a file, no network), runs one job
of the port on a mesh and, on rank 0, saves what the test compares. No
JAX here: the workers import only the port."""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import reduced
from repro_torch.configs.registry_configs import ALL_ARCHS
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharding
from repro_torch.distributed.elastic import elastic_resume
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import get_adapter
from repro_torch.train import optimizer
from repro_torch.train.optimizer import _leaves, adamw_init, adamw_update
from repro_torch.train.train_step import (accumulate, state_specs,
                                          train_state_init)

# The driver's runs: the reference driver's batch at a short sequence, 8
# rows in 2 microbatches, each split over up to 2 data ranks.
SEQ, BATCH, MICRO, STEPS = 16, 8, 2, 3


def fp32_cfg(arch):
    return reduced(ALL_ARCHS[arch], dtype="float32")


def _full_np(tree) -> dict:
    """Each leaf gathered whole as numpy, bf16 as its int16 bits."""
    out = {}
    for p, t in _leaves(tree):
        t = sharding.gather(t)
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        out["/".join(p)] = t.numpy().copy()
    return out


def _split_leaves(leaves) -> int:
    return sum(any(isinstance(p, sharding.Shard) for p in t.placements)
               for t in leaves if isinstance(t, sharding.DTensor))


def meshes(inputs_path, mesh_texts, archs):
    """For each mesh: each arch's first step (loss and the fp32 mean
    gradient, gathered whole) from the bridged parameters placed as the
    driver places them, the driver's mesh axes and TP, the number of
    parameter leaves split over some mesh axis, and the driver's losses
    over STEPS steps from its own seeded init."""
    inputs = torch.load(inputs_path, weights_only=False)
    out = {}
    for text in mesh_texts:
        res = out[text] = {}
        for arch in archs:
            _, ad, mesh, _, tp = port_train.build(
                fp32_cfg(arch), False, MICRO, 1e-3,
                port_train.parse_mesh(text), "cpu")
            params, batch = inputs[arch]
            placed = sharding.constrain_like(
                params, ad.param_specs("data", tp), mesh)
            split = _split_leaves(t for _, t in _leaves(placed))
            loss, grads = accumulate(
                lambda p, b: ad.loss(p, b, remat=True), placed,
                {k: torch.from_numpy(v) for k, v in batch.items()}, MICRO)
            run = port_train.train(fp32_cfg(arch), steps=STEPS, seq_len=SEQ,
                                   global_batch=BATCH, microbatches=MICRO,
                                   device="cpu", mesh=text)
            res[arch] = {"loss": float(loss), "grads": _full_np(grads),
                         "split_leaves": split, "losses": run.losses,
                         "axes": mesh.mesh_dim_names, "tp": tp}
    return out


def adamw_2x2(inputs_path):
    """adamw_update over 3 steps on the 2x2 mesh's local shards, leaves
    updated UPDATE_ELEMS = 7 elements at a time; the parameters and
    moments gathered whole."""
    optimizer.UPDATE_ELEMS = 7
    tree, specs, grads = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    params = sharding.constrain_like(tree, specs, mesh)
    state = adamw_init(params)
    for g in grads:
        params, state = adamw_update(
            params, sharding.constrain_like(g, specs, mesh), state, lr=1e-2)
    return {"params": _full_np(params), "mu": _full_np(state.mu),
            "nu": _full_np(state.nu), "step": int(state.step)}


def save_2x2(ckpt_dir, witness_path):
    """Reduced bf16 rwkv6-3b trained one step on a 2x2 mesh and saved;
    rank 0 also keeps the state gathered whole (torch.save, apart from
    the checkpoint code)."""
    run = port_train.train("rwkv6-3b", use_reduced=True, steps=1,
                           seq_len=SEQ, global_batch=BATCH, device="cpu",
                           mesh="2x2", ckpt_dir=ckpt_dir, ckpt_every=1)
    leaves = [sharding.gather(t) for t in ckpt._flatten(run.state)]
    if dist.get_rank() == 0:
        torch.save(leaves, witness_path)
    return {"split_leaves": _split_leaves(ckpt._flatten(run.state))}


def resume(ckpt_dir, witness_path, n_devices):
    """The checkpoint restored into plain tensors, then resharded by
    elastic_resume onto n_devices ranks: each leaf gathered whole against
    the witness, bit for bit, and the new mesh's shape."""
    ad = get_adapter(reduced(ALL_ARCHS["rwkv6-3b"]))
    state = train_state_init(ad.init(torch.Generator().manual_seed(9)))
    ckpt.restore(ckpt_dir, ckpt.latest_step(ckpt_dir), state)
    specs = state_specs(ad.param_specs("data", 16))
    state, mesh = elastic_resume(state, specs, n_devices, device="cpu")
    witness = torch.load(witness_path, weights_only=False)
    leaves = ckpt._flatten(state)
    equal = [torch.equal(sharding.gather(t).view(torch.int16)
                         if t.dtype == torch.bfloat16 else sharding.gather(t),
                         w.view(torch.int16) if w.dtype == torch.bfloat16
                         else w)
             for t, w in zip(leaves, witness)]
    return {"mesh": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "n": len(leaves), "n_witness": len(witness),
            "equal": all(equal), "split_leaves": _split_leaves(leaves)}


JOBS = {"meshes": meshes, "adamw_2x2": adamw_2x2, "save_2x2": save_2x2,
        "resume": resume}


def _main(rank, world, store_path, out_path, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        out = {name: JOBS[name](*args) for name, args in jobs}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def spawn(world: int, tmp_dir: str, jobs: list) -> dict:
    """Run each (job name, args) of `jobs` in turn on `world` spawned
    ranks of one process group; rank 0's results by job name."""
    store = os.path.join(tmp_dir, f"world{world}.store")
    out = os.path.join(tmp_dir, f"world{world}.pt")
    mp.start_processes(_main, args=(world, store, out, jobs), nprocs=world,
                       start_method="spawn")
    return torch.load(out, weights_only=False)

