"""Mesh construction on ``torch.distributed``: the counterpart of
``repro.launch.mesh``.

``make_mesh(shape, axes, device)`` joins the default process group
(creating it on first use) and returns a ``DeviceMesh`` with named axes.
The group's backend follows the device: NCCL for ``cuda``, gloo for the
CPU; a failing NCCL group raises and nothing falls back to gloo. A
launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, as ``torchrun`` sets them) makes a group of its ranks;
without one the group is this process alone (a ``HashStore``, world size
1). Callers that start ranks themselves create the group first (for
example with a ``FileStore``) and then call ``make_mesh``. A mesh must
cover the group: a size other than the world size raises.

The reference's ``make_production_mesh`` (a TPU pod's 16x16 and 2x16x16)
goes with the launch tooling and is not here.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from .. import resolve_device

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_process_group(device="cuda") -> None:
    """Create the default process group for `device` unless one exists:
    from a launcher's environment when it is set, else this process alone.
    On ``cuda`` the group runs one all-reduce at once, so that a failing
    NCCL raises here."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    backend = backend_for(dev.type)
    if all(k in os.environ for k in _LAUNCHER_ENV):
        rank = int(os.environ["RANK"])
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method="env://")
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dev.type == "cuda":
        probe = torch.ones(1, device="cuda")
        dist.all_reduce(probe)
        if probe.item() != dist.get_world_size():
            raise RuntimeError(f"NCCL all-reduce of ones over "
                               f"{dist.get_world_size()} ranks gave "
                               f"{probe.item()}")


@contextlib.contextmanager
def process_group_scope():
    """Destroy, on leaving the block, the default process group if the
    block created it (its NCCL communicator and threads go with it).
    Yields whether it will: True when no group existed on entry."""
    existed = dist.is_initialized()
    try:
        yield not existed
    finally:
        if not existed and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(shape: tuple, axes: tuple, device="cuda"):
    """A DeviceMesh of `shape` with axis names `axes` over the default
    process group, which must hold prod(shape) ranks."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    dev = resolve_device(device)
    init_process_group(dev)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the process group "
                         f"has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def mesh_devices(mesh) -> int:
    return mesh.size()


def parse_mesh(text: str) -> tuple:
    """The shape of a ``--mesh`` value: ``DATAxMODEL`` or one number."""
    shape = tuple(int(x) for x in text.split("x"))
    if len(shape) > 2:
        raise ValueError(f"--mesh {text}: DATAxMODEL or one number")
    return shape


def driver_mesh(shape: tuple, device: torch.device) -> tuple:
    """(axes, tp) of a driver's mesh of `shape` on the resolved `device`,
    the reference's: ("data", "model") with TP the model axis's size, or
    ("data",) for one number, whose TP is that number all the same. On
    ``cuda`` a mesh holds one card: a larger one raises (the multi-rank
    path is checked on the CPU, over gloo)."""
    if device.type == "cuda" and math.prod(shape) > 1:
        raise ValueError(
            f"mesh {'x'.join(map(str, shape))}: on cuda a mesh holds one "
            f"card (the multi-rank path is checked on the CPU, over gloo)")
    axes = ("data", "model") if len(shape) == 2 else ("data",)
    return axes, shape[-1]
