"""Elastic re-meshing: resume a job on a different device count (the
counterpart of ``repro.distributed.elastic``).

Parameters and optimizer moments are declared by named-axis spec tuples,
so resharding is respecification: build the new mesh, place every leaf
under the same spec names, and continue. ``shrink_mesh`` picks the
largest-TP (data, model) grid that divides the new device count, as the
reference does. On ``torch.distributed`` a mesh covers the whole process
group, so a job resumed on N devices runs N ranks (``launch/mesh.py``).
"""
from __future__ import annotations

from typing import Iterable

from ..launch.mesh import make_mesh
from .sharding import filter_spec, map_specs, place, placements


def viable_meshes(n_devices: int,
                  tp_divisors: Iterable[int] = (16, 8, 4, 2, 1)) -> list:
    """(data, model) grids available at a device count, best-TP first."""
    out = []
    for tp in tp_divisors:
        if n_devices % tp == 0:
            out.append((n_devices // tp, tp))
    return out


def shrink_shape(n_devices: int, model_divisibility: int = 16) -> tuple:
    """The (data, model) grid :func:`shrink_mesh` builds: the first viable
    one whose model axis divides `model_divisibility` (the arch's
    TP-alignment, e.g. its padded head count) or is no larger."""
    for data, model in viable_meshes(n_devices):
        if model_divisibility % model == 0 or model <= model_divisibility:
            return data, model
    raise ValueError(f"no viable mesh for {n_devices} devices")


def shrink_mesh(n_devices: int, model_divisibility: int = 16,
                device="cuda"):
    """Largest usable (data, model) mesh after an elastic event."""
    return make_mesh(shrink_shape(n_devices, model_divisibility),
                     ("data", "model"), device)


def reshard(tree, specs, mesh):
    """Every leaf of `tree` (nested dicts and NamedTuples) placed on
    `mesh` under its spec tuple; axes not present on the new mesh are
    dropped (e.g. 'pod' after shrinking to one pod). A plain leaf must be
    the same on every rank (as a restored checkpoint is); a dim that does
    not split over its axes raises, as ``jax.device_put`` does."""
    names = tuple(mesh.mesh_dim_names)
    return map_specs(lambda x, s: place(
        x, mesh, placements(mesh, filter_spec(tuple(s), names))),
        tree, specs)


def elastic_resume(tree, specs, n_devices: int,
                   model_divisibility: int = 16, device="cuda"):
    """One-call elastic restart: shrink the mesh and reshard the state."""
    mesh = shrink_mesh(n_devices, model_divisibility, device)
    return reshard(tree, specs, mesh), mesh
