"""Fault-tolerant checkpointing with the reference's on-disk format
(``repro.distributed.checkpoint``), so that either package restores what
the other saved:

    <dir>/step_000042/
        manifest.json        # step, n_leaves, n_hosts, treedef, dtypes,
                             # shapes, status
        host_000.npz         # leaf_<i>: the i-th leaf, whole

Writes go to ``step_<n>.tmp<host>/``; each file is fsync'd, then the
directory is renamed into place, so a crashed save never shadows the
previous good step, and :func:`latest_step` skips torn saves.

Leaves are numbered in JAX's order (``jax.tree.flatten``): a dict's keys
sorted, a NamedTuple's fields (``TrainState(params, opt)``,
``AdamWState(step, mu, nu)``) in their declared order. The
manifest's ``treedef`` describes the structure in the port's words; both
packages read only ``n_leaves`` of it (and the port also checks each
leaf's shape).

bf16, which numpy lacks, is stored as its uint16 bits under the name
"bfloat16", as the reference stores it (numpy's extension type,
ml_dtypes, which the port does not import, reads it back).

A leaf may be a DTensor: it is gathered whole, so every rank of its mesh
takes part in a save, and rank 0 of the process group writes. Restore
copies each leaf into the target tree's own tensor in place (a DTensor
target gets its local shard), so a state the size of the card's memory
is not held twice. An async mode copies the state to the host, then
writes it on a worker thread: the train loop waits only for the copy and
for the previous save.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .sharding import gather, local, local_shard



def _flatten(tree) -> list:
    """Leaves in jax.tree.flatten's order: dict keys sorted, NamedTuple
    fields and list items in order, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _treedef(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if hasattr(tree, "_fields"):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], ["
                + ", ".join(_treedef(t) for t in tree) + "])")
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(t) for t in tree) + "]"
    return "*"


def _writes() -> bool:
    """Whether this process writes: rank 0 of the process group, or the
    only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _host_leaf(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array to store, dtype name) of one whole leaf in host memory of
    its own: a CPU leaf is copied too, since the train step updates the
    state in place while an async save writes."""
    t = t.detach()
    t = t.cpu() if t.device.type != "cpu" else t.clone()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _host_copy(tree) -> tuple[list, list, str]:
    """(arrays, dtype names, treedef) of `tree` on the host. DTensor
    leaves are gathered whole on every rank (a collective); only the rank
    that writes keeps a host copy, the others return empty lists."""
    keep = _writes()
    pairs = []
    for x in _flatten(tree):
        full = gather(x)
        if keep:
            pairs.append(_host_leaf(full))
    return [a for a, _ in pairs], [n for _, n in pairs], _treedef(tree)


def _write(directory: str, step: int, arrays: list, dtypes: list,
           treedef: str, host_id: int, n_hosts: int) -> str:
    final = os.path.join(directory, f"step_{step:06d}")
    tmp = final + f".tmp{host_id}"
    os.makedirs(tmp, exist_ok=True)
    shard_path = os.path.join(tmp, f"host_{host_id:03d}.npz")
    with open(shard_path, "wb") as f:
        np.savez(f, **{f"leaf_{i}": a for i, a in enumerate(arrays)})
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": step,
        "n_leaves": len(arrays),
        "n_hosts": n_hosts,
        "treedef": treedef,
        "dtypes": dtypes,
        "shapes": [list(a.shape) for a in arrays],
        "status": "complete",
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    # Atomic commit: a reader either sees the full directory or nothing.
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(directory: str, step: int, tree, host_id: int = 0,
         n_hosts: int = 1) -> str:
    """Synchronous checkpoint save. Returns the committed path (the path
    it would have on the ranks that do not write)."""
    arrays, dtypes, treedef = _host_copy(tree)
    if not _writes():
        return os.path.join(directory, f"step_{step:06d}")
    return _write(directory, step, arrays, dtypes, treedef, host_id,
                  n_hosts)


def latest_step(directory: str) -> Optional[int]:
    """Newest step with a complete manifest (skips torn/tmp saves)."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if not name.startswith("step_") or name.endswith(
                tuple(f".tmp{i}" for i in range(64))):
            continue
        mpath = os.path.join(directory, name, "manifest.json")
        try:
            with open(mpath) as f:
                m = json.load(f)
            if m.get("status") == "complete":
                best = max(best or -1, int(m["step"]))
        except (OSError, ValueError, KeyError):
            continue
    return best


def _from_storable(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as a CPU tensor of the manifest's dtype."""
    a = np.require(a, requirements="C")      # keeps 0-d arrays 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dtype_name)
    if a.dtype != want:
        try:
            a = a.view(want)
        except (TypeError, ValueError):
            a = a.astype(want)
    return torch.from_numpy(a)


def restore(directory: str, step: int, tree_like, host_id: int = 0):
    """Restore into `tree_like`, whose leaves give the order: each
    checkpoint leaf is cast to the target leaf's dtype and copied into it
    in place (a DTensor target receives its local shard). Returns
    `tree_like`. A different number of leaves, or a leaf of another
    shape, raises ValueError."""
    path = os.path.join(directory, f"step_{step:06d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _flatten(tree_like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"restore target has {len(leaves)} — structure mismatch")
    for i, (shape, leaf) in enumerate(zip(manifest["shapes"], leaves)):
        if tuple(shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {i} has shape {tuple(shape)}, "
                             f"restore target {tuple(leaf.shape)} — "
                             f"structure mismatch")
    with np.load(os.path.join(path, f"host_{host_id:03d}.npz")) as data:
        for i, leaf in enumerate(leaves):
            src = _from_storable(data[f"leaf_{i}"], manifest["dtypes"][i])
            dst = local(leaf)
            if dst is not leaf:
                src = local_shard(src, leaf.device_mesh, leaf.placements)
            with torch.no_grad():
                dst.copy_(src)
    return tree_like


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training: save() copies the state to
    the host and returns; a worker thread writes it. The next save (or
    close()) joins the in-flight write first. Each save's record is kept
    in ``saves``: the step, the seconds save() blocked (``block_s``: the
    wait for the previous write, ``wait_s``, and the host copy,
    ``copy_s``), the bytes of the host copy and, once written, the seconds
    the write took (``write_s``)."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves: list = []

    def save(self, directory: str, step: int, tree, host_id: int = 0,
             n_hosts: int = 1) -> None:
        t0 = time.perf_counter()
        self.wait()
        # Copy to the host *before* backgrounding: the next step updates
        # the parameters and moments in place.
        t1 = time.perf_counter()
        arrays, dtypes, treedef = _host_copy(tree)
        record = {"step": step, "wait_s": t1 - t0,
                  "copy_s": time.perf_counter() - t1,
                  "host_bytes": sum(a.nbytes for a in arrays)}
        self.saves.append(record)
        if _writes():
            def work():
                t = time.perf_counter()
                try:
                    _write(directory, step, arrays, dtypes, treedef,
                           host_id, n_hosts)
                    record["write_s"] = time.perf_counter() - t
                except BaseException as e:      # surfaced on next wait()
                    self._error = e

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        record["block_s"] = time.perf_counter() - t0

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    close = wait
