"""AdamW over dicts of tensors: the counterpart of
``repro.train.optimizer``, with the reference's conventions (not
``torch.optim.AdamW``'s): moments in fp32 whatever the parameter dtype;
the gradient clipped by its global norm in fp32, scale
``min(1, clip / (gnorm + 1e-12))``; bias corrections from the step in
fp32; ``delta = mhat / (sqrt(vhat) + eps) + wd * p`` in fp32, weight decay
on every leaf (the fp32 ``w0`` and ``u`` of rwkv6 included), then the
parameter cast back to its dtype.

JAX returns new trees; here parameters and moments are updated in place
(the returned dicts are the given ones), each leaf a slice of
UPDATE_ELEMS elements at a time, so that the fp32 temporaries of the
largest leaf (rwkv6-3b's stacked ``ck``: 734 M elements, 2.9 GB per fp32
temporary) stay small beside the moments.

On a mesh, parameters, gradients and moments are DTensors placed alike
(``distributed/sharding.py``): each rank updates its own shards. The
global norm sums each element once over the mesh: a shard that several
ranks hold (a Replicate mesh dim) counts on one of them, then the sums
are added over the mesh.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..distributed.sharding import counted_once, like, local, sum_over

# Elements of one leaf updated at a time: 64 MB per fp32 temporary.
UPDATE_ELEMS = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor       # scalar int32
    mu: dict                 # first moment (fp32, tree like params)
    nu: dict                 # second moment (fp32)


def _leaves(tree: dict, prefix=()) -> list:
    """(path, tensor) of every leaf of a nested dict, in insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _unflatten(like: dict, leaves: list) -> dict:
    """A nested dict of `like`'s structure holding `leaves`, given in
    :func:`_leaves` order."""
    it = iter(leaves)

    def build(tree):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in tree.items()}
    return build(like)


def tree_map(fn, tree: dict) -> dict:
    """A nested dict of the same structure, ``fn`` of every leaf."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_leaves(tree: dict) -> list:
    return [v for _, v in _leaves(tree)]


def adamw_init(params: dict) -> AdamWState:
    """Zero fp32 moments placed like each parameter, and a 0-d int32 step
    on the parameters' device."""
    def zeros(p):
        loc = local(p)
        return like(p, torch.zeros(loc.shape, dtype=torch.float32,
                                   device=loc.device))
    dev = local(tree_leaves(params)[0]).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32
    (a 0-d tensor on the grads' device); DTensor leaves summed over their
    mesh, each element once."""
    total, mesh = None, None
    for g in tree_leaves(grads):
        if isinstance(g, DTensor):
            mesh = g.device_mesh
            if not counted_once(g):
                continue
        for part in local(g).reshape(-1).split(UPDATE_ELEMS):
            sq = torch.sum(torch.square(part.float()))
            total = sq if total is None else total + sq
    if mesh is not None:
        if total is None:
            total = torch.zeros((), dtype=torch.float32,
                                device=local(g).device)
        total = sum_over(total.reshape(1), mesh, mesh.mesh_dim_names)[0]
    return torch.sqrt(total)


def adamw_update(params: dict, grads: dict, state: AdamWState, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> tuple:
    """One AdamW step with global-norm clipping, in place. The trees
    are matched leaf by leaf by their key paths. Returns (params, state):
    the same dicts, and the state with its step advanced."""
    scale = torch.clamp(grad_clip / (global_norm(grads) + 1e-12), max=1.0)
    step = state.step + 1
    stepf = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=stepf.device), stepf)
    grads, mu, nu = (dict(_leaves(t)) for t in (grads, state.mu, state.nu))
    with torch.no_grad():
        for path, p in _leaves(params):
            p, g, m, v = (local(x) for x in (p, grads[path], mu[path],
                                             nu[path]))
            if not (p.shape == g.shape == m.shape == v.shape) \
                    or not p.is_contiguous():
                raise ValueError(f"adamw_update: leaf {'/'.join(path)}: "
                                 f"param {tuple(p.shape)}, grad "
                                 f"{tuple(g.shape)}, moments "
                                 f"{tuple(m.shape)}, {tuple(v.shape)}; "
                                 f"a contiguous param of the grad's shape")
            for ps, gs, ms, vs in zip(*(x.reshape(-1).split(UPDATE_ELEMS)
                                        for x in (p, g, m, v))):
                gs = gs.float() * scale
                ms.mul_(b1).add_(gs, alpha=1.0 - b1)
                vs.mul_(b2).add_(torch.square(gs), alpha=1.0 - b2)
                mhat = ms / c1
                vhat = vs / c2
                p32 = ps.float()
                delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
                ps.copy_(p32 - lr * delta)
    return params, AdamWState(step, state.mu, state.nu)
