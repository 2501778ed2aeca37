"""Train-step factory: loss + grad + AdamW, with microbatched gradient
accumulation: the counterpart of ``repro.train.train_step``.

``jax.value_and_grad`` becomes ``torch.autograd.grad`` over the parameter
leaves, and the reference's ``lax.scan`` over microbatches a loop that
adds each microbatch's grads, cast to fp32, into an fp32 accumulator (the
first microbatch's grads, cast, start it: zero plus them is the same
bits). The sum is divided by the number of microbatches and the loss
averaged, as in the reference. Each microbatch's grads are freed before
the next one runs, so the memory is constant in the number of
microbatches.

On a mesh (``param_specs`` given and a mesh active,
``distributed.sharding.use_mesh``) the state lives as DTensors under the
specs, filtered by ``constrain_like``'s rules: parameters, moments and
the gradient accumulator alike. The batch axes (``pod``, ``data``) split
each microbatch's rows: every rank holds the whole global batch and takes
its own rows. How a step gathers the parameters for the forward and
backward depends on the ``model`` axis:

* With ``shards`` (the family computes on ``model`` shards,
  ``models.registry.train_tp_path``) and a ``model`` axis of several
  ranks, each parameter is gathered over the batch axes only
  (``sharding.gather_batch``): the forward sees this rank's ``model``
  shards, gets the mesh (``loss_fn(params, batch, mesh)``) and runs
  tensor-parallel through the autograd collectives, and each gradient
  comes out as this rank's shard, which is reduced over the batch axes
  only.
* Otherwise every parameter is gathered whole (``sharding.gather``) and
  the loss does the single-process step's math on plain tensors; each
  gradient is reduced over the batch axes and sliced to the rank's
  ``model`` shard. Where the batch axes hold several ranks the loss also
  gets their sub-mesh (``loss_fn(params, batch, sharding.batch_mesh(...))``),
  for work that spans the rows of several ranks (the MoE family's
  routing groups; the other families' forwards ignore it). On a 1x1 mesh,
  or with no mesh, this is the single-process step, call for call.

Either way each microbatch's gradient is reduced into the parameters'
placements (``sharding.reduce_into``: a reduce-scatter over the batch
axes where a dim is split over them, an all-reduce where the leaf is
replicated), then added to the accumulator. Where the batch axes hold one
rank (a 1x1 or 1xN mesh) there is no communication there, and every
gather over them is the parameter's own storage.

The step updates the state in place (see ``optimizer``) and returns it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..distributed.sharding import (BATCH_AXES, active_mesh, batch_mesh,
                                    constrain_like, data_rows, gather,
                                    gather_batch, like, model_size,
                                    reduce_into, sum_over)
from .optimizer import (AdamWState, _leaves, _unflatten, adamw_init,
                        adamw_update)


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState


def train_state_init(params: dict) -> TrainState:
    return TrainState(params=params, opt=adamw_init(params))


def state_specs(param_specs: dict) -> TrainState:
    """Spec tuples of a TrainState whose parameters have `param_specs`:
    the moments share them; the step counter (None) stays a plain 0-d
    tensor on every rank."""
    return TrainState(param_specs, AdamWState(None, param_specs,
                                              param_specs))


def _grads(loss_fn: Callable, params: dict, batch: dict,
           *mesh) -> tuple:
    """(loss, grads as a list in leaf order): the leaves are detached and
    set to require grad for the call, so the step leaves no graph on the
    parameters. A `mesh` given is passed on to `loss_fn`."""
    inputs = [p.detach().requires_grad_(True) for _, p in _leaves(params)]
    loss = loss_fn(_unflatten(params, inputs), batch, *mesh)
    grads = torch.autograd.grad(loss, inputs)
    return loss.detach(), list(grads)


def _mesh_of(params: dict):
    for _, p in _leaves(params):
        if isinstance(p, DTensor):
            return p.device_mesh
    return None


def accumulate(loss_fn: Callable, params: dict, batch: dict,
               microbatches: int = 1, shards: bool = False) -> tuple:
    """(loss, grads): the step's loss, averaged over the microbatches, and
    its gradient tree. On plain parameters: with one microbatch the grads
    in the parameters' dtype, with more their fp32 mean. On DTensor
    parameters: each grad a DTensor placed like its parameter, the mean
    over the microbatches and the batch axes' ranks (fp32 where it was
    reduced), and the loss averaged over those ranks too. With `shards`
    and a ``model`` axis of several ranks, the forward computes on this
    rank's ``model`` shards (``loss_fn(params, batch, mesh)``); otherwise,
    where the batch axes hold several ranks, it gets their sub-mesh
    (``loss_fn(params, batch, batch_mesh(mesh))``; see the module
    docstring)."""
    if microbatches < 1:
        raise ValueError(f"microbatches {microbatches} < 1")
    b = next(iter(batch.values())).shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} "
                         f"microbatches")
    mesh = _mesh_of(params)
    index, ranks = data_rows(mesh)
    rows = b // microbatches
    if rows % ranks:
        raise ValueError(f"microbatch of {rows} rows does not split over "
                         f"{ranks} ranks of the batch axes")
    per = rows // ranks
    refs = [p for _, p in _leaves(params)]
    on_shards = shards and model_size(mesh) > 1
    full = _unflatten(params, [(gather_batch if on_shards else gather)(p)
                               for p in refs])
    row_mesh = batch_mesh(mesh)
    extra = (mesh,) if on_shards else () if row_mesh is None \
        else (row_mesh,)
    acc, loss_sum = None, None
    for i in range(microbatches):
        lo = i * rows + index * per
        loss, grads = _grads(loss_fn, full,
                             {k: x[lo:lo + per] for k, x in batch.items()},
                             *extra)
        if mesh is not None:
            grads = [reduce_into(g, p) for g, p in zip(grads, refs)]
        if acc is None:
            acc, loss_sum = grads, loss
            if microbatches > 1 or ranks > 1:
                acc = [g.float() for g in acc]
        else:
            for a, g in zip(acc, grads):
                a.add_(g)
            loss_sum = loss_sum + loss
        del grads
    n = microbatches * ranks
    if n > 1:
        for a in acc:
            a.div_(n)
    if ranks > 1:
        loss_sum = sum_over(loss_sum.reshape(1), mesh, BATCH_AXES)[0]
    loss = loss_sum / n if n > 1 else loss_sum
    return loss, _unflatten(params, [like(p, a) for p, a in zip(refs, acc)])


def make_train_step(loss_fn: Callable, *, microbatches: int = 1,
                    lr: float = 3e-4, weight_decay: float = 0.1,
                    grad_clip: float = 1.0,
                    param_specs: dict | None = None,
                    shards: bool = False) -> Callable:
    """loss_fn(params, batch) -> scalar loss (with `shards`, also
    loss_fn(params, batch, mesh) on a ``model`` axis of several ranks:
    see :func:`accumulate`). Returns step(state, batch) -> (state,
    metrics), metrics {"loss": 0-d fp32 tensor}.

    With microbatches > 1 the global batch (a dict of tensors) is split
    along axis 0 and the grads accumulated in fp32. With `param_specs`
    (spec tuples mirroring the params) and an active mesh, the state is
    kept under the specs on that mesh (``constrain_like``; a state placed
    so already is left as it is) and the grads and their accumulator are
    pinned to the parameters' placements."""
    if microbatches < 1:
        raise ValueError(f"microbatches {microbatches} < 1")
    specs = state_specs(param_specs) if param_specs is not None else None

    def step(state: TrainState, batch: dict) -> tuple:
        if specs is not None and active_mesh() is not None:
            state = constrain_like(state, specs)
        loss, grads = accumulate(loss_fn, state.params, batch, microbatches,
                                 shards)
        params, opt = adamw_update(state.params, grads, state.opt, lr=lr,
                                   weight_decay=weight_decay,
                                   grad_clip=grad_clip)
        return TrainState(params, opt), {"loss": loss}

    return step
