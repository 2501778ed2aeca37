"""Train-step factory: loss + grad + AdamW, with microbatched gradient
accumulation: the counterpart of ``repro.train.train_step``.

``jax.value_and_grad`` becomes ``torch.autograd.grad`` over the parameter
leaves, and the reference's ``lax.scan`` over microbatches a loop that
adds each microbatch's grads, cast to fp32, into an fp32 accumulator (the
first microbatch's grads, cast, start it: zero plus them is the same
bits). The sum is divided by the number of microbatches and the loss
averaged, as in the reference. Each microbatch's grads are freed before
the next one runs, so the memory is constant in the number of
microbatches. The reference's ``param_specs`` (gradients pinned to the
parameter sharding) waits for the distributed slice.

The step updates the state in place (see ``optimizer``) and returns it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .optimizer import (AdamWState, _leaves, _unflatten, adamw_init,
                        adamw_update)


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState


def train_state_init(params: dict) -> TrainState:
    return TrainState(params=params, opt=adamw_init(params))


def _grads(loss_fn: Callable, params: dict, batch: dict) -> tuple:
    """(loss, grads as a list in leaf order): the leaves are detached and
    set to require grad for the call, so the step leaves no graph on the
    parameters."""
    inputs = [p.detach().requires_grad_(True) for _, p in _leaves(params)]
    loss = loss_fn(_unflatten(params, inputs), batch)
    grads = torch.autograd.grad(loss, inputs)
    return loss.detach(), list(grads)


def make_train_step(loss_fn: Callable, *, microbatches: int = 1,
                    lr: float = 3e-4, weight_decay: float = 0.1,
                    grad_clip: float = 1.0) -> Callable:
    """loss_fn(params, batch) -> scalar loss. Returns
    step(state, batch) -> (state, metrics), metrics {"loss": 0-d fp32
    tensor}.

    With microbatches > 1 the global batch (a dict of tensors) is split
    along axis 0 and the grads accumulated in fp32."""
    if microbatches < 1:
        raise ValueError(f"microbatches {microbatches} < 1")

    def update(state: TrainState, grads: dict) -> TrainState:
        params, opt = adamw_update(state.params, grads, state.opt, lr=lr,
                                   weight_decay=weight_decay,
                                   grad_clip=grad_clip)
        return TrainState(params, opt)

    def single(state: TrainState, batch: dict) -> tuple:
        loss, grads = _grads(loss_fn, state.params, batch)
        return update(state, _unflatten(state.params, grads)), {"loss": loss}

    if microbatches == 1:
        return single

    def accumulated(state: TrainState, batch: dict) -> tuple:
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} "
                             f"microbatches")
        parts = {k: x.chunk(microbatches, 0) for k, x in batch.items()}
        acc, loss_sum = None, None
        for i in range(microbatches):
            loss, grads = _grads(loss_fn, state.params,
                                 {k: p[i] for k, p in parts.items()})
            if acc is None:
                acc, loss_sum = [g.float() for g in grads], loss
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
                loss_sum = loss_sum + loss
            del grads
        for a in acc:
            a.div_(microbatches)
        return update(state, _unflatten(state.params, acc)), \
            {"loss": loss_sum / microbatches}

    return accumulated
