"""Train state and step factories (port of ``repro/train/train_state.py``).

``loss_fn(params, batch) -> (loss, metrics)`` as in the reference; the
params are a tree of tensors that require gradients, or a model
(``nn.Module``, standing for its params tree).  A step takes the gradients
with ``torch.autograd.grad`` over the tree's leaves (zeros for a leaf the
loss does not reach, as ``jax.grad`` gives), runs the optimizer and adds
the updates into the parameters: the state's tensors are written in place,
the port's counterpart of the reference's donated state, and the returned
``TrainState`` holds them with the next step.  Nothing is compiled: each
step runs eagerly on the parameters' device.

``make_dp_train_step`` is the reference's shard_map data-parallel step over
a ``torch.distributed`` group: every rank holds the whole state and passes
its own shard of the batch; the gradients and the loss are averaged over
the group, plainly or through ``grad_compress.compressed_psum``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.train import grad_compress
from repro_torch.train.optimizer import Optimizer, apply_updates
from repro_torch.tree import leaves, tree_map, unflatten


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt_state: Any
    residuals: Any = None      # error-feedback buffers (grad compression)


def init_train_state(params, optimizer: Optimizer,
                     compress: bool = False) -> TrainState:
    return TrainState(
        step=torch.zeros((), dtype=torch.int32,
                         device=leaves(params)[0].device),
        params=params,
        opt_state=optimizer.init(params),
        residuals=grad_compress.init_residuals(params) if compress else None,
    )


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads): ``grads`` on ``params``' tree (a model's as
    its params tree)."""
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), metrics, unflatten(params, grads)


def _apply(state: TrainState, optimizer: Optimizer, grads,
           residuals) -> TrainState:
    updates, opt_state = optimizer.update(grads, state.opt_state,
                                          state.params)
    params = apply_updates(state.params, updates)
    return TrainState(state.step + 1, params, opt_state, residuals)


def make_train_step(loss_fn: Callable, optimizer: Optimizer) -> Callable:
    """``step(state, batch) -> (state, metrics)``, metrics with the loss."""

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, metrics, grads = value_and_grad(loss_fn, state.params, batch)
        new_state = _apply(state, optimizer, grads, state.residuals)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return new_state, metrics

    return step


def make_microbatched_train_step(loss_fn: Callable, optimizer: Optimizer,
                                 n_micro: int) -> Callable:
    """Gradient accumulation over ``n_micro`` microbatches (f32 sums,
    divided by ``n_micro``; memory bound = one microbatch of activations).
    batch leaves: (n_micro, micro_bs, ...)."""

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), state.params)
        losses = []
        for i in range(n_micro):
            mb = tree_map(lambda x: x[i], batch)
            loss, _, grads = value_and_grad(loss_fn, state.params, mb)
            acc = tree_map(torch.add, acc, grads)
            losses.append(loss)
        grads = tree_map(lambda g: g / n_micro, acc)
        return (_apply(state, optimizer, grads, state.residuals),
                {"loss": torch.mean(torch.stack(losses))})

    return step


def _pmean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return x / n


def make_dp_train_step(loss_fn: Callable, optimizer: Optimizer,
                       group: Optional[dist.ProcessGroup] = None,
                       compress: bool = False) -> Callable:
    """Data-parallel step over ``group`` (the default group when None):
    per-rank gradients, then their mean (``compress``: the int8
    error-feedback all-reduce, with the state's residuals).  Parameters and
    optimizer state replicated; each rank passes its shard of the batch."""
    group = group if group is not None else dist.group.WORLD
    n_shards = dist.get_world_size(group)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, _, grads = value_and_grad(loss_fn, state.params, batch)
        if compress:
            grads, new_res = grad_compress.compressed_psum(
                grads, state.residuals, group, n_shards)
        else:
            grads = tree_map(lambda g: _pmean(g, group, n_shards), grads)
            new_res = state.residuals
        loss = _pmean(loss, group, n_shards)
        return _apply(state, optimizer, grads, new_res), {"loss": loss}

    return step
