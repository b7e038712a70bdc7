"""The train step (`bdm_tpu/train/step.py`), on one process or on the
ranks of a data-parallel process group."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from bdm_tpu_torch.parallel.mesh import ShardedNoise
from bdm_tpu_torch.train.state import TrainState, ema_update


def all_reduce_mean(tensors: List[torch.Tensor], group) -> None:
    """Average float tensors over the ranks of `group`, in place: one
    all-reduce of one flat buffer."""
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for t, r in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(r)


def make_train_step(loss_fn: Callable, group=None) -> Callable:
    """Build `step(state, batch, noise) -> {"loss", "grad_norm"}`, both
    0-dim tensors on the model's device (the reference logs both,
    `main.py:239-252`); `grad_norm` is the global norm before clipping.

    `loss_fn(batch, noise)` -> scalar loss of `state.model`, for example
    `PC2Model.loss`. The model is in `train()` mode (dropout on) for the
    forward and back in `eval()` afterwards, so sampling between steps
    sees no dropout. The step reads nothing back: the host does not wait
    for the device.

    With `group`, a process group of P ranks, each rank passes its B / P
    rows of the global batch (`parallel.shard_batch`) and the noise source
    every rank holds alike: the step draws at the global batch and takes
    this rank's rows (`parallel.ShardedNoise`), and averages the gradients
    and the loss over the ranks before the norm, the clip, the optimizer,
    the accumulation and the EMA. So every rank takes the same step, the
    step one process takes on the B rows (a loss that is a mean over
    equal rows). Under gradient accumulation the all-reduce waits for the
    micro-step that closes the window (DDP's `no_sync`) and averages the
    window's running mean with that micro-step's gradient; a micro-step
    that does not close it returns this rank's loss and gradient norm.
    With no group: one process, no collective."""
    rank = None if group is None else dist.get_rank(group)
    size = None if group is None else dist.get_world_size(group)

    def step(state: TrainState, batch, noise) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        if group is not None:
            noise = ShardedNoise(noise, rank, size)
        model.train()
        try:
            loss = loss_fn(batch, noise)
        finally:
            model.eval()
        opt.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        reduce = None
        if group is not None:
            def reduce(tensors):
                all_reduce_mean(tensors + [loss.view(1)], group)
        grad_norm = opt.apply_gradients(reduce)
        state.step += 1
        if state.ema is not None and state.step % state.ema_update_every == 0:
            ema_update(state.ema, model, state.ema_decay)
        return {"loss": loss, "grad_norm": grad_norm}

    return step
