"""The training loop (`bdm_tpu/train/loop.py`, reference
`main.py:183-303`): train step, clip and accumulation in the optimizer,
EMA, periodic checkpoints, the NaN-loss hard stop (`main.py:231-234`) and
metric logging, on one process or on the ranks of a data-parallel group.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from bdm_tpu_torch.parallel.mesh import is_main, shard_batch
from bdm_tpu_torch.train.checkpoint import save_checkpoint
from bdm_tpu_torch.train.metrics import MetricLogger
from bdm_tpu_torch.train.state import TrainState
from bdm_tpu_torch.train.step import make_train_step


class NaNLossError(RuntimeError):
    pass


def _first_bad(first_bad: torch.Tensor, group) -> int:
    """The first step whose loss was not finite on any rank, or -1."""
    if group is None:
        return int(first_bad)
    never = torch.iinfo(torch.long).max
    x = torch.where(first_bad < 0, torch.full_like(first_bad, never),
                    first_bad)
    dist.all_reduce(x, dist.ReduceOp.MIN, group=group)
    return -1 if int(x) == never else int(x)


def train_loop(state: TrainState, loss_fn: Callable, data_iter: Iterable,
               max_steps: int, noise, checkpoint_dir: Optional[str] = None,
               checkpoint_freq: int = 1000, print_freq: int = 100,
               log_step_freq: int = 20,
               logger: Optional[MetricLogger] = None,
               callbacks: Optional[list] = None,
               group=None) -> TrainState:
    """Run up to `max_steps` steps over an iterator of model-form batches
    ({"image", "camera", "points"} tensors on the model's device); `noise`
    is the `TrainNoise` every step draws from.

    The host never waits for a step: the loss stays on the device, and a
    device-side record of the first step whose loss was not finite is
    updated every step and read at the log cadence, so a NaN raises
    `NaNLossError` naming the step it happened at.

    With `group` (data parallel, `make_train_step`) every rank of it reads
    the same global batches and the same noise and takes its rows
    (`parallel.shard_batch`), the record of the first bad step is the
    least over the ranks, so every rank stops at the same step, and only
    rank 0 writes checkpoints, logs and prints; callbacks run on every
    rank."""
    step_fn = make_train_step(loss_fn, group)
    shard = ((lambda b: b) if group is None else
             (lambda b: shard_batch(b, dist.get_rank(group),
                                    dist.get_world_size(group))))
    rank0 = is_main()
    logger = logger or MetricLogger()
    callbacks = callbacks or []
    device = next(state.model.parameters()).device
    first_bad = torch.full((), -1, dtype=torch.long, device=device)

    t_start = time.time()
    start_step = state.step
    for batch in data_iter:
        if state.step >= max_steps:
            break
        metrics = step_fn(state, shard(batch), noise)
        step = state.step
        bad = ~torch.isfinite(metrics["loss"]) & (first_bad < 0)
        first_bad = torch.where(bad, torch.full_like(first_bad, step),
                                first_bad)

        if step % log_step_freq == 0 or step == max_steps:
            bad_step = _first_bad(first_bad, group)
            if bad_step >= 0:
                # hard stop like the reference (`main.py:231-234`)
                raise NaNLossError(f"Loss is not finite at step {bad_step}.")
            logger.update(loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          lr=state.optimizer.learning_rate())
            if rank0:
                logger.log_jsonl(step)

        if step % print_freq == 0 and rank0:
            rate = (step - start_step) / max(1e-9, time.time() - t_start)
            print(f"step {step}/{max_steps}  {logger}  ({rate:.2f} it/s)")

        if checkpoint_dir is not None and step % checkpoint_freq == 0:
            save_checkpoint(checkpoint_dir, state)        # rank 0 writes

        for cb in callbacks:
            cb(step, state, metrics)

    bad_step = _first_bad(first_bad, group)
    if bad_step >= 0:
        raise NaNLossError(f"Loss is not finite at step {bad_step}.")
    if checkpoint_dir is not None:
        save_checkpoint(checkpoint_dir, state)
    return state

