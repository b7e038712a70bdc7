"""The training loop (`bdm_tpu/train/loop.py`, reference
`main.py:183-303`): train step, clip and accumulation in the optimizer,
EMA, periodic checkpoints, the NaN-loss hard stop (`main.py:231-234`) and
metric logging.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Optional

import torch

from bdm_tpu_torch.train.checkpoint import save_checkpoint
from bdm_tpu_torch.train.metrics import MetricLogger
from bdm_tpu_torch.train.state import TrainState
from bdm_tpu_torch.train.step import make_train_step


class NaNLossError(RuntimeError):
    pass


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(state: TrainState, loss_fn: Callable, data_iter: Iterable,
               max_steps: int, noise, checkpoint_dir: Optional[str] = None,
               checkpoint_freq: int = 1000, print_freq: int = 100,
               log_step_freq: int = 20,
               logger: Optional[MetricLogger] = None,
               callbacks: Optional[list] = None,
               profile_dir: Optional[str] = None,
               profile_steps: tuple = (10, 20)) -> TrainState:
    """Run up to `max_steps` steps over an iterator of model-form batches
    ({"image", "camera", "points"} tensors on the model's device); `noise`
    is the `TrainNoise` every step draws from.

    The host never waits for a step: the loss stays on the device, and a
    device-side record of the first step whose loss was not finite is
    updated every step and read at the log cadence, so a NaN raises
    `NaNLossError` naming the step it happened at. With `profile_dir` a
    `torch.profiler` trace of steps [profile_steps) is written there."""
    step_fn = make_train_step(loss_fn)
    logger = logger or MetricLogger()
    callbacks = callbacks or []
    device = next(state.model.parameters()).device
    first_bad = torch.full((), -1, dtype=torch.long, device=device)
    prof = None

    t_start = time.time()
    start_step = state.step
    for batch in data_iter:
        if state.step >= max_steps:
            break
        metrics = step_fn(state, batch, noise)
        step = state.step
        bad = ~torch.isfinite(metrics["loss"]) & (first_bad < 0)
        first_bad = torch.where(bad, torch.full_like(first_bad, step),
                                first_bad)

        if profile_dir is not None:
            if step == profile_steps[0] and prof is None:
                _sync(device)   # the trace starts on an idle device
                prof = torch.profiler.profile()
                prof.start()
            elif step >= profile_steps[1] and prof is not None:
                prof = _stop_profile(prof, profile_dir, device)

        if step % log_step_freq == 0 or step == max_steps:
            bad_step = int(first_bad)
            if bad_step >= 0:
                # hard stop like the reference (`main.py:231-234`)
                raise NaNLossError(f"Loss is not finite at step {bad_step}.")
            logger.update(loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          lr=state.optimizer.learning_rate())
            logger.log_jsonl(step)

        if step % print_freq == 0:
            rate = (step - start_step) / max(1e-9, time.time() - t_start)
            print(f"step {step}/{max_steps}  {logger}  ({rate:.2f} it/s)")

        if checkpoint_dir is not None and step % checkpoint_freq == 0:
            save_checkpoint(checkpoint_dir, state)

        for cb in callbacks:
            cb(step, state, metrics)

    if prof is not None:
        _stop_profile(prof, profile_dir, device)
    if int(first_bad) >= 0:
        raise NaNLossError(f"Loss is not finite at step {int(first_bad)}.")
    if checkpoint_dir is not None:
        save_checkpoint(checkpoint_dir, state)
    return state


def _stop_profile(prof, profile_dir: str, device: torch.device) -> None:
    _sync(device)   # the traced steps have finished on the device
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return None
