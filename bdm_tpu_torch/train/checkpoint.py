"""Checkpoints with `torch.save` (`bdm_tpu/train/checkpoint.py`;
reference `main.py:259-274`, `training_utils.py:273-346`).

A checkpoint holds {"model", "optimizer", "step", "best_val"[, "ema"]};
the model under the reference `state_dict` keys, so
`bdm_tpu/utils/convert_torch.py` reads a saved model. Restore tolerates
leaving the optimizer state or the step behind
(`resume_training_optimizer`-style partial resume).

Under a process group only rank 0 writes (data-parallel ranks hold the
same state). The keys are the model's own, never a `module.` prefix: the
data-parallel step averages gradients without wrapping the model, so a
checkpoint written by any number of ranks loads into one process.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
import torch.nn as nn

from bdm_tpu_torch.parallel.mesh import is_main
from bdm_tpu_torch.train.state import TrainState


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    config: Optional[dict] = None,
                    name: str = "checkpoint-latest") -> str:
    """Save a checkpoint (rank 0 alone, under a process group); returns
    its path."""
    path = os.path.abspath(os.path.join(ckpt_dir, name + ".pt"))
    if not is_main():
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": state.step, "best_val": state.best_val}
    if state.ema is not None:
        payload["ema"] = state.ema
    torch.save(payload, path)
    if config is not None:
        with open(path + ".config.json", "w") as f:
            json.dump(config, f, indent=2, default=str)
    return path


def restore_checkpoint(path: str, state: TrainState,
                       restore_optimizer: bool = True,
                       restore_step: bool = True) -> TrainState:
    """Restore into an existing state, in place; returns it."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    if state.ema is not None and "ema" in payload:
        for k, v in payload["ema"].items():
            state.ema[k].copy_(v)
    if restore_optimizer:
        state.optimizer.load_state_dict(payload["optimizer"])
    if restore_step:
        state.step = int(payload["step"])
        state.best_val = payload.get("best_val")
    return state


def save_params(path: str, model: nn.Module) -> str:
    """Save a bare `state_dict` (a released-checkpoint style file)."""
    path = os.path.abspath(path)
    torch.save(model.state_dict(), path)
    return path


def load_params(path: str, model: nn.Module) -> nn.Module:
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=device,
                                     weights_only=True))
    return model
