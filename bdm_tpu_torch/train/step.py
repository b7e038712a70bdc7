"""The train step (`bdm_tpu/train/step.py`), on one device."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from bdm_tpu_torch.train.state import TrainState, ema_update


def make_train_step(loss_fn: Callable) -> Callable:
    """Build `step(state, batch, noise) -> {"loss", "grad_norm"}`, both
    0-dim tensors on the model's device (the reference logs both,
    `main.py:239-252`); `grad_norm` is the global norm before clipping.

    `loss_fn(batch, noise)` -> scalar loss of `state.model`, for example
    `PC2Model.loss`. The model is in `train()` mode (dropout on) for the
    forward and back in `eval()` afterwards, so sampling between steps
    sees no dropout. The step reads nothing back: the host does not wait
    for the device."""

    def step(state: TrainState, batch, noise) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        model.train()
        try:
            loss = loss_fn(batch, noise)
        finally:
            model.eval()
        opt.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = opt.apply_gradients()
        state.step += 1
        if state.ema is not None and state.step % state.ema_update_every == 0:
            ema_update(state.ema, model, state.ema_decay)
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
