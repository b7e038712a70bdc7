"""The training state and the EMA (`bdm_tpu/train/state.py`).

Reference: `TrainState` (`training_utils.py:23-27`) and torch_ema with
decay 0.999 applied every 20 steps (`main.py:80-89,254-256`,
`config/structured.py:194-198`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn as nn

from bdm_tpu_torch.train.optimizers import Optimizer


@dataclass
class TrainState:
    """Mutable: a train step updates it in place."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None    # by parameter name
    best_val: Optional[float] = None
    ema_decay: float = 0.999
    ema_update_every: int = 20

    @property
    def scheduler(self):
        return self.optimizer.scheduler


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       use_ema: bool = False, ema_decay: float = 0.999,
                       ema_update_every: int = 20) -> TrainState:
    ema = None
    if use_ema:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(model, optimizer, 0, ema, None, ema_decay,
                      ema_update_every)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module,
               decay: float) -> None:
    """ema = decay * ema + (1 - decay) * parameter, in place."""
    for k, p in model.named_parameters():
        ema[k].mul_(decay).add_(p.detach(), alpha=1.0 - decay)
