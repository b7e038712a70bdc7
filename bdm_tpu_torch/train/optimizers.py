"""Optimizer and learning-rate schedule factories
(`bdm_tpu/train/optimizers.py`).

Reference: `training_utils.py:30-92` and the config defaults
(`config/structured.py:222-263`): AdamW(lr=1e-3, betas=(0.95, 0.999),
weight_decay=1e-6), biases and norm scales excluded from decay, global
gradient clip 50, 'linear' / 'cosine' schedules with warm-up.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from bdm_tpu_torch.models.layers import GroupNormCL


def make_lr_schedule(name: str = "cosine", lr: float = 1e-3,
                     num_warmup_steps: int = 2000,
                     num_training_steps: int = 100_000) -> Callable:
    """`transformers.get_scheduler` semantics: step -> learning rate, a
    linear warm-up from 0, then 'linear' falls to 0 at
    `num_training_steps`, 'cosine' follows half a cosine to 0 and
    'constant' holds `lr`."""
    if name not in ("linear", "cosine", "constant"):
        raise ValueError(f"Unknown schedule: {name}")

    def schedule(step: int) -> float:
        warm = (min(1.0, step / num_warmup_steps) if num_warmup_steps > 0
                else 1.0)
        progress = min(1.0, max(0.0, (step - num_warmup_steps) / max(
            1.0, num_training_steps - num_warmup_steps)))
        decay = {"linear": 1.0 - progress,
                 "cosine": 0.5 * (1.0 + math.cos(math.pi * progress)),
                 "constant": 1.0}[name]
        return lr * warm * decay

    return schedule


def _decay_groups(model: nn.Module, weight_decay: float) -> List[Dict]:
    """The trainable parameters in two groups: weight decay on all but
    biases and norm scales (`training_utils.py:43`)."""
    norms = (GroupNormCL, nn.GroupNorm, nn.LayerNorm)
    no_decay = {id(p) for m in model.modules() for n, p
                in m.named_parameters(recurse=False)
                if n == "bias" or isinstance(m, norms)}
    params = [p for p in model.parameters() if p.requires_grad]
    return [
        {"params": [p for p in params if id(p) not in no_decay],
         "weight_decay": weight_decay},
        {"params": [p for p in params if id(p) in no_decay],
         "weight_decay": 0.0}]


class Optimizer:
    """What an update needs beside the torch optimizer: the clip by global
    norm before it, the learning-rate schedule (indexed by updates, 0 at
    the first) and gradient accumulation: the running mean of k micro-steps'
    gradients, one update at every k-th (`optax.MultiSteps`)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 scheduler: Optional[torch.optim.lr_scheduler.LambdaLR],
                 clip_grad_norm: Optional[float],
                 gradient_accumulation_steps: int = 1):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.clip_grad_norm = clip_grad_norm
        self.accumulation_steps = int(gradient_accumulation_steps)
        self.params = [p for g in optimizer.param_groups
                       for p in g["params"]]
        self.mini_step = 0
        self.acc = None     # the running mean, while a window is open

    @staticmethod
    def global_norm(grads) -> torch.Tensor:
        """sqrt of the sum of squares over all tensors, on their device."""
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(list(grads))))

    def apply_gradients(self, reduce: Optional[Callable] = None
                        ) -> torch.Tensor:
        """Consume the `.grad` of one backward: returns the gradients'
        global norm before any clipping; updates the parameters when the
        accumulation window closes. Parameters without a gradient count as
        zero. `reduce(tensors)`, where given, averages tensors over the
        data-parallel ranks in place: it is called once a window, on the
        micro-step that closes it, with the gradients and the window's
        running mean so far, before anything reads them."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if reduce is not None and (self.mini_step + 1
                                   >= self.accumulation_steps):
            reduce(grads + (self.acc or []))
        grad_norm = self.global_norm(grads)
        if self.accumulation_steps > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            # acc += (g - acc) / (n + 1): the mean so far
            torch._foreach_sub_(grads, self.acc)
            torch._foreach_div_(grads, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, grads)
            self.mini_step += 1
            if self.mini_step < self.accumulation_steps:
                return grad_norm
            for p, a in zip(self.params, self.acc):
                p.grad = a
            grads, self.acc, self.mini_step = self.acc, None, 0
        if self.clip_grad_norm is not None:
            # optax.clip_by_global_norm: untouched below the limit, scaled
            # to it above; on the device, the host does not wait
            norm = (grad_norm if self.accumulation_steps == 1
                    else self.global_norm(grads))
            limit = float(self.clip_grad_norm)
            torch._foreach_mul_(grads, torch.where(
                norm < limit, torch.ones_like(norm), limit / norm))
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        return grad_norm

    def learning_rate(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": (None if self.scheduler is None
                              else self.scheduler.state_dict()),
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None and state["scheduler"] is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.mini_step, self.acc = state["mini_step"], state["acc"]


def make_optimizer(model: nn.Module, name: str = "AdamW", lr: float = 1e-3,
                   weight_decay: float = 1e-6, betas: tuple = (0.95, 0.999),
                   clip_grad_norm: Optional[float] = 50.0,
                   schedule: Optional[Callable] = None,
                   gradient_accumulation_steps: int = 1) -> Optimizer:
    """clip -> AdamW (no-decay groups) | Adam | Adadelta | SGD -> schedule
    [-> accumulation] over the parameters of `model` that require a
    gradient: apply a freeze mask (`pc2_freeze_mask`,
    `fusion_freeze_mask`) before this call."""
    if name == "AdamW":
        opt = torch.optim.AdamW(_decay_groups(model, weight_decay), lr=lr,
                                betas=betas, eps=1e-8)
    else:
        params = [p for p in model.parameters() if p.requires_grad]
        if name == "Adam":
            opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
        elif name == "Adadelta":
            # optax.adadelta's defaults
            opt = torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6)
        elif name == "SGD":
            opt = torch.optim.SGD(params, lr=lr)
        else:
            raise NotImplementedError(f"Unknown optimizer: {name}")
    scheduler = None
    if schedule is not None:
        base = opt.param_groups[0]["lr"]
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: schedule(step) / base)
    return Optimizer(opt, scheduler, clip_grad_norm,
                     gradient_accumulation_steps)


FUSION_FROZEN = ("pc2_model_sa_layers", "pc2_model_global_att",
                 "pvd_model_sa_layers", "pvd_model_global_att")


def _freeze(module: nn.Module) -> None:
    for p in module.parameters():
        p.requires_grad_(False)


def pc2_freeze_mask(model: nn.Module,
                    freeze_feature_model: bool = True) -> nn.Module:
    """PC2 training freezes the ViT (`run.freeze_feature_model`, default
    True, `model/__init__.py:9-10`)."""
    if freeze_feature_model:
        _freeze(model.feature_model)
    return model


def fusion_freeze_mask(model: nn.Module) -> nn.Module:
    """BDM-Merging training freezes both encoder towers and the feature
    model; the decoder, `embedf` and the projections train
    (`model/__init__.py:27-35`)."""
    _freeze(model.feature_model)
    for name in FUSION_FROZEN:
        if hasattr(model.fusion, name):
            _freeze(getattr(model.fusion, name))
    return model
