"""PC2's training step from its definition: the eps-MSE loss on
x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps with the image features frozen,
then the gradients' global norm clipped to a limit, then AdamW (decoupled
weight decay, none on biases and norm scales)."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

from benchmark.reference.diffusion import DDPM
from benchmark.reference.models import PC2
from benchmark.reference.pvcnn import GroupNorm, Run


def pc2_loss(model: PC2, ddpm: DDPM, batch: dict, t, eps, masks,
             run: Run = None) -> torch.Tensor:
    """batch {"image", "camera", "points"}; t (B,), eps (B, N, 3); masks
    the dropout keep-masks of this step in the order the sites run."""
    run = run or Run()
    run.masks = iter(masks)
    cond = model.conditioning(batch["image"], Run(run.p))
    x_t = ddpm.add_noise(batch["points"], eps, t)
    eps_hat = model.denoise(x_t, t, batch["camera"], cond, run)
    left = next(run.masks, None)
    if left is not None:
        raise ValueError("a dropout keep-mask was left unused")
    return torch.mean((eps_hat - eps) ** 2)


def decay_names(model: nn.Module) -> set:
    """The names of the parameters that take weight decay: all but biases
    and the scales and shifts of norms."""
    norms = (GroupNorm, nn.LayerNorm)
    out = set()
    for mname, m in model.named_modules():
        for n, _ in m.named_parameters(recurse=False):
            if n != "bias" and not isinstance(m, norms):
                out.add(f"{mname}.{n}" if mname else n)
    return out


class AdamW:
    """torch.optim.AdamW's update, written out, after a clip of the global
    gradient norm to `clip`."""

    def __init__(self, params: Dict[str, torch.Tensor], decay: set,
                 lr: float, betas, weight_decay: float, eps: float,
                 clip: float):
        self.params = params
        self.decay = decay
        self.lr, self.b1, self.b2 = lr, betas[0], betas[1]
        self.wd, self.eps, self.clip = weight_decay, eps, clip
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.k = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """-> the clipped gradients the update used."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        self.k += 1
        used = {}
        for name, p in self.params.items():
            g = grads[name] * scale
            used[name] = g
            if name in self.decay:
                p.mul_(1.0 - self.lr * self.wd)
            self.m[name].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[name].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            mh = self.m[name] / (1.0 - self.b1 ** self.k)
            vh = self.v[name] / (1.0 - self.b2 ** self.k)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))
        return used


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def trainable(model: PC2) -> List[str]:
    """The parameters PC2 training moves: all but the frozen image
    features."""
    return [k for k, _ in model.named_parameters()
            if not k.startswith("feature_model.")]
