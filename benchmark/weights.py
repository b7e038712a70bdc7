"""Seeded weights under the original checkpoints' keys, made on the device
in one draw: a state dict that loads into the reference and into the port
alike. The checkpoints are not in the repository, and the work of a
forward does not depend on the values.

Matrices and conv kernels are uniform in +-1/sqrt(fan-in); norm scales
1 + U(-0.1, 0.1); biases, norm shifts and the ViT's CLS token and
position embedding U(-0.1, 0.1) scaled (0.02 for the two embeddings).
The query and key weights and biases of PVCNN2's attention, whose softmax
takes q k^T with no 1/sqrt(C) scale, are drawn a further C^(-1/4) each,
so that the scores spread as a scaled attention's do: at the plain draw
the softmax is all but one-hot, and where rounding turns which key wins,
one step's output moves by several times another's."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from benchmark.reference.pvcnn import Attention, GroupNorm
from benchmark.traffic import generator


def state_dict(model: nn.Module, seed: int, k: int, device
               ) -> Dict[str, torch.Tensor]:
    """`model`'s parameters (its shapes only are read: build it on the
    meta device), drawn from stream k of `seed`."""
    norm_scales = {f"{name}.weight" for name, m in model.named_modules()
                   if isinstance(m, (GroupNorm, nn.LayerNorm))}
    qk = {f"{name}.{a}.{b}": m.q.weight.shape[1] ** -0.25
          for name, m in model.named_modules() if isinstance(m, Attention)
          for a in ("q", "k") for b in ("weight", "bias")}
    shapes = [(name, p.shape) for name, p in model.named_parameters()]
    total = sum(math.prod(s) for _, s in shapes)
    u = torch.rand(total, generator=generator(seed, k, device),
                   device=device).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        v = u[off:off + n].view(shape)
        off += n
        if name.endswith(("cls_token", "pos_embed")):
            v.mul_(0.02)
        elif name in norm_scales:
            v.mul_(0.1).add_(1.0)
        elif len(shape) >= 2:
            v.mul_(math.prod(shape[1:]) ** -0.5)
        else:
            v.mul_(0.1)
        v.mul_(qk.get(name, 1.0))
        out[name] = v
    return out
