"""Shared layers, channel-last (`bdm_tpu/models/layers.py`).

Parameters keep the reference checkpoints' names and shapes (1x1 convs as
(out, in, 1[, 1[, 1]]), GroupNorm `weight`/`bias`), so a reference
state_dict loads with no converter; the forwards compute on (B, ..., C).

`dtype` is the compute dtype (None = float32, or torch.bfloat16): dense
layers run in it, GroupNorm statistics and the softmax stay float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from bdm_tpu_torch import ops
from bdm_tpu_torch.utils.spans import span

GN_EPS = 1e-5  # torch.nn.GroupNorm's default, as in the reference


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


# The source of dropout keep-masks for the loss being evaluated: an object
# with `keep_mask(shape, p) -> bool tensor` (`samplers.TrainNoise`), set by
# `dropout_masks` around a loss's forward.
_mask_source = None


@contextlib.contextmanager
def dropout_masks(source):
    """Inside this block every `Dropout` in training mode takes its
    keep-mask from `source.keep_mask(shape, p)`."""
    global _mask_source
    outer, _mask_source = _mask_source, source
    try:
        yield
    finally:
        _mask_source = outer


class Dropout(nn.Dropout):
    """flax's `nn.Dropout`: x / (1 - p) where a Bernoulli(1 - p) keep-mask
    is set, else 0; the identity in eval mode or at p = 0 (no mask drawn).
    The mask comes from the source `dropout_masks` set for the current
    loss, so a training step is a function of its `TrainNoise`; outside a
    loss (a forward in train mode) from PyTorch's global generator, as
    `nn.Dropout`'s. No parameters: `state_dict` keys are those of
    `nn.Dropout`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if _mask_source is None:
            return F.dropout(x, self.p, True)
        keep = _mask_source.keep_mask(x.shape, self.p)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


_FREQS = {}


def _frequencies(half: int, device: torch.device) -> torch.Tensor:
    """The embedding's (half,) float32 frequencies on `device`, computed on
    the host in float64 once a (half, device) and kept: a forward then
    copies nothing from the host, which a CUDA graph could not capture."""
    freq = _FREQS.get((half, device))
    if freq is None:
        with torch.inference_mode(False):
            freq = torch.exp(torch.arange(half, dtype=torch.float64)
                             * -(math.log(10000.0) / (half - 1))).float()
            freq = _FREQS[(half, device)] = freq.to(device)
    return freq


def get_timestep_embedding(embed_dim: int, t: torch.Tensor) -> torch.Tensor:
    """(B,) timesteps -> (B, E) float32 [sin | cos]; frequencies use
    half_dim - 1 (`pvcnn_utils.py:171-185`)."""
    half = embed_dim // 2
    emb = t.float()[:, None] * _frequencies(half, t.device)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embed_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class Conv1x1(nn.Module):
    """A pointwise conv stored like the reference's Conv1d/2d/3d with
    kernel size 1, applied over the last axis of (B, ..., Cin)."""

    def __init__(self, cin: int, cout: int, kdims: int = 1,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + (1,) * kdims))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        dt = dtype or x.dtype
        w = self.weight.reshape(self.weight.shape[0], -1).to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), w, b)


class GroupNormCL(nn.Module):
    """GroupNorm over the last (channel) axis of (B, ..., C): statistics
    over every non-batch position and the channels of a group, in float32;
    the output is cast to `dtype` (default: the input's), then passed
    through SiLU where `silu` asks for it.

    With `group`, x is this rank's shard of a (B, N, ...) tensor whose point
    axis is split evenly over the ranks of that process group: the
    statistics are those of the whole (differentiable).

    Every call goes to `ops.group_norm`, which owns the choice of form: the
    plain one on the CPU, the kernel pair of `csrc/groupnorm.cu` on the
    card."""

    def __init__(self, num_groups: int, channels: int, eps: float = GN_EPS):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, dtype=None, group=None,
                silu: bool = False) -> torch.Tensor:
        with span("groupnorm"):
            return ops.group_norm(x, self.weight, self.bias, self.num_groups,
                                  self.eps, dtype, silu, group)


class SharedMLP(nn.Module):
    """(1x1 conv -> GroupNorm(8) -> Swish) x k (`shared_mlp.py:11-38`);
    `layers` indices match the reference (conv 3j, norm 3j+1)."""

    def __init__(self, cin: int, out_channels: Sequence[int], kdims: int = 1,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        mods = []
        for oc in out_channels:
            mods += [Conv1x1(cin, oc, kdims), GroupNormCL(8, oc), nn.SiLU()]
            cin = oc
        self.layers = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """`group`: x is a point shard (`GroupNormCL`)."""
        dt = self.dtype or torch.float32
        for i in range(0, len(self.layers), 3):
            x = self.layers[i](x, dt)
            x = self.layers[i + 1](x, dt, group, silu=True)
        return x


class Attention(nn.Module):
    """Self-attention over (B, S, C) without the 1/sqrt(C) scale, plus
    residual, GroupNorm and Swish (`modules/pvconv.py:17-63`). `kdims` = 3
    for the voxel attention (Conv3d keys), 1 for the global one."""

    def __init__(self, channels: int, num_groups: int = 8, kdims: int = 1,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.q = Conv1x1(channels, channels, kdims)
        self.k = Conv1x1(channels, channels, kdims)
        self.v = Conv1x1(channels, channels, kdims)
        self.out = Conv1x1(channels, channels, kdims)
        self.norm = GroupNormCL(num_groups, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("attention"):
            dt = self.dtype or torch.float32
            h = ops.attention(self.q(x, dt), self.k(x, dt), self.v(x, dt))
            x = x.to(dt) + self.out(h, dt)
            return self.norm(x, dt, silu=True)


class SE(nn.Module):
    """Squeeze-excitation gate of a (B, R, R, R, C) grid (`modules/se.py`),
    reduction 8, ReLU; returns the (B, C) float32 gate, which PVConv
    applies to the devoxelized points (it commutes with the linear
    devoxelization)."""

    def __init__(self, channels: int, reduction: int = 8, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid())

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.float32
        s = grid.float().mean(dim=(1, 2, 3)).to(dt)
        s = F.linear(s, self.fc[0].weight.to(dt))
        s = F.linear(F.relu(s), self.fc[2].weight.to(dt))
        return torch.sigmoid(s).float()


def timestep_mlp(embed_dim: int) -> nn.Sequential:
    """embedf: Linear -> LeakyReLU(0.1) -> Linear (`pvcnn.py:72-76`)."""
    return nn.Sequential(nn.Linear(embed_dim, embed_dim), nn.LeakyReLU(0.1),
                         nn.Linear(embed_dim, embed_dim))

