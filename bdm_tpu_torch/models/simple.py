"""Simple (non-PVCNN) point backbones (`bdm_tpu/models/simple.py`).

  * SimplePointModel — gated feed-forward blocks over [point features |
    max-pool | std-pool] global context, with a NeRF-style positional
    encoding of xyz (10 octaves) and the shared sinusoidal t-embedding.
    No kernel runs in it: it is dense layers and reductions.
  * PVCNN2PlusPlus — SimplePointModel -> residual PVCNN2 (whose stage-0
    input is xyz + 64 channels, through the voxel kernels) -> MLP head.

The JAX package has no reference checkpoint for these, so the state-dict
keys follow its module names (`embedf`, `input_projection`,
`blocks.<i>.{norm,proj_in,gate,proj_out}`, `final_norm`,
`output_projection`; `simple`, `pvcnn`, `head_fc`). `dtype` is the compute
dtype: dense layers run in it, the layer norms and the heads in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from bdm_tpu_torch.models.layers import (get_timestep_embedding, swish,
                                         timestep_mlp)
from bdm_tpu_torch.models.pvcnn import (PVCNN_FP_BLOCKS, PVCNN_SA_BLOCKS,
                                        PVCNN2, init_uniform)

LN_EPS = 1e-6  # flax's LayerNorm default


def _linear(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def _layer_norm(layer: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """Statistics in float32, output in `dtype` (flax's LayerNorm)."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps).to(dtype)


class PositionalEncoding(nn.Module):
    """[x | sin(2^k x) | cos(2^k x) for k < num_freqs], per channel
    triple, in that order."""

    def __init__(self, num_freqs: int = 10):
        super().__init__()
        self.num_freqs = num_freqs

    @property
    def out_dim_per_channel(self) -> int:
        return 1 + 2 * self.num_freqs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = [x]
        for k in range(self.num_freqs):
            f = float(2.0 ** k)
            parts += [torch.sin(f * x), torch.cos(f * x)]
        return torch.cat(parts, dim=-1)


class GatedFeedForward(nn.Module):
    """x + proj_out(proj_in(h) * tanh(softplus(gate(h)))), h the layer norm
    of [x | max over points | std over points (float32)]."""

    def __init__(self, d: int, hidden_mult: int = 2, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(3 * d, eps=LN_EPS)
        self.proj_in = nn.Linear(3 * d, d * hidden_mult)
        self.gate = nn.Linear(3 * d, d * hidden_mult)
        self.proj_out = nn.Linear(d * hidden_mult, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.float32
        gmax = x.amax(dim=1, keepdim=True)
        gstd = x.float().std(dim=1, unbiased=False, keepdim=True).to(x.dtype)
        h = torch.cat([x, gmax.expand_as(x), gstd.expand_as(x)], dim=-1)
        h = _layer_norm(self.norm, h, dt)
        h = (_linear(self.proj_in, h, dt)
             * torch.tanh(F.softplus(_linear(self.gate, h, dt))))
        return x + _linear(self.proj_out, h, dt)


class SimplePointModel(nn.Module):
    """forward(inputs (B, N, 3 + S), t (B,)) -> (B, N, out_channels)
    float32."""

    def __init__(self, out_channels: int = 3, embed_dim: int = 64,
                 extra_feature_channels: int = 3, dim: int = 128,
                 num_layers: int = 6, num_freqs: int = 10,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.embedf = timestep_mlp(embed_dim)
        self.pos = PositionalEncoding(num_freqs)
        cin = (3 * self.pos.out_dim_per_channel + extra_feature_channels
               + embed_dim)
        self.input_projection = nn.Linear(cin, dim)
        self.blocks = nn.ModuleList(
            [GatedFeedForward(dim, dtype=dtype) for _ in range(num_layers)])
        self.final_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.output_projection = nn.Linear(dim, out_channels)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random weights from `seed` (`init_uniform`, unit layer-norm
        scales); the output projection N(0, 1e-6^2), as the JAX init."""
        g = torch.Generator().manual_seed(seed)
        init_uniform(self, g)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
        for p in self.output_projection.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 1e-6)

    def forward(self, inputs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.float32
        n = inputs.shape[1]
        temb = self.embedf(get_timestep_embedding(self.embed_dim, t))
        x = torch.cat([self.pos(inputs[..., :3].float()),
                       inputs[..., 3:].float(),
                       temb[:, None, :].expand(-1, n, -1)], dim=-1)
        x = _linear(self.input_projection, x, dt)
        for block in self.blocks:
            x = block(x)
        x = _layer_norm(self.final_norm, x, torch.float32)
        return self.output_projection(x)


class PVCNN2PlusPlus(nn.Module):
    """SimplePointModel features -> PVCNN2 on [xyz | features] (stage-0
    input 3 + dim channels), added back -> swish(head_fc) ->
    output_projection. `sa_blocks` / `fp_blocks` are the inner PVCNN2's
    (the published ones by default, as in the JAX package)."""

    def __init__(self, out_channels: int = 3, embed_dim: int = 64,
                 extra_feature_channels: int = 3, dim: int = 64,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.1,
                 sa_blocks=PVCNN_SA_BLOCKS, fp_blocks=PVCNN_FP_BLOCKS):
        super().__init__()
        self.simple = SimplePointModel(
            out_channels=dim, embed_dim=embed_dim,
            extra_feature_channels=extra_feature_channels, dim=dim,
            num_layers=2, dtype=dtype)
        self.pvcnn = PVCNN2(out_channels=dim, embed_dim=embed_dim,
                            extra_feature_channels=dim,
                            sa_blocks=sa_blocks, fp_blocks=fp_blocks,
                            classifier_init_scale=None, dtype=dtype,
                            dropout=dropout)
        self.head_fc = nn.Linear(dim, dim)
        self.output_projection = nn.Linear(dim, out_channels)
        self.eval()

    @property
    def specs(self):
        return self.pvcnn.specs

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        g = torch.Generator().manual_seed(seed)
        init_uniform(self, g)
        self.simple.reset_parameters(seed + 1)
        self.pvcnn.reset_parameters(seed + 2)
        for p in self.output_projection.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 1e-6)

    def forward(self, inputs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        feats = self.simple(inputs, t)
        pv = self.pvcnn(torch.cat([inputs[..., :3].float(), feats], -1), t)
        x = swish(self.head_fc(feats + pv))
        return self.output_projection(x)
