"""The point-cloud colouring model (`bdm_tpu/models/coloring.py`,
reference `model/model_coloring.py` and
`point_cloud_transformer_model.py`): per-point RGB from one forward (no
diffusion) through an input projection, a stack of [LayerNorm -> PVCNN2 at
t = 0, residual; LayerNorm -> MLP, residual] blocks and an output
projection, trained with the colour MSE. The conditioning is PC2's
(`samplers.pc2.ProjectionConditioned`).

The backbone runs in float32 whatever `mixed_precision` says: the JAX
blocks give their PVCNN2, Dense layers and LayerNorms no dtype. So on the
card its attention and convs take the CUDA-core kernels and the
three-neighbour blend its float32 gather form. Its geometry kernels (FPS,
ball query, three-NN, voxelization) read the first three channels of the
LayerNormed embedding as coordinates, as the JAX PVCNN2 does.

State-dict keys are the JAX module names (`point_cloud_model.block{i}.norm0`,
`.pvcnn.*` with the reference PVCNN2 keys, `.norm2`, `.mlp_fc1`, `.mlp_fc2`,
`point_cloud_model.input_projection`, `.output_projection`,
`feature_model.model.*`): the reference publishes no colouring checkpoint
layout. The model lives on the card unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from bdm_tpu_torch import resolve_device
from bdm_tpu_torch.models.layers import dropout_masks
from bdm_tpu_torch.models.pvcnn import (PVCNN_FP_BLOCKS, PVCNN_SA_BLOCKS,
                                        PVCNN2, init_uniform)
from bdm_tpu_torch.samplers.noise import TrainNoise
from bdm_tpu_torch.samplers.pc2 import ProjectionConditioned, ProjectionConfig

LN_EPS = 1e-6   # flax's LayerNorm epsilon; torch's default is 1e-5


class PointCloudModelBlock(nn.Module):
    """x + PVCNN2(LN0(x), t = 0), then x + fc2(gelu(fc1(LN2(x)))), the
    GELU exact and the MLP `mlp_ratio` times as wide. The inner PVCNN2
    keeps the block's width (out = embed = dim, extra = dim - 3), PVCNN2's
    dropout (0.1) and no head re-init. The attention sub-block (`use_attn`) is never switched on
    by `PointCloudTransformerModel`, and flax refuses its 6 heads at width
    64: it is not ported."""

    def __init__(self, dim: int, use_attn: bool = False, num_heads: int = 6,
                 mlp_ratio: float = 4.0, sa_blocks=PVCNN_SA_BLOCKS,
                 fp_blocks=PVCNN_FP_BLOCKS):
        super().__init__()
        if use_attn:
            raise NotImplementedError(
                "PointCloudModelBlock: use_attn is unreachable from "
                "PointCloudTransformerModel and is not ported")
        self.norm0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.pvcnn = PVCNN2(out_channels=dim, embed_dim=dim,
                            extra_feature_channels=dim - 3,
                            sa_blocks=sa_blocks, fp_blocks=fp_blocks,
                            classifier_init_scale=None)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = nn.Linear(dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t0 = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
        x = x + self.pvcnn(self.norm0(x), t0)
        h = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none")
        return x + self.mlp_fc2(h)


class PointCloudTransformerModel(nn.Module):
    """(B, N, in_channels) -> (B, N, out_channels): `input_projection`,
    `num_layers` blocks, `output_projection` (kernel and bias initialised
    N(0, 1e-6^2), as the JAX module's)."""

    def __init__(self, num_layers: int = 1, in_channels: int = 3,
                 out_channels: int = 3, embed_dim: int = 64,
                 sa_blocks=PVCNN_SA_BLOCKS, fp_blocks=PVCNN_FP_BLOCKS):
        super().__init__()
        self.num_layers = num_layers
        self.input_projection = nn.Linear(in_channels, embed_dim)
        for i in range(num_layers):
            self.add_module(f"block{i}", PointCloudModelBlock(
                embed_dim, sa_blocks=sa_blocks, fp_blocks=fp_blocks))
        self.output_projection = nn.Linear(embed_dim, out_channels)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random weights from `seed` (`init_uniform`), unit LayerNorm
        scales, the output projection N(0, 1e-6^2)."""
        g = torch.Generator().manual_seed(seed)
        init_uniform(self, g)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
        for p in self.output_projection.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 1e-6)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.input_projection(inputs)
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x)
        return self.output_projection(x)


class PointCloudColoringModel(ProjectionConditioned):
    """Colour prediction with PC2's conditioning
    (`model_coloring.py:13-81`): [points | projected map] through
    `PointCloudTransformerModel`. `predict` gives RGB in [0, 1]; `loss`
    the colour MSE of a batch with "colors", trained through
    `train.make_train_step` / `train_loop` like the other losses."""

    def __init__(self, cfg: Optional[ProjectionConfig] = None,
                 point_cloud_model_layers: int = 1,
                 sa_blocks=PVCNN_SA_BLOCKS, fp_blocks=PVCNN_FP_BLOCKS,
                 vit_kwargs: Optional[dict] = None, device=None):
        if cfg is None:
            cfg = ProjectionConfig(predict_shape=False, predict_color=True)
        if not (cfg.predict_color and not cfg.predict_shape):
            raise ValueError("coloring predicts color, not shape")
        device = resolve_device(device)
        super().__init__(cfg, vit_kwargs)
        self.point_cloud_model = PointCloudTransformerModel(
            num_layers=point_cloud_model_layers,
            in_channels=self.in_channels, out_channels=self.out_channels,
            embed_dim=cfg.point_cloud_model_embed_dim, sa_blocks=sa_blocks,
            fp_blocks=fp_blocks)
        self.to(device).eval()

    def reset_parameters(self, seed: int = 0) -> None:
        self.point_cloud_model.reset_parameters(seed)
        if hasattr(self.feature_model, "model"):
            self.feature_model.model.reset_parameters(seed + 1)

    def _predict_colors(self, points: torch.Tensor,
                        batch: Dict[str, Any]) -> torch.Tensor:
        cond = self.batch_conditioning(batch)
        return self.point_cloud_model(
            self.x_t_input(points, batch["camera"], cond))

    def loss(self, batch: Dict[str, Any], noise: TrainNoise,
             noise_std: float = 0.0) -> torch.Tensor:
        """Colour MSE of a batch {"image", "camera", "points", "colors"
        (B, N, 3) in [0, 1]}: the points, scaled, moved by `noise_std`
        times the noise `noise.draw` gives (its timesteps go unused);
        dropout follows the module's mode and takes its masks from
        `noise`."""
        pts = batch["points"] * self.cfg.scale_factor
        colors = (batch["colors"] - self.cfg.colors_mean) / self.cfg.colors_std
        _, eps = noise.draw(pts.shape, 1)
        with dropout_masks(noise):
            pred = self._predict_colors(pts + noise_std * eps, batch)
        return torch.mean((pred - colors) ** 2)

    @torch.inference_mode()
    def predict(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One forward: (B, N, 3) RGB in [0, 1]."""
        pred = self._predict_colors(batch["points"] * self.cfg.scale_factor,
                                    batch)
        return torch.clamp(pred * self.cfg.colors_std + self.cfg.colors_mean,
                           0.0, 1.0)
