"""PVD, the unconditional point-cloud prior (`bdm_tpu/samplers/pvd.py`):
a PVCNN2 with no extra feature channels driven by the Gaussian diffusion,
by default 'fixedsmall' on betas linear(1e-4, 0.02, 1000). The model lives
on the card unless the caller passes `device="cpu"`."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from bdm_tpu_torch import resolve_device
from bdm_tpu_torch.diffusion import GaussianDiffusion, pvd_betas
from bdm_tpu_torch.models.layers import dropout_masks
from bdm_tpu_torch.models.pvcnn import (PVCNN_FP_BLOCKS, PVCNN_SA_BLOCKS,
                                        PVCNN2)
from bdm_tpu_torch.samplers.noise import NoiseProvider, TrainNoise
from bdm_tpu_torch.samplers.pc2 import compute_dtype_of


class PVDModel(nn.Module):
    """State-dict keys `model.*`, as the reference PVD checkpoint."""

    def __init__(self, embed_dim: int = 64, use_att: bool = True,
                 beta_start: float = 1e-4, beta_end: float = 2e-2,
                 num_timesteps: int = 1000, schedule_type: str = "linear",
                 model_var_type: str = "fixedsmall",
                 sa_blocks=PVCNN_SA_BLOCKS,
                 fp_blocks=PVCNN_FP_BLOCKS, mixed_precision: str = "no",
                 device=None, dropout: float = 0.1,
                 width_multiplier: int = 1,
                 voxel_resolution_multiplier: int = 1):
        device = resolve_device(device)
        super().__init__()
        self.model = PVCNN2(out_channels=3, embed_dim=embed_dim,
                            extra_feature_channels=0, use_att=use_att,
                            sa_blocks=sa_blocks, fp_blocks=fp_blocks,
                            classifier_init_scale=None,
                            dtype=compute_dtype_of(mixed_precision),
                            dropout=dropout,
                            width_multiplier=width_multiplier,
                            voxel_resolution_multiplier=(
                                voxel_resolution_multiplier))
        self.diffusion = GaussianDiffusion(
            pvd_betas(schedule_type, beta_start, beta_end, num_timesteps),
            model_var_type)
        self.to(device).eval()

    def reset_parameters(self, seed: int = 0) -> None:
        self.model.reset_parameters(seed)

    def loss(self, x0: torch.Tensor, noise: TrainNoise) -> torch.Tensor:
        """eps-MSE training loss of clouds x0 (B, N, 3): t uniform in
        [0, T), x_t = q_sample(x0), mean((eps_hat - eps)^2); dropout masks
        from `noise`."""
        t, eps = noise.draw(x0.shape, self.diffusion.num_timesteps)
        x_t = self.diffusion.q_sample(x0, t, eps)
        with dropout_masks(noise):
            eps_hat = self.model(x_t, t)
        return torch.mean((eps_hat - eps) ** 2)

    @torch.inference_mode()
    def generate_window(self, x: torch.Tensor, start_time: int,
                        final_time: int,
                        noise: Callable[[int, int], torch.Tensor]
                        ) -> torch.Tensor:
        """Reverse-diffuse x (B, N, 3) from t = start_time - 1 down to
        t = final_time; `noise(j, n_steps)` gives step j's noise."""
        steps = int(start_time) - int(final_time)
        for j, t in enumerate(range(int(start_time) - 1,
                                    int(final_time) - 1, -1)):
            x = self.diffusion.p_sample(self.model, x, t, noise(j, steps))
        return x

    @torch.inference_mode()
    def sample(self, shape, noise: Optional[NoiseProvider] = None
               ) -> torch.Tensor:
        """Unconditional generation: `noise.initial(shape)` reverse-diffused
        over the whole chain, t = T - 1 down to 0; step j draws
        `noise.step("seg", 0, j, T, shape)`."""
        if noise is None:
            noise = NoiseProvider(device=next(self.parameters()).device)
        return self.generate_window(
            noise.initial(shape), self.diffusion.num_timesteps, 0,
            lambda j, n: noise.step("seg", 0, j, n, shape))
