"""DDIM scheduler with diffusers==0.21.0 step semantics
(`bdm_tpu/diffusion/ddim.py`: clip_sample=False, steps_offset=0,
set_alpha_to_one); the noise of a step with eta > 0 is passed in.

    x0_hat = (x_t - sqrt(1-acp_t) * eps) / sqrt(acp_t)
    std    = eta * sqrt((1-acp_prev)/(1-acp_t) * (1 - acp_t/acp_prev))
    x_prev = sqrt(acp_prev) * x0_hat + sqrt(1 - acp_prev - std^2) * eps
             + std * z

As in `ddpm.py`, the per-step coefficients are float32 scalars computed
on the host in the reference's order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bdm_tpu_torch.diffusion.ddpm import AlphaTable, f32


class DDIMScheduler(AlphaTable):
    def coefficients(self, t: int, eta: float = 0.0):
        """(sqrt(1-acp_t), sqrt(acp_t), sqrt(acp_prev), direction scale,
        noise scale)."""
        acp_t, acp_prev = self.alphas_at(t)
        beta_prod_t = f32(1.0) - acp_t
        variance = ((f32(1.0) - acp_prev) / (f32(1.0) - acp_t)) * (
            f32(1.0) - acp_t / acp_prev)
        std = f32(eta) * np.sqrt(variance)
        direction = np.sqrt(f32(1.0) - acp_prev - std ** 2)
        return (float(np.sqrt(beta_prod_t)), float(np.sqrt(acp_t)),
                float(np.sqrt(acp_prev)), float(direction), float(std))

    def step(self, eps: torch.Tensor, t: int, x_t: torch.Tensor,
             noise: Optional[torch.Tensor] = None,
             eta: float = 0.0) -> torch.Tensor:
        """One reverse step x_t -> x_{t - step_ratio} (float32); `noise`
        is needed only when eta > 0."""
        s1, sa, sp, direction, std = self.coefficients(t, eta)
        eps = eps.float()
        x0_hat = (x_t - s1 * eps) / sa
        prev = sp * x0_hat + direction * eps
        if eta > 0:
            if noise is None:
                raise ValueError("DDIMScheduler.step: eta > 0 needs noise")
            prev = prev + std * noise
        return prev
