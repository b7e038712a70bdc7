"""PVD's Gaussian diffusion (`bdm_tpu/diffusion/gaussian.py`): tables in
float64, cast to float32; eps prediction; the 'fixedsmall' posterior
variance with its log clipped at 1e-20, or 'fixedlarge' (the betas, with
the posterior variance at t = 0); optionally x0 clipped to [-0.5, 0.5];
no noise at t == 0. The noise is passed in."""

from __future__ import annotations

import numpy as np
import torch

from bdm_tpu_torch.diffusion.ddpm import ForwardTables

f32 = np.float32


class GaussianDiffusion:
    def __init__(self, betas: np.ndarray, model_var_type: str = "fixedsmall"):
        if model_var_type not in ("fixedsmall", "fixedlarge"):
            raise NotImplementedError(model_var_type)
        betas = np.asarray(betas, dtype=np.float64)
        assert (betas > 0).all() and (betas <= 1).all()
        self.num_timesteps = len(betas)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        # q_sample(x0, noise, t): the float64 tables rounded once
        self.q_tables = ForwardTables(np.sqrt(acp), np.sqrt(1.0 - acp))
        self.sqrt_recip_acp = np.sqrt(1.0 / acp).astype(f32)
        self.sqrt_recipm1_acp = np.sqrt(1.0 / acp - 1.0).astype(f32)
        self.posterior_mean_coef1 = (
            betas * np.sqrt(acp_prev) / (1.0 - acp)).astype(f32)
        self.posterior_mean_coef2 = (
            (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)).astype(f32)
        if model_var_type == "fixedsmall":
            self.log_variance = np.log(np.maximum(post_var, 1e-20)).astype(
                f32)
        else:
            self.log_variance = np.log(np.concatenate(
                [post_var[1:2], betas[1:]])).astype(f32)

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) for per-sample timesteps t (B,) int (the
        reference's argument order)."""
        return self.q_tables(x0, noise, t)

    def p_sample(self, denoise_fn, x_t: torch.Tensor, t: int,
                 noise: torch.Tensor,
                 clip_denoised: bool = False) -> torch.Tensor:
        """One reverse step at integer timestep t (shared by the batch)."""
        t = int(t)
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long,
                        device=x_t.device)
        eps = denoise_fn(x_t, tb).float()
        x0 = (float(self.sqrt_recip_acp[t]) * x_t
              - float(self.sqrt_recipm1_acp[t]) * eps)
        if clip_denoised:
            x0 = x0.clamp(-0.5, 0.5)
        mean = (float(self.posterior_mean_coef1[t]) * x0
                + float(self.posterior_mean_coef2[t]) * x_t)
        sigma = f32(float(t != 0)) * np.exp(f32(0.5) * self.log_variance[t])
        return mean + float(sigma) * noise
