"""DDPM scheduler with diffusers==0.21.0 step semantics
(`bdm_tpu/diffusion/ddpm.py`); the noise of each step is passed in.

    x0_hat = (x_t - sqrt(1-acp_t) * eps) / sqrt(acp_t)
    mean   = sqrt(acp_prev)*beta_t/(1-acp_t) * x0_hat
             + sqrt(alpha_t)*(1-acp_prev)/(1-acp_t) * x_t
    var    = max((1-acp_prev)/(1-acp_t) * beta_t, 1e-20)
    x_prev = mean + [t > 0] * sqrt(var) * z

The per-step coefficients are float32 scalars computed on the host in the
reference's order, so a step is a handful of elementwise ops on the card.
"""

from __future__ import annotations

import numpy as np
import torch

f32 = np.float32


class ForwardTables:
    """q(x_t | x_0) = sqrt_acp[t] * x0 + sqrt_one_minus[t] * noise for
    per-sample timesteps t (B,) int. The two float32 tables are kept on
    every device they are asked for, so a training step indexes them there
    and the host does not wait for t."""

    def __init__(self, sqrt_acp: np.ndarray, sqrt_one_minus: np.ndarray):
        self.host = (torch.from_numpy(sqrt_acp.astype(f32)),
                     torch.from_numpy(sqrt_one_minus.astype(f32)))
        self.on = {}

    def __call__(self, x0: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
        if x0.device not in self.on:
            self.on[x0.device] = tuple(a.to(x0.device) for a in self.host)
        a, s = self.on[x0.device]
        shape = (-1,) + (1,) * (x0.dim() - 1)
        return a[t].reshape(shape) * x0 + s[t].reshape(shape) * noise


class AlphaTable:
    """What the DDPM and DDIM schedulers share: the cumulative alphas and
    the descending inference timesteps."""

    def __init__(self, betas: np.ndarray):
        betas = np.asarray(betas, dtype=np.float64)
        self.num_train_timesteps = len(betas)
        self.alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        self._num_inference_steps = self.num_train_timesteps
        # add_noise(x0, noise, t): float32 square roots of the float32
        # table, as the reference takes them
        self.add_noise = ForwardTables(
            np.sqrt(self.alphas_cumprod),
            np.sqrt(f32(1.0) - self.alphas_cumprod))

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending timesteps: round(arange(S) * (T // S)) reversed."""
        self._num_inference_steps = int(num_inference_steps)
        s = self._num_inference_steps
        return (np.arange(0, s) * self.step_ratio).round()[::-1].astype(
            np.int32)

    @property
    def step_ratio(self) -> int:
        return self.num_train_timesteps // self._num_inference_steps

    def alphas_at(self, t: int):
        """(acp_t, acp_prev) as float32 scalars; acp_prev is 1 past the
        last step."""
        prev_t = int(t) - self.step_ratio
        return (self.alphas_cumprod[int(t)],
                self.alphas_cumprod[prev_t] if prev_t >= 0 else f32(1.0))


class DDPMScheduler(AlphaTable):
    def coefficients(self, t: int):
        """(sqrt(1-acp_t), sqrt(acp_t), coef_x0, coef_xt, noise scale)."""
        acp_t, acp_prev = self.alphas_at(t)
        beta_prod_t = f32(1.0) - acp_t
        beta_prod_prev = f32(1.0) - acp_prev
        current_alpha = acp_t / acp_prev
        current_beta = f32(1.0) - current_alpha
        coef_x0 = np.sqrt(acp_prev) * current_beta / beta_prod_t
        coef_xt = np.sqrt(current_alpha) * beta_prod_prev / beta_prod_t
        var = max(beta_prod_prev / beta_prod_t * current_beta, f32(1e-20))
        sigma = f32(float(int(t) > 0)) * np.sqrt(f32(var))
        return (float(np.sqrt(beta_prod_t)), float(np.sqrt(acp_t)),
                float(coef_x0), float(coef_xt), float(sigma))

    def step(self, eps: torch.Tensor, t: int, x_t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
        """One reverse step x_t -> x_{t - step_ratio} (float32)."""
        s1, sa, c0, ct, sigma = self.coefficients(t)
        eps = eps.float()
        x0_hat = (x_t - s1 * eps) / sa
        return (c0 * x0_hat + ct * x_t) + sigma * noise
