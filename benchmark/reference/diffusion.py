"""The reverse steps and the forward noising, from the schedules' own
definitions: PC2's DDPM (diffusers' `DDPMScheduler.step`, variance
"fixed_small", no clipping) on linear betas, its coefficients in float32
as diffusers takes them from its float32 table (in float64, the ratio
acp_t / acp_prev of the last steps gives beta_t up to 0.3 % apart, which
moves the cloud by up to a hundredth of the network's part of the
step), PVD's Gaussian diffusion
("fixedsmall", eps prediction, no clipping) on float64 linear betas; and
BDM-Blending's blend. Each step is written as

    x_prev = a * x_t + c * eps + sigma * z

and `step` returns (x_prev, c), so a comparison can weigh the part of the
step that the network decides.
"""

from __future__ import annotations

import numpy as np
import torch


class DDPM:
    def __init__(self, beta_start: float, beta_end: float, steps: int = 1000,
                 inference_steps: int = 1000):
        betas = np.linspace(beta_start, beta_end, steps, dtype=np.float32)
        self.acp = np.cumprod(1.0 - betas.astype(np.float64)).astype(
            np.float32)
        self.ratio = steps // inference_steps
        self.inference_steps = inference_steps

    def timesteps(self) -> list:
        s = self.inference_steps
        return [int(t) for t in (np.arange(s) * self.ratio).round()[::-1]]

    def coefficients(self, t: int):
        """(a, c, sigma) of x_prev = a x_t + c eps + sigma z, from
        diffusers' float32 terms."""
        one = np.float32(1.0)
        acp = self.acp[t]
        prev = self.acp[t - self.ratio] if t >= self.ratio else one
        alpha = acp / prev
        beta = one - alpha
        c0 = np.sqrt(prev) * beta / (one - acp)
        ct = np.sqrt(alpha) * (one - prev) / (one - acp)
        var = max((one - prev) / (one - acp) * beta, np.float32(1e-20))
        sigma = float(np.sqrt(var)) if t > 0 else 0.0
        s1, sa = float(np.sqrt(one - acp)), float(np.sqrt(acp))
        return float(c0) / sa + float(ct), -float(c0) * s1 / sa, sigma

    def step(self, eps, t: int, x_t, z):
        a, c, sigma = self.coefficients(t)
        return a * x_t + c * eps + sigma * z, c

    def add_noise(self, x0, eps, t: torch.Tensor):
        acp = torch.from_numpy(self.acp).to(x0.device)[t].reshape(-1, 1, 1)
        return acp.sqrt() * x0 + (1.0 - acp).sqrt() * eps


class Gaussian:
    def __init__(self, beta_start: float, beta_end: float, steps: int = 1000):
        betas = np.linspace(beta_start, beta_end, steps)
        acp = np.cumprod(1.0 - betas)
        prev = np.append(1.0, acp[:-1])
        self.recip = np.sqrt(1.0 / acp)
        self.recipm1 = np.sqrt(1.0 / acp - 1.0)
        self.c1 = betas * np.sqrt(prev) / (1.0 - acp)
        self.c2 = (1.0 - prev) * np.sqrt(1.0 - betas) / (1.0 - acp)
        self.logvar = np.log(np.maximum(betas * (1.0 - prev) / (1.0 - acp),
                                        1e-20))

    def coefficients(self, t: int):
        a = self.c1[t] * self.recip[t] + self.c2[t]
        c = -self.c1[t] * self.recipm1[t]
        sigma = float(np.exp(0.5 * self.logvar[t])) if t != 0 else 0.0
        return float(a), float(c), sigma

    def step(self, eps, t: int, x_t, z):
        a, c, sigma = self.coefficients(t)
        return a * x_t + c * eps + sigma * z, c


def blend(recon: torch.Tensor, prior: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """BDM-Blending's per-point coin: 0 takes the recon branch's point."""
    return torch.where((mask == 0)[..., None], recon, prior)
