"""Schedulers: PC2's DDPM and DDIM, and PVD's Gaussian diffusion."""

from bdm_tpu_torch.diffusion.ddim import DDIMScheduler
from bdm_tpu_torch.diffusion.ddpm import DDPMScheduler
from bdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from bdm_tpu_torch.diffusion.schedules import linear_betas, pvd_betas

__all__ = ["DDIMScheduler", "DDPMScheduler", "GaussianDiffusion",
           "linear_betas", "pvd_betas"]
