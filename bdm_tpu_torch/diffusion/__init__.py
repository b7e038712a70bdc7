"""Schedulers: PC2's DDPM, DDIM and PNDM, and PVD's Gaussian diffusion."""

from bdm_tpu_torch.diffusion.ddim import DDIMScheduler
from bdm_tpu_torch.diffusion.ddpm import DDPMScheduler
from bdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
from bdm_tpu_torch.diffusion.pndm import PNDMScheduler, PNDMState
from bdm_tpu_torch.diffusion.schedules import (custom_betas, linear_betas,
                                               pvd_betas)

__all__ = ["DDIMScheduler", "DDPMScheduler", "GaussianDiffusion",
           "PNDMScheduler", "PNDMState", "custom_betas", "linear_betas",
           "make_scheduler", "pvd_betas"]

_SCHEDULERS = {"ddpm": DDPMScheduler, "ddim": DDIMScheduler,
               "pndm": PNDMScheduler}


def make_scheduler(name: str, beta_start: float, beta_end: float,
                   beta_schedule: str = "linear",
                   num_train_timesteps: int = 1000):
    """The reference's `schedulers_map` (`model.py:58-62`): "ddpm",
    "ddim" or "pndm" on the "linear" or "custom" betas."""
    if beta_schedule == "custom":
        betas = custom_betas(beta_start, beta_end, num_train_timesteps)
    elif beta_schedule == "linear":
        betas = linear_betas(beta_start, beta_end, num_train_timesteps)
    else:
        raise ValueError(f"Unknown beta schedule: {beta_schedule}")
    if name not in _SCHEDULERS:
        raise ValueError(f"Unknown scheduler: {name}")
    return _SCHEDULERS[name](betas)
