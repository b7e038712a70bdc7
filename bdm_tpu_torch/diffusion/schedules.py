"""Beta schedules (numpy only; copied from `bdm_tpu/diffusion/schedules.py`).

References:
  * PC2 linear schedule beta in [1e-5, 8e-3] — `config/structured.py:105-107`.
  * PC2 "custom" 30% warmup schedule — `model/model_utils.py:36-44`.
  * PVD linear / warm<frac> schedules — `pvd/__init__.py:430-447` (linear
    [1e-4, 2e-2] used by `prepare_pvd_model`, `pvd/__init__.py:477`).
"""

from __future__ import annotations

import numpy as np


def linear_betas(beta_start: float, beta_end: float,
                 num_train_timesteps: int = 1000) -> np.ndarray:
    """diffusers-style 'linear' schedule (float32 linspace)."""
    return np.linspace(beta_start, beta_end, num_train_timesteps,
                       dtype=np.float32)


def custom_betas(beta_start: float, beta_end: float,
                 num_train_timesteps: int = 1000) -> np.ndarray:
    """PC2's 'custom' warmup schedule: a float32 linspace whose first 30 %
    is overwritten by a float64 linspace over that window (the reference
    hard-codes the 0.3)."""
    betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                        dtype=np.float32)
    warmup_time = int(num_train_timesteps * 0.3)
    betas[:warmup_time] = np.linspace(beta_start, beta_end, warmup_time,
                                      dtype=np.float64)
    return betas


def pvd_betas(schedule_type: str = "linear", b_start: float = 1e-4,
              b_end: float = 2e-2, time_num: int = 1000) -> np.ndarray:
    """PVD's schedules, float64 as in the reference (the GaussianDiffusion
    tables are computed in float64): "linear", or "warm<frac>", b_end
    everywhere but a linear ramp over the first frac of the steps."""
    if schedule_type == "linear":
        return np.linspace(b_start, b_end, time_num)
    if schedule_type.startswith("warm"):
        betas = b_end * np.ones(time_num, dtype=np.float64)
        warmup_time = int(time_num * float(schedule_type[len("warm"):]))
        betas[:warmup_time] = np.linspace(b_start, b_end, warmup_time,
                                          dtype=np.float64)
        return betas
    raise NotImplementedError(schedule_type)
