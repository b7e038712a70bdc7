"""Beta schedules (numpy only; copied from `bdm_tpu/diffusion/schedules.py`).

References:
  * PC2 linear schedule beta in [1e-5, 8e-3] — `config/structured.py:105-107`.
  * PVD linear schedule [1e-4, 2e-2] — `pvd/__init__.py:430-447`, used by
    `prepare_pvd_model` (`pvd/__init__.py:477`).
"""

from __future__ import annotations

import numpy as np


def linear_betas(beta_start: float, beta_end: float,
                 num_train_timesteps: int = 1000) -> np.ndarray:
    """diffusers-style 'linear' schedule (float32 linspace)."""
    return np.linspace(beta_start, beta_end, num_train_timesteps,
                       dtype=np.float32)


def pvd_betas(b_start: float = 1e-4, b_end: float = 2e-2,
              time_num: int = 1000) -> np.ndarray:
    """PVD's linear schedule, float64 as in the reference (the
    GaussianDiffusion tables are computed in float64)."""
    return np.linspace(b_start, b_end, time_num)
