"""PNDM scheduler (`bdm_tpu/diffusion/pndm.py`): diffusers==0.21.0
`PNDMScheduler` with its defaults (`skip_prk_steps=False`,
`set_alpha_to_one=False`, `steps_offset=0`, epsilon prediction).

Four Runge-Kutta steps a timestep pair (PRK) warm up the linear multistep
phase (PLMS), which combines the last four eps predictions. The state is a
plain object on the device of x: the last four eps, the step counter, the
RK accumulator and the RK anchor sample. The counter is a Python int, so
the phase of a step is known on the host and a step syncs nothing with the
card; its transfer coefficients are float32 scalars computed in NumPy in
the JAX package's order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

f32 = np.float32


@dataclass
class PNDMState:
    ets: List[torch.Tensor] = field(default_factory=list)  # newest last
    counter: int = 0
    cur_model_output: Optional[torch.Tensor] = None   # RK accumulator
    cur_sample: Optional[torch.Tensor] = None         # RK anchor sample


class PNDMScheduler:
    """    ts = sched.set_timesteps(n)
    state = sched.init_state()
    for t in ts:
        x, state = sched.step(model(x, t), t, x, state)
    """

    pndm_order = 4

    def __init__(self, betas: np.ndarray, skip_prk_steps: bool = False):
        betas = np.asarray(betas, dtype=np.float64)
        self.num_train_timesteps = len(betas)
        acp = np.cumprod(1.0 - betas)
        self.alphas_cumprod = acp.astype(f32)
        # set_alpha_to_one=False: past the end, the first alpha product
        self.final_alpha_cumprod = f32(acp[0])
        self.skip_prk_steps = bool(skip_prk_steps)
        self.set_timesteps(self.num_train_timesteps)

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """The PRK timesteps, then the PLMS ones (int32)."""
        n = int(num_inference_steps)
        ratio = self.num_train_timesteps // n
        base = (np.arange(0, n) * ratio).round().astype(np.int64)
        if self.skip_prk_steps:
            prk = np.array([], dtype=np.int64)
            # the second-to-last step twice (diffusers' PLMS warm-up)
            plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
        else:
            prk = np.array(base[-self.pndm_order:]).repeat(2) + np.tile(
                np.array([0, ratio // 2], dtype=np.int64), self.pndm_order)
            prk = prk[:-1].repeat(2)[1:-1][::-1]
            plms = base[:-3][::-1]
        self._num_inference_steps = n
        self.prk_timesteps = prk.astype(np.int32)
        self.plms_timesteps = plms.astype(np.int32)
        return np.concatenate([self.prk_timesteps,
                               self.plms_timesteps]).astype(np.int32)

    @property
    def step_ratio(self) -> int:
        return self.num_train_timesteps // self._num_inference_steps

    def init_state(self) -> PNDMState:
        return PNDMState()

    def transfer(self, t: int, prev_t: int):
        """diffusers' `_get_prev_sample` coefficients at (t, prev_t):
        x_prev = coeff * x - diff * eps / denom -> (coeff, diff, denom)."""
        acp_t = self.alphas_cumprod[min(max(t, 0),
                                        self.num_train_timesteps - 1)]
        acp_prev = (self.alphas_cumprod[min(prev_t,
                                            self.num_train_timesteps - 1)]
                    if prev_t >= 0 else self.final_alpha_cumprod)
        coeff = np.sqrt(acp_prev / acp_t)
        denom = (acp_t * np.sqrt(f32(1.0) - acp_prev)
                 + np.sqrt(acp_t * (f32(1.0) - acp_t) * acp_prev))
        return float(coeff), float(acp_prev - acp_t), float(denom)

    def _prev_sample(self, sample, t, prev_t, model_output):
        coeff, diff, denom = self.transfer(t, prev_t)
        return coeff * sample - diff * model_output / denom

    def step(self, eps: torch.Tensor, t: int, x_t: torch.Tensor,
             state: PNDMState):
        """One reverse step -> (x_prev float32, the next state)."""
        eps = eps.float()
        t = int(t)
        ratio = self.step_ratio
        c = state.counter
        if c < len(self.prk_timesteps):
            return self._step_prk(eps, t, x_t, state, c, ratio)
        return self._step_plms(eps, t, x_t, state, c, ratio)

    def _step_prk(self, eps, t, x_t, state, c, ratio):
        prev_t = t - (0 if c % 2 else ratio // 2)
        t_prk = int(self.prk_timesteps[c // 4 * 4])
        ets, cur_sample = state.ets, state.cur_sample
        cmo = state.cur_model_output
        out = eps
        if c % 4 == 0:
            cmo = eps / 6.0 if cmo is None else cmo + eps / 6.0
            ets = (ets + [eps])[-4:]
            cur_sample = x_t
        elif c % 4 == 3:
            out = cmo + eps / 6.0
            cmo = None
        else:
            cmo = cmo + eps / 3.0
        prev = self._prev_sample(cur_sample, t_prk, prev_t, out)
        return prev, PNDMState(ets, c + 1, cmo, cur_sample)

    def _step_plms(self, eps, t, x_t, state, c, ratio):
        ets, cur_sample, sample = state.ets, state.cur_sample, x_t
        if c == 1:   # reached only with skip_prk_steps
            prev_t, t = t, t + ratio
            out = (eps + ets[-1]) / 2.0
            sample = cur_sample
        else:
            prev_t = t - ratio
            ets = (ets + [eps])[-4:]
            e = ets[::-1]
            if len(ets) == 1:
                out = e[0]
                if c == 0:
                    cur_sample = x_t
            elif len(ets) == 2:
                out = (3.0 * e[0] - e[1]) / 2.0
            elif len(ets) == 3:
                out = (23.0 * e[0] - 16.0 * e[1] + 5.0 * e[2]) / 12.0
            else:
                out = (55.0 * e[0] - 59.0 * e[1] + 37.0 * e[2]
                       - 9.0 * e[3]) / 24.0
        prev = self._prev_sample(sample, t, prev_t, out)
        return prev, PNDMState(ets, c + 1, state.cur_model_output,
                               cur_sample)
