"""BDM-Blending, the training-free coupled sampler
(`bdm_tpu/samplers/blending.py`, reference `main_blending.py:186-347`).

Between milestones the recon (PC2) branch denoises alone; at each interior
milestone both branches take one roll from the same x_t, one after the
other, and the results are mixed per point by a fair coin (0 = recon).

With `scheduler="ddim"` (`main_blending.py:214-222`) the recon branch runs
in the reduced DDIM step space while the prior, always DDPM at full
resolution, rolls 16 * roll_step steps from milestones rescaled by
1000 / 64.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import torch

from bdm_tpu_torch.samplers.noise import NoiseProvider
from bdm_tpu_torch.samplers.pc2 import PC2Model
from bdm_tpu_torch.samplers.pvd import PVDModel


def blend_point_clouds(a: torch.Tensor, b: torch.Tensor,
                       choice: torch.Tensor) -> torch.Tensor:
    """Per-point mix: choice (B, N) in {0, 1}, 0 takes `a`."""
    return torch.where((choice == 0)[..., None], a, b)


def prior_schedule(milestones: Sequence[int], roll_step: int,
                   scheduler: str) -> Tuple[List[int], int]:
    """The prior branch's (milestones, roll step) for the recon branch's:
    its own under "ddpm", the DDIM mapping under "ddim"."""
    if scheduler == "ddim":
        return [int(m / 64 * 1000) for m in milestones], int(roll_step * 16)
    if scheduler != "ddpm":
        raise ValueError(f"scheduler {scheduler!r}: 'ddpm' or 'ddim'")
    return [int(m) for m in milestones], roll_step


@torch.inference_mode()
def coupled_sampler(pc2: PC2Model, pvd: PVDModel, batch: Dict[str, Any],
                    num_points: int, milestones: Sequence[int],
                    roll_step: int, noise: Optional[NoiseProvider],
                    num_inference_steps: int, scheduler: str,
                    roll_short: int,
                    combine: Callable[..., torch.Tensor]) -> torch.Tensor:
    """The loop BDM-Blending and BDM-Merging share: recon segments
    between milestones and, at each interior milestone, a roll of each
    branch from the same x_t, one after the other, that stops `roll_short`
    steps before `milestone - roll_step`; then
    `combine(i, out_recon, out_prior, camera, cond, noise)` gives the next
    x_t. The batch's "mask" and "distance_transform" reach the
    conditioning where the configuration uses them. Returns (B, N, 3)
    points in the model's normalized space."""
    image, camera = batch["image"], batch["camera"]
    if noise is None:
        noise = NoiseProvider(device=image.device)
    m = [int(v) for v in milestones]
    pm, prior_roll = prior_schedule(m, roll_step, scheduler)
    times = len(m) - 1
    b = image.shape[0]
    x = noise.initial((b, num_points, 3))
    x = x - x.mean(dim=1, keepdim=True)
    raw = pc2.batch_conditioning(batch)
    # the fusion step reads the prepared map; the recon windows the map
    # in its sampling form (precontracted where that applies)
    cond = pc2.prepare_cond(raw)
    recon_cond = (pc2.precontract_cond(raw) if pc2.precontract_enabled
                  else cond)

    def recon(x, start, end, branch, i):
        return pc2.interaction_sample(
            x, batch, start, end, num_inference_steps,
            lambda j, n: noise.step(branch, i, j, n, x.shape), scheduler,
            cond=recon_cond)

    for i in range(times):
        if i == 0:
            x = recon(x, m[0], m[1] - roll_step, "seg", i)
        elif i == times - 1:
            x = recon(x, m[i] - roll_step, m[i + 1], "seg", i)
        else:
            x = recon(x, m[i] - roll_step, m[i + 1], "seg", i)
            out_recon = recon(x, m[i + 1],
                              m[i + 1] - roll_step + roll_short, "recon", i)
            out_prior = pvd.generate_window(
                x, pm[i + 1], pm[i + 1] - prior_roll + roll_short,
                lambda j, n, i=i: noise.step("prior", i, j, n, x.shape))
            x = combine(i, out_recon, out_prior, camera, cond, noise)
    return x


def bdm_blending(pc2: PC2Model, pvd: PVDModel, batch: Dict[str, Any],
                 num_points: int, milestones: Sequence[int], roll_step: int,
                 noise: Optional[NoiseProvider] = None,
                 num_inference_steps: int = 1000,
                 scheduler: str = "ddpm") -> torch.Tensor:
    """Run the blending sampler for one batch {"image": (B, H, W, 3),
    "camera": PerspectiveCamera}; returns (B, N, 3) points in the model's
    normalized space."""
    def mix(i, out_recon, out_prior, camera, cond, noise):
        return blend_point_clouds(out_recon, out_prior,
                                  noise.mask(i, out_recon.shape[:2]))

    return coupled_sampler(pc2, pvd, batch, num_points, milestones,
                           roll_step, noise, num_inference_steps, scheduler,
                           0, mix)
