"""BDM-Blending, the training-free coupled sampler
(`bdm_tpu/samplers/blending.py`, reference `main_blending.py:186-347`).

Between milestones the recon (PC2) branch denoises alone; at each interior
milestone both branches take one roll from the same x_t, one after the
other, and the results are mixed per point by a fair coin (0 = recon).
DDPM only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from bdm_tpu_torch.samplers.noise import NoiseProvider
from bdm_tpu_torch.samplers.pc2 import PC2Model
from bdm_tpu_torch.samplers.pvd import PVDModel


def blend_point_clouds(a: torch.Tensor, b: torch.Tensor,
                       choice: torch.Tensor) -> torch.Tensor:
    """Per-point mix: choice (B, N) in {0, 1}, 0 takes `a`."""
    return torch.where((choice == 0)[..., None], a, b)


@torch.inference_mode()
def bdm_blending(pc2: PC2Model, pvd: PVDModel, batch: Dict[str, Any],
                 num_points: int, milestones: Sequence[int], roll_step: int,
                 noise: Optional[NoiseProvider] = None,
                 num_inference_steps: int = 1000) -> torch.Tensor:
    """Run the blending sampler for one batch {"image": (B, H, W, 3),
    "camera": PerspectiveCamera}; returns (B, N, 3) points in the model's
    normalized space."""
    image, camera = batch["image"], batch["camera"]
    if noise is None:
        noise = NoiseProvider(device=image.device)
    m = [int(v) for v in milestones]
    times = len(m) - 1
    b = image.shape[0]
    x = noise.initial((b, num_points, 3))
    x = x - x.mean(dim=1, keepdim=True)
    cond = pc2.prepare_cond(pc2.conditioning_map(image))

    def recon(x, start, end, branch, i):
        return pc2.interaction_sample(
            x, camera, cond, start, end, num_inference_steps,
            lambda j, n: noise.step(branch, i, j, n, x.shape))

    for i in range(times):
        if i == 0:
            x = recon(x, m[0], m[1] - roll_step, "seg", i)
        elif i == times - 1:
            x = recon(x, m[i] - roll_step, m[i + 1], "seg", i)
        else:
            x = recon(x, m[i] - roll_step, m[i + 1], "seg", i)
            out_recon = recon(x, m[i + 1], m[i + 1] - roll_step, "recon", i)
            out_prior = pvd.generate_window(
                x, m[i + 1], m[i + 1] - roll_step,
                lambda j, n, i=i: noise.step("prior", i, j, n, x.shape))
            x = blend_point_clouds(out_recon, out_prior,
                                   noise.mask(i, (b, num_points)))
    return x
