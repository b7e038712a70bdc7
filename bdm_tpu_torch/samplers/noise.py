"""Where the samplers' randomness comes from.

The JAX package draws noise from keys inside its samplers; here every
draw goes through a provider, so a test can replay another generator's
numbers. A draw names its place in the trajectory: the initial cloud, step
`j` of an `n_steps` window of branch "seg" (the recon segment between
milestones), "recon" or "prior" (the two rolls at interior milestone
`i`), the blend mask of milestone `i` (BDM-Blending) and the fusion step
of milestone `i` (BDM-Merging).
"""

from __future__ import annotations

import torch

from bdm_tpu_torch import resolve_device


class NoiseProvider:
    """Default provider: standard normals and fair coins from one
    torch.Generator on the target device (the card unless the caller
    passes `device="cpu"`)."""

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _normal(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device)

    def initial(self, shape) -> torch.Tensor:
        return self._normal(shape)

    def step(self, branch: str, i: int, j: int, n_steps: int,
             shape) -> torch.Tensor:
        return self._normal(shape)

    def fuse(self, i: int, shape) -> torch.Tensor:
        """The noise of the scheduler step after the fusion forward."""
        return self._normal(shape)

    def mask(self, i: int, shape) -> torch.Tensor:
        """(B, N) in {0, 1}; 0 selects the recon branch."""
        return torch.randint(0, 2, shape, generator=self.gen,
                             device=self.device)
