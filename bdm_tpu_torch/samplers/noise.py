"""Where the samplers' and the training losses' randomness comes from.

The JAX package draws noise from keys inside its samplers; here every
draw goes through a provider, so a test can replay another generator's
numbers. A draw names its place in the trajectory: the initial cloud, step
`j` of an `n_steps` window of branch "seg" (the recon segment between
milestones), "recon" or "prior" (the two rolls at interior milestone
`i`), the blend mask of milestone `i` (BDM-Blending) and the fusion step
of milestone `i` (BDM-Merging). A training loss draws one pair a step:
the timesteps and the noise (`TrainNoise`); dropout masks come from
PyTorch's own generator.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

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


class TrainNoise:
    """What a training loss draws each step: `draw(shape, num_timesteps)`
    -> (t (B,) int64 uniform in [0, T), standard normal noise of `shape`),
    from one torch.Generator on the target device.

    With `replay`, an iterable of (t, noise) array pairs made elsewhere
    (a test replays the reference's key tree), the pairs are handed out in
    order instead."""

    def __init__(self, seed: int = 0, device=None,
                 replay: Optional[Iterable] = None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.replay = None if replay is None else iter(replay)

    def draw(self, shape, num_timesteps: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.replay is not None:
            t, noise = next(self.replay)
            t = torch.as_tensor(t).to(self.device, torch.long)
            noise = torch.as_tensor(noise).to(self.device, torch.float32)
            if t.shape != (shape[0],) or noise.shape != tuple(shape):
                raise ValueError(f"TrainNoise: replayed t {tuple(t.shape)}, "
                                 f"noise {tuple(noise.shape)} for {shape}")
            return t, noise
        t = torch.randint(0, int(num_timesteps), (shape[0],),
                          generator=self.gen, device=self.device)
        return t, torch.randn(shape, generator=self.gen, device=self.device)
