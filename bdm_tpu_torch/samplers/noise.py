"""Where the samplers' and the training losses' randomness comes from.

The JAX package draws noise from keys inside its samplers; here every
draw goes through a provider, so a test can replay another generator's
numbers. A draw names its place in the trajectory: the initial cloud, step
`j` of an `n_steps` window of branch "seg" (the recon segment between
milestones), "recon" or "prior" (the two rolls at interior milestone
`i`), the blend mask of milestone `i` (BDM-Blending) and the fusion step
of milestone `i` (BDM-Merging). A training loss draws one pair a step,
the timesteps and the noise, and its dropout keep-masks, all from one
`TrainNoise`.
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


def _dropout_seed(seed: int) -> int:
    """The dropout generator's seed: one step of Knuth's MMIX linear
    congruential generator from `seed`, so its stream is not the
    timesteps' and noise's."""
    return (int(seed) * 6364136223846793005 + 1442695040888963407) % 2 ** 64


class TrainNoise:
    """What a training loss draws each step: `draw(shape, num_timesteps)`
    -> (t (B,) int64 uniform in [0, T), standard normal noise of `shape`),
    from one torch.Generator on the target device; and, while the loss runs
    its forward (`models.layers.dropout_masks`), `keep_mask(shape, p)` ->
    a Bernoulli(1 - p) bool keep-mask for each dropout site in the order
    the sites run, from a second generator seeded from `seed`.

    With `replay`, an iterable of (t, noise) array pairs made elsewhere
    (a test replays the reference's key tree), the pairs are handed out in
    order instead; an item (t, noise, masks) also replays that step's
    keep-masks, one array a dropout site in the order the sites run."""

    def __init__(self, seed: int = 0, device=None,
                 replay: Optional[Iterable] = None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(
            _dropout_seed(seed))
        self.replay = None if replay is None else iter(replay)
        self.masks = None   # this step's replayed keep-masks, if any

    def keep_mask(self, shape, p: float) -> torch.Tensor:
        if self.masks is not None:
            keep = next(self.masks, None)
            if keep is None:
                raise ValueError("TrainNoise: no replayed mask left for a "
                                 f"dropout site of shape {tuple(shape)}")
            keep = torch.as_tensor(keep).to(self.device, torch.bool)
            if keep.shape != tuple(shape):
                raise ValueError(f"TrainNoise: replayed mask "
                                 f"{tuple(keep.shape)} for a dropout site "
                                 f"of shape {tuple(shape)}")
            return keep
        return torch.rand(tuple(shape), generator=self.dropout_gen,
                          device=self.device) < 1.0 - p

    def draw(self, shape, num_timesteps: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.replay is not None:
            t, noise, *masks = next(self.replay)
            self.masks = iter(masks[0]) if masks else None
            t = torch.as_tensor(t).to(self.device, torch.long)
            noise = torch.as_tensor(noise).to(self.device, torch.float32)
            if t.shape != (shape[0],) or noise.shape != tuple(shape):
                raise ValueError(f"TrainNoise: replayed t {tuple(t.shape)}, "
                                 f"noise {tuple(noise.shape)} for {shape}")
            return t, noise
        t = torch.randint(0, int(num_timesteps), (shape[0],),
                          generator=self.gen, device=self.device)
        return t, torch.randn(shape, generator=self.gen, device=self.device)
