"""Furthest point sampling and index gather (`bdm_tpu/ops/sampling.py`)."""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import fps as _fps


def furthest_point_sample(coords: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, M) int32; index 0 first."""
    if int(num_samples) == 1:
        return torch.zeros((coords.shape[0], 1), dtype=torch.int32,
                           device=coords.device)
    return _fps.furthest_point_sample(coords.float().contiguous(),
                                      num_samples)


def gather(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M) -> (B, M, C)."""
    b, m = indices.shape
    return torch.gather(features, 1, indices.long()[..., None].expand(
        b, m, features.shape[-1]))
