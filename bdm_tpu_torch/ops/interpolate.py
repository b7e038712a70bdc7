"""Three-nearest-neighbour inverse-distance interpolation
(`bdm_tpu/ops/interpolate.py`, the `BDM_INTERP=gather` form)."""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import three_nn as _tnn


def three_nn(points: torch.Tensor, centers: torch.Tensor):
    """(B, N, 3), (B, M, 3) -> (idx (B, N, 3) int32, w (B, N, 3) f32)."""
    return _tnn.three_nn(points.float().contiguous(),
                         centers.float().contiguous())


def three_nn_interpolate(points: torch.Tensor, centers: torch.Tensor,
                         centers_features: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3), (B, M, C) -> (B, N, C) float32:
    sum_k w_k * F[idx_k], summed in k order."""
    idx, w = three_nn(points, centers)
    b, n, _ = idx.shape
    c = centers_features.shape[-1]
    g = torch.gather(centers_features, 1, idx.reshape(b, n * 3, 1).long()
                     .expand(b, n * 3, c)).reshape(b, n, 3, c).float()
    return (g[:, :, 0] * w[..., 0:1] + g[:, :, 1] * w[..., 1:2]) \
        + g[:, :, 2] * w[..., 2:3]
