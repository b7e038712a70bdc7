"""Ball query with the reference's "first U in scan order" semantics
(`bdm_tpu/ops/ball_query.py`)."""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import ball_query as _bq


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               num_neighbors: int) -> torch.Tensor:
    """(B, M, 3), (B, N, 3) -> (B, M, U) int32 neighbour indices."""
    return _bq.ball_query(centers.float().contiguous(),
                          points.float().contiguous(), radius, num_neighbors)
