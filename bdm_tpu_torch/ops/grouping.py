"""Neighbour feature grouping (`bdm_tpu/ops/grouping.py`)."""

from __future__ import annotations

import torch


def grouping(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, U) -> (B, M, U, C)."""
    b, m, u = indices.shape
    c = features.shape[-1]
    flat = torch.gather(features, 1, indices.reshape(b, m * u, 1).long()
                        .expand(b, m * u, c))
    return flat.reshape(b, m, u, c)
