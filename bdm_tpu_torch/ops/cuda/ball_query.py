"""Ball query: the `csrc/ball_query.cu` kernel and its plain version.

Replaces `ball_query_pallas` (bdm_tpu/ops/pallas/ball_query.py). Both
versions compare d2 against float32(radius) squared in float32, the
boundary of the JAX reference (`ops/ball_query.py`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bdm_tpu_torch.ops.cuda import _lib
from bdm_tpu_torch.ops.cuda.fps import sqdist


def radius_squared(radius: float) -> float:
    """float32(radius) ** 2 rounded once to float32 (exact as a double)."""
    r = np.float32(radius)
    return float(r * r)


def ball_query_plain(centers: torch.Tensor, points: torch.Tensor,
                     radius: float, num_neighbors: int) -> torch.Tensor:
    """(B, M, 3), (B, N, 3) -> (B, M, U) int32: the first U points in scan
    order with d2 < r2; empty slots repeat the first hit, no hit gives 0."""
    _lib.plain_call("ball_query", centers)
    n = points.shape[1]
    u = int(num_neighbors)
    d2 = sqdist(centers[:, :, None, :], points[:, None, :, :])   # (B, M, N)
    ids = torch.arange(n, device=points.device)
    # a hit keeps its index as key, a miss is pushed past N: the U smallest
    # keys are the first U hits in scan order
    keys = torch.where(d2 < radius_squared(radius), ids, ids + n)
    if n < u:   # fewer points than slots: pad with misses
        keys = F.pad(keys, (0, u - n), value=2 * n)
    hits = torch.topk(keys, u, dim=-1, largest=False, sorted=True).values
    first = hits[..., :1]
    pad = torch.where(first < n, first, torch.zeros_like(first))
    return torch.where(hits < n, hits, pad).to(torch.int32)


@torch.no_grad()   # coordinates carry no gradient
def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               num_neighbors: int) -> torch.Tensor:
    if centers.device.type == "cpu":
        return ball_query_plain(centers, points, radius, num_neighbors)
    _lib.check(centers, "centers", (torch.float32,), 3)
    _lib.check(points, "points", (torch.float32,), 3)
    b, m, _ = centers.shape
    n = points.shape[1]
    u = int(num_neighbors)
    if centers.shape[-1] != 3 or points.shape[::2] != (b, 3) or u < 1:
        raise ValueError(f"ball_query: centers {tuple(centers.shape)}, "
                         f"points {tuple(points.shape)}, U={u}")
    out = torch.empty((b, m, u), dtype=torch.int32, device=centers.device)
    _lib.launch("bdm_ball_query", centers.data_ptr(), points.data_ptr(),
                out.data_ptr(), b, m, n, u, radius_squared(radius))
    return out
