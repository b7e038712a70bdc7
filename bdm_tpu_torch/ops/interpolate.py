"""Three-nearest-neighbour inverse-distance interpolation
(`bdm_tpu/ops/interpolate.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from bdm_tpu_torch.ops.cuda import interp as _interp
from bdm_tpu_torch.ops.cuda import three_nn as _tnn


def three_nn(points: torch.Tensor, centers: torch.Tensor):
    """(B, N, 3), (B, M, 3) -> (idx (B, N, 3) int32, w (B, N, 3) f32)."""
    return _tnn.three_nn(points.float().contiguous(),
                         centers.float().contiguous())


def uses_onehot(dtype: torch.dtype, m: int, n: int) -> bool:
    """The reference's rule on its accelerator: bf16 features with
    M >= 128 centres and N a multiple of min(N, 512) take the "onehot"
    form."""
    return dtype == torch.bfloat16 and m >= 128 and n % min(n, 512) == 0


def three_nn_interpolate(points: torch.Tensor, centers: torch.Tensor,
                         centers_features: torch.Tensor,
                         impl: Optional[str] = None) -> torch.Tensor:
    """(B, N, 3), (B, M, 3), (B, M, C) -> (B, N, C): sum_k w_k * F[idx_k],
    summed in k order.

    `impl=None` follows `uses_onehot`: the "onehot" form
    (`ops.cuda.interp.interp_mm`: weights rounded to bf16, bf16 result)
    where it holds, else the "gather" form (float32 weights and result).
    Naming a form forces it."""
    if impl not in (None, "gather", "onehot"):
        raise ValueError(f"three_nn_interpolate: impl {impl!r}")
    idx, w = three_nn(points, centers)
    b, n, _ = idx.shape
    m, c = centers_features.shape[1:]
    if impl is None:
        impl = ("onehot" if uses_onehot(centers_features.dtype, m, n)
                else "gather")
    if impl == "onehot":
        return _interp.interp_mm(idx, w, centers_features.contiguous())
    g = torch.gather(centers_features, 1, idx.reshape(b, n * 3, 1).long()
                     .expand(b, n * 3, c)).reshape(b, n, 3, c).float()
    return (g[:, :, 0] * w[..., 0:1] + g[:, :, 1] * w[..., 1:2]) \
        + g[:, :, 2] * w[..., 2:3]
