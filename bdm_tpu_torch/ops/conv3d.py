"""The PVConv voxel convolution (`VoxConv` of `bdm_tpu/models/pvcnn.py`).

One entry point for every width: the TPU path splits it between
`conv3d_ms` (Cin <= 256) and `conv3d_mm` (the 390-channel stage-0 input);
the `csrc/conv3d.cu` kernel serves both.
"""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import conv3d as _conv


def voxel_conv3d(grid: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """3x3x3 SAME conv + bias. grid (B, R, R, R, Cin) float32 or bfloat16,
    weight (Cout, Cin, 3, 3, 3) -> (B, R, R, R, Cout) in grid's dtype."""
    return _conv.conv3d(grid.contiguous(), weight, bias)
