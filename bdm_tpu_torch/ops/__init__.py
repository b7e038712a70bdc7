"""Point-cloud ops, channel-last, mirroring `bdm_tpu/ops/`.

    points / coords : (B, N, 3) float32
    features        : (B, N, C)
    voxel grids     : (B, R, R, R, C)

The TPU kernels of the ported paths run as hand-written CUDA kernels
(`bdm_tpu_torch/ops/cuda/`, sources in `bdm_tpu_torch/csrc/`).
"""

from bdm_tpu_torch.ops.attention import attention
from bdm_tpu_torch.ops.ball_query import ball_query
from bdm_tpu_torch.ops.conv3d import voxel_conv3d
from bdm_tpu_torch.ops.conv_wide import tap_shift_sum
from bdm_tpu_torch.ops.cuda.groupnorm import group_norm
from bdm_tpu_torch.ops.grouping import grouping
from bdm_tpu_torch.ops.interpolate import three_nn, three_nn_interpolate
from bdm_tpu_torch.ops.sampling import furthest_point_sample, gather
from bdm_tpu_torch.ops.voxelize import (VoxelContext, avg_voxelize,
                                        make_voxel_context, normalize_coords,
                                        run_counts_sorted,
                                        scatter_mean_contributions,
                                        trilinear_devoxelize)

__all__ = [
    "attention", "avg_voxelize", "ball_query", "furthest_point_sample",
    "gather", "group_norm", "grouping", "make_voxel_context", "normalize_coords",
    "run_counts_sorted", "scatter_mean_contributions", "tap_shift_sum",
    "three_nn", "three_nn_interpolate", "trilinear_devoxelize",
    "voxel_conv3d", "VoxelContext",
]
