"""Voxelization and trilinear devoxelization (`bdm_tpu/ops/voxelize.py`).

The voxel context (normalized coordinates, voxel ids, their stable sort and
the run start of every voxel in the sorted order) depends on the
coordinates alone and is shared by every PVConv of a stage. The
scatter-mean runs in the `csrc/voxelize.cu` kernel; devoxelization, with
PVConv's gate and residual, in the `csrc/devox.cu` kernel
(`ops/cuda/devox.py`: `gated_devoxelize`, and `trilinear_devoxelize`, the
float32 sample of its plain version, which the tests hold to `bdm_tpu`).
Both differentiate in the features; the geometry carries no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bdm_tpu_torch.ops.cuda import voxelize as _vox


def normalize_coords(coords: torch.Tensor, resolution: int,
                     normalize: bool = True, eps: float = 0.0):
    """(B, N, 3) -> (norm_coords in [0, R-1] float32, vox_coords int32):
    centre on the mean, scale by twice the max point norm, shift by 0.5,
    scale to voxel units, clamp; ids round half to even. No gradient
    flows back into `coords` (the JAX function stops it: the coordinates
    of the colouring model's blocks come from its parameters)."""
    coords = coords.detach().float()
    centered = coords - coords.mean(dim=1, keepdim=True)
    if normalize:
        c = centered
        norm = torch.sqrt((c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1])
                          + c[..., 2] * c[..., 2])                  # (B, N)
        denom = norm.amax(dim=1)[:, None, None] * 2.0 + eps
        norm_coords = centered / denom + 0.5
    else:
        norm_coords = (centered + 1.0) / 2.0
    norm_coords = torch.clamp(norm_coords * resolution, 0.0, resolution - 1)
    return norm_coords, torch.round(norm_coords).to(torch.int32)


class VoxelContext(NamedTuple):
    norm_coords: torch.Tensor   # (B, N, 3) float32 in [0, R-1]
    ids: torch.Tensor           # (B, N) int32, id = x*R^2 + y*R + z
    order: torch.Tensor         # (B, N) int32 stable argsort of ids
    ids_sorted: torch.Tensor    # (B, N) int32
    voxel_lo: torch.Tensor      # (B, R^3 + 1) int32 run start per voxel


def make_voxel_context(coords: torch.Tensor, resolution: int,
                       normalize: bool = True,
                       eps: float = 0.0) -> VoxelContext:
    b = coords.shape[0]
    r = resolution
    r3 = r ** 3
    norm_coords, vox = normalize_coords(coords, r, normalize, eps)
    ids = (vox[..., 0] * (r * r) + vox[..., 1] * r + vox[..., 2]).to(
        torch.int32)
    ids_sorted, order = torch.sort(ids, dim=1, stable=True)
    # run starts: the sorted points below each voxel id. A search reads no
    # device value on the host (bincount does), so a CUDA graph can hold it
    starts = torch.arange(r3 + 1, dtype=torch.int32, device=ids.device)
    voxel_lo = torch.searchsorted(ids_sorted, starts.expand(b, -1).contiguous(),
                                  out_int32=True)
    return VoxelContext(norm_coords, ids, order.to(torch.int32).contiguous(),
                        ids_sorted.contiguous(), voxel_lo)


def avg_voxelize(features: torch.Tensor, ctx: VoxelContext, resolution: int,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Scatter-mean (B, N, C) point features into the (B, R, R, R, C) grid
    (empty voxels zero), rounded once to `out_dtype`."""
    return _vox.scatter_mean(features.contiguous(), ctx.order, ctx.ids_sorted,
                             ctx.voxel_lo, resolution, out_dtype,
                             ids=ctx.ids)


def run_counts_sorted(ctx: VoxelContext) -> torch.Tensor:
    """(B, N) float32: the occupancy of each sorted point's voxel (aligned
    with `ctx.order`), from the run starts."""
    return _vox.run_counts(ctx.ids_sorted, ctx.voxel_lo)


def scatter_mean_contributions(features: torch.Tensor, ctx: VoxelContext,
                               resolution: int) -> torch.Tensor:
    """Scatter-mean as pre-divided contributions: each point's features
    divided by its voxel's occupancy, summed in sorted order in float32
    -> (B, R^3, C) float32, the mean grid (empty voxels zero). The
    precontracted stage-0 conv scatters its 27 * Cout tap values so: one
    launch of the scatter-mean kernel, float32 out."""
    b, c = features.shape[0], features.shape[-1]
    return avg_voxelize(features, ctx, resolution, torch.float32).reshape(
        b, resolution ** 3, c)
