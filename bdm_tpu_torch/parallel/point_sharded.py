"""Point-axis (sequence-parallel) geometry ops over a process group
(`bdm_tpu/parallel/point_sharded.py`).

The large-N path: the (B, N, 3) point axis is split into P contiguous
shards, one a rank of `group` (rank r holds points [r N/P, (r+1) N/P)), and
each op gives what its unsharded counterpart gives, with the same
scan-order and first-occurrence tie rules. Where the JAX package's
`shard_map` functions take global arrays, these take this rank's shard and
return this rank's part of a point-sharded result, or the whole of a
replicated one; N below is the global count, N/P times the group's size.

Collectives per op, as in the JAX package:
  * FPS: each round a local first-max argmax, then the merge of the JAX
    package's MAX on the value, MIN on the global index among ties and
    SUM broadcasting the winner's coordinates, taken on every rank from
    ONE all_gather of the ranks' (value, index, coordinates) (a third of
    the collectives; each crosses the host under gloo). No kernel: the
    per-round merge is the point.
  * ball query: each rank's first U hits in scan order (the port's
    kernel), one `all_gather` of (P, U) keys, a merge of the smallest U.
  * three-NN and its interpolation, devoxelization: local, no collective.
  * gathers at global indices: the rows a rank owns, then one SUM.
  * the voxel grid: a SUM of coordinate sums, a MAX of the point norms and
    one SUM of the (B, R^3, C + 1) partial sums and counts
    (`csrc/scatter_sum.cu` on the card).

A collective on a differentiable path is an autograd function
(`torch.distributed.nn.functional`), whose backward sums the gradient
over the ranks: each rank backpropagates its own partial loss, and the sum
of the ranks' parameter gradients is the gradient of the whole loss.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dnn

from bdm_tpu_torch import ops
from bdm_tpu_torch.ops.cuda import scatter_sum as _scatter_sum
from bdm_tpu_torch.ops.cuda.ball_query import radius_squared
from bdm_tpu_torch.ops.cuda.fps import sqdist

SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX


def _offset(group, shard_n: int) -> int:
    return dist.get_rank(group) * shard_n


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """A reduced copy of `x`: differentiable where `x` needs a gradient."""
    if x.requires_grad:
        return dnn.all_reduce(x, op, group)
    x = x.clone()
    dist.all_reduce(x, op, group=group)
    return x


def sharded_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over dims 1 and 3 of a (B, N/P, G, C/G) shard, taken over
    the whole (B, N, G, C/G): a SUM of the shards' sums -> (B, 1, G, 1)."""
    total = x.shape[1] * x.shape[3] * dist.get_world_size(group)
    return _all_reduce(x.sum(dim=(1, 3), keepdim=True), SUM, group) / total


def sp_active(group, n: int, min_points: int) -> bool:
    """Shard a level of `n` points (global) over `group`?"""
    if group is None:
        return False
    p = dist.get_world_size(group)
    return p > 1 and n >= min_points and n % p == 0


def all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The whole (B, N, ...) tensor from every rank's (B, N/P, ...) shard:
    each rank's rows in place, zeros elsewhere, one SUM (differentiable:
    the gradient of a shard is the sum over ranks of its rows')."""
    p = dist.get_world_size(group)
    b, shard_n, rest = x.shape[0], x.shape[1], tuple(x.shape[2:])
    off = _offset(group, shard_n)
    full = torch.cat([x.new_zeros((b, off) + rest), x,
                      x.new_zeros((b, shard_n * p - off - shard_n) + rest)],
                     dim=1)
    return _all_reduce(full, SUM, group)


def own_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's shard of a replicated (B, N, ...) tensor."""
    shard_n = x.shape[1] // dist.get_world_size(group)
    off = _offset(group, shard_n)
    return x[:, off:off + shard_n]


@torch.no_grad()
def fps_point_sharded(coords: torch.Tensor, num_samples: int,
                      group) -> torch.Tensor:
    """Furthest point sampling of the sharded (B, N/P, 3) coordinates ->
    (B, M) int32 global indices, replicated; equal to
    `ops.furthest_point_sample` on the whole cloud (index 0 first, the
    lowest global index among equal distances).

    A round's candidates travel as float64 rows (value, global index,
    x, y, z), exact for float32 values and any index below 2^53."""
    c = coords.float()
    b, shard_n, _ = c.shape
    p = dist.get_world_size(group)
    m = int(num_samples)
    off = _offset(group, shard_n)
    out = torch.zeros((b, m), dtype=torch.int32, device=c.device)
    # global point 0 seeds the loop; it lives on the group's first rank
    last = _all_reduce(c[:, 0] if off == 0 else torch.zeros_like(c[:, 0]),
                       SUM, group)
    dist_min = torch.full((b, shard_n), 1e38, device=c.device)
    rows = torch.arange(b, device=c.device)
    cand = torch.empty((b, 5), dtype=torch.float64, device=c.device)
    gathered = [torch.empty_like(cand) for _ in range(p)]
    for j in range(1, m):
        dist_min = torch.minimum(dist_min, sqdist(c, last[:, None, :]))
        li = torch.argmax(dist_min, dim=1)                 # first maximal
        cand[:, 0] = dist_min[rows, li]
        cand[:, 1] = li + off
        cand[:, 2:] = c[rows, li]
        dist.all_gather(gathered, cand, group=group)
        allc = torch.stack(gathered, dim=1)                # (B, P, 5)
        # MAX on the value, then MIN on the global index among its ties
        vmax = allc[..., 0].amax(dim=1, keepdim=True)
        idx = torch.where(allc[..., 0] == vmax, allc[..., 1],
                          torch.full_like(allc[..., 1], float("inf")))
        win = idx.argmin(dim=1)
        best = allc[rows, win]
        last = best[:, 2:].float()
        out[:, j] = best[:, 1].to(torch.int32)
    return out


def gather_point_sharded(values: torch.Tensor, indices: torch.Tensor,
                         group) -> torch.Tensor:
    """Rows of the sharded (B, N/P, C) `values` at replicated global
    (B, M) indices -> replicated (B, M, C): each rank the rows it owns,
    zeros elsewhere, one SUM. Equal to `ops.gather` on the whole."""
    shard_n = values.shape[1]
    off = _offset(group, shard_n)
    i = indices.long()
    own = (i >= off) & (i < off + shard_n)
    local = ops.gather(values, (i - off).clamp(0, shard_n - 1))
    return _all_reduce(torch.where(own[..., None], local,
                                   torch.zeros_like(local)), SUM, group)


def fps_gather_point_sharded(coords: torch.Tensor, num_samples: int,
                             group) -> torch.Tensor:
    """FPS and the gather of the chosen coordinates -> replicated
    (B, M, 3)."""
    with torch.no_grad():
        idx = fps_point_sharded(coords, num_samples, group)
        return gather_point_sharded(coords.float(), idx, group)


@torch.no_grad()
def ball_query_point_sharded(centers: torch.Tensor, points: torch.Tensor,
                             radius: float, num_neighbors: int,
                             group) -> torch.Tensor:
    """Ball query of replicated (B, M, 3) centres among the sharded
    (B, N/P, 3) points -> replicated (B, M, U) int32 global indices, equal
    to `ops.ball_query` on the whole: the first U points in scan order
    within the radius, empty slots repeating the first hit, 0 with none.

    Each rank's own first U hits (a subset holds every global first-U hit
    it owns) come from `ops.ball_query`, whose padding repeats the first
    hit: a slot after the first is a hit when its index grows, the first
    slot when its point lies within the radius (a lone hit at index 0 and
    no hit both read 0). Misses become the key N, one all_gather of the
    (P, B, M, U) keys and the U smallest merge them."""
    c, pts = centers.float(), points.float()
    b, mq, _ = c.shape
    shard_n = pts.shape[1]
    p = dist.get_world_size(group)
    n = shard_n * p
    u = int(num_neighbors)
    off = _offset(group, shard_n)
    local = ops.ball_query(c, pts, radius, u).long()          # (B, M, U)
    first = pts[torch.arange(b, device=pts.device)[:, None], local[..., 0]]
    hit0 = sqdist(c, first) < radius_squared(radius)           # (B, M)
    grows = local[..., 1:] > local[..., :-1]
    hit = torch.cat([hit0[..., None], grows], dim=-1).to(
        torch.int32).cumprod(dim=-1) > 0
    keys = torch.where(hit, local + off, torch.full_like(local, n))
    gathered = [torch.empty_like(keys) for _ in range(p)]
    dist.all_gather(gathered, keys.contiguous(), group=group)
    merged = torch.cat(gathered, dim=-1)                       # (B, M, P U)
    hits = torch.topk(merged, u, dim=-1, largest=False, sorted=True).values
    first = hits[..., :1]
    base = torch.where(first < n, first, torch.zeros_like(first))
    return torch.where(hits < n, hits, base).to(torch.int32)


def three_nn_point_sharded(points: torch.Tensor, centers: torch.Tensor,
                           group=None):
    """Three-NN of the sharded query points among replicated centres: the
    port's kernel on the shard; (idx, w) stay point-sharded. No
    collective: a query's neighbours do not depend on the other shards."""
    return ops.three_nn(points, centers)


def three_nn_interpolate_point_sharded(points: torch.Tensor,
                                       centers: torch.Tensor,
                                       centers_features: torch.Tensor,
                                       group=None) -> torch.Tensor:
    """The three-neighbour blend onto the sharded query points from
    replicated centres and features (`ops.three_nn_interpolate`, its
    dispatch between `interp.cu` and the gather as for any N); local."""
    return ops.three_nn_interpolate(points, centers, centers_features)


def devoxelize_point_sharded(grid: torch.Tensor, norm_coords: torch.Tensor,
                             group=None) -> torch.Tensor:
    """Trilinear devoxelization of the replicated grid at the sharded
    points; local."""
    return ops.trilinear_devoxelize(grid, norm_coords)


def grouping_point_sharded(features: torch.Tensor, indices: torch.Tensor,
                           group) -> torch.Tensor:
    """Neighbour grouping of sharded (B, N/P, C) features at replicated
    global (B, M, U) indices -> replicated (B, M, U, C): the whole
    features (`all_rows`), then the local gather. Equal to `ops.grouping`
    on the whole."""
    return ops.grouping(all_rows(features, group), indices)


class ShardedVoxelContext(NamedTuple):
    norm_coords: torch.Tensor   # (B, N/P, 3) float32 in [0, R-1]
    ids: torch.Tensor           # (B, N/P) int32, id = x*R^2 + y*R + z


@torch.no_grad()
def sharded_voxel_context(coords: torch.Tensor, resolution: int, group,
                          normalize: bool = True,
                          eps: float = 0.0) -> ShardedVoxelContext:
    """`ops.normalize_coords` of the whole cloud from its shards: the mean
    from a SUM of coordinate sums, the scale from a MAX of the shards'
    largest norms. Feature-free, so every PVConv of a stage shares it."""
    c = coords.detach().float()
    r = int(resolution)
    n = c.shape[1] * dist.get_world_size(group)
    centered = c - (_all_reduce(c.sum(dim=1), SUM, group) / n)[:, None, :]
    if normalize:
        norm = torch.sqrt((centered[..., 0] * centered[..., 0]
                           + centered[..., 1] * centered[..., 1])
                          + centered[..., 2] * centered[..., 2])
        denom = _all_reduce(norm.amax(dim=1), MAX, group)[:, None, None]
        norm_coords = centered / (denom * 2.0 + eps) + 0.5
    else:
        norm_coords = (centered + 1.0) / 2.0
    norm_coords = torch.clamp(norm_coords * r, 0.0, r - 1)
    vox = torch.round(norm_coords).to(torch.int32)
    ids = vox[..., 0] * (r * r) + vox[..., 1] * r + vox[..., 2]
    return ShardedVoxelContext(norm_coords, ids.to(torch.int32).contiguous())


class _ScatterSum(torch.autograd.Function):
    """`ops.cuda.scatter_sum` (the kernel on the card) with its gradient:
    the output gradient at each row's segment."""

    @staticmethod
    def forward(ctx, features, ids, num_segments):
        ctx.save_for_backward(ids)
        return _scatter_sum.scatter_sum(features, ids, num_segments)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        c = grad.shape[-1]
        return torch.gather(grad, 1, ids.long()[..., None].expand(
            -1, -1, c)), None, None


def sharded_voxel_grid(features: torch.Tensor, ctx: ShardedVoxelContext,
                       resolution: int, group,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """The scatter-mean of the whole cloud's features into the replicated
    (B, R, R, R, C) grid: each shard's sums and counts (one scatter-sum of
    [features | 1] in float32), one SUM, the division; empty voxels zero."""
    b, _, c = features.shape
    r = int(resolution)
    aug = torch.cat([features.float(), features.new_ones(
        features.shape[:2] + (1,), dtype=torch.float32)], dim=-1)
    tot = _all_reduce(_ScatterSum.apply(aug, ctx.ids, r ** 3), SUM, group)
    grid = tot[..., :c] / tot[..., c:].clamp_min(1.0)
    return grid.reshape((b,) + (r,) * 3 + (c,)).to(out_dtype)


def voxel_grid_point_sharded(features: torch.Tensor, coords: torch.Tensor,
                             resolution: int, group, normalize: bool = True,
                             eps: float = 0.0):
    """The point -> voxel half of a PVConv's voxel branch -> (the replicated
    (B, R, R, R, C) grid in the features' dtype, the sharded normalized
    coordinates (B, N/P, 3))."""
    ctx = sharded_voxel_context(coords, resolution, group, normalize, eps)
    return (sharded_voxel_grid(features, ctx, resolution, group,
                               features.dtype), ctx.norm_coords)


def point_to_voxel_to_point_sharded(features: torch.Tensor,
                                    coords: torch.Tensor, resolution: int,
                                    voxel_fn, group, normalize: bool = True,
                                    eps: float = 0.0) -> torch.Tensor:
    """The whole voxel branch: the sharded grid, `voxel_fn` on the
    replicated grid, devoxelization at the shard's points -> (B, N/P, C')."""
    grid, norm_coords = voxel_grid_point_sharded(
        features, coords, resolution, group, normalize, eps)
    return devoxelize_point_sharded(voxel_fn(grid), norm_coords)
