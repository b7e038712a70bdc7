"""Point-cloud geometry of the original CUDA extensions, as vectorised
PyTorch on (B, N, 3) float32 points, channel-last features.

Distances are rounded operation by operation, (dx*dx + dy*dy) + dz*dz, as
the original kernels take them, so index choices follow the same float32
arithmetic. Work over large (B, M, N) tables runs in blocks of `ROWS`
clouds, so a reference step fits beside what the benchmark keeps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROWS = 8            # clouds a block of the (B, M, N) tables
_INF = 3.4e38


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _blocks(b: int):
    return [slice(i, min(b, i + ROWS)) for i in range(0, b, ROWS)]


def furthest_point_sample(points: torch.Tensor, m: int) -> torch.Tensor:
    """(B, N, 3) -> (B, M) int64: index 0, then each time the point whose
    least squared distance to the chosen ones is largest, the lowest index
    on a tie (`sampling.cu`)."""
    b, n, _ = points.shape
    out = torch.zeros((b, m), dtype=torch.long, device=points.device)
    dist = torch.full((b, n), 1e38, device=points.device)
    rows = torch.arange(b, device=points.device)
    last = points[:, 0]
    for j in range(1, m):
        dist = torch.minimum(dist, sqdist(points, last[:, None, :]))
        best = torch.argmax(dist, dim=1)
        out[:, j] = best
        last = points[rows, best]
    return out


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               u: int) -> torch.Tensor:
    """(B, M, 3), (B, N, 3) -> (B, M, U) int64: the first U points in
    index order with d2 < r2 (r2 = float32(r)^2 rounded to float32);
    slots past the hits repeat the first hit (`ball_query.cu`)."""
    n = points.shape[1]
    r = np.float32(radius)
    r2 = float(r * r)
    ids = torch.arange(n, device=points.device, dtype=torch.int32)
    outs = []
    for s in _blocks(centers.shape[0]):
        d2 = sqdist(centers[s, :, None, :], points[s, None, :, :])
        keys = torch.where(d2 < r2, ids, ids + n)
        del d2
        hits = torch.topk(keys, u, dim=-1, largest=False, sorted=True).values
        first = hits[..., :1]
        pad = torch.where(first < n, first, torch.zeros_like(first))
        outs.append(torch.where(hits < n, hits, pad).long())
    return torch.cat(outs)


def three_nn(points: torch.Tensor, centers: torch.Tensor):
    """(B, N, 3), (B, M, 3) -> (idx (B, N, 3) int64, w (B, N, 3)): the
    three nearest centres, the lower index on a tie, and inverse-distance
    weights after the [1e-10, 1e10] clamp (`interpolate.cu`)."""
    idx_out, w_out = [], []
    for s in _blocks(points.shape[0]):
        d2 = sqdist(points[s, :, None, :], centers[s, None, :, :])
        cur = d2.clone()
        best, idx = [], []
        for _ in range(3):
            i = torch.argmin(cur, dim=-1, keepdim=True)
            best.append(torch.gather(d2, -1, i))
            idx.append(i)
            cur.scatter_(-1, i, float("inf"))
        del d2, cur
        d = torch.clamp(torch.cat(best, -1), 1e-10, 1e10)
        d0, d1, d2_ = d[..., 0], d[..., 1], d[..., 2]
        denom = (d0 * d1 + d0 * d2_) + d1 * d2_
        w_out.append(torch.stack([d1 * d2_, d0 * d2_, d0 * d1], -1)
                     / denom[..., None])
        idx_out.append(torch.cat(idx, -1))
    return torch.cat(idx_out), torch.cat(w_out)


def interpolate(points, centers, feats):
    """The three-neighbour inverse-distance blend of (B, M, C) centre
    features onto (B, N, 3) points -> (B, N, C)."""
    idx, w = three_nn(points, centers)
    b, n, _ = idx.shape
    c = feats.shape[-1]
    g = torch.gather(feats, 1, idx.reshape(b, n * 3, 1).expand(b, n * 3, c))
    g = g.reshape(b, n, 3, c)
    return (g[:, :, 0] * w[..., 0:1] + g[:, :, 1] * w[..., 1:2]) \
        + g[:, :, 2] * w[..., 2:3]


def voxel_coords(coords: torch.Tensor, r: int):
    """`voxelization.py`: centre on the mean, divide by twice the largest
    point norm, shift by 0.5, scale to R, clamp to [0, R-1]
    -> (float coords (B, N, 3), voxel ids (B, N) int64, rounding half to
    even)."""
    c = coords - coords.mean(dim=1, keepdim=True)
    norm = torch.sqrt((c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1])
                      + c[..., 2] * c[..., 2])
    nc = c / (norm.amax(dim=1)[:, None, None] * 2.0) + 0.5
    nc = torch.clamp(nc * r, 0.0, r - 1)
    v = torch.round(nc).long()
    return nc, (v[..., 0] * r + v[..., 1]) * r + v[..., 2]


def avg_voxelize(feats: torch.Tensor, ids: torch.Tensor, r: int):
    """Scatter-mean of (B, N, C) into a (B, R, R, R, C) grid, empty voxels
    zero."""
    b, n, c = feats.shape
    flat = (ids + torch.arange(b, device=ids.device)[:, None] * r ** 3
            ).reshape(-1)
    sums = torch.zeros((b * r ** 3, c), device=feats.device,
                       dtype=feats.dtype)
    sums.index_add_(0, flat, feats.reshape(-1, c))
    cnt = torch.bincount(flat, minlength=b * r ** 3).to(feats.dtype)
    grid = sums / cnt.clamp(min=1.0)[:, None]
    return grid.reshape(b, r, r, r, c)


def devoxelize(grid: torch.Tensor, nc: torch.Tensor) -> torch.Tensor:
    """Trilinear sampling of (B, R, R, R, C) at float voxel coords; the
    upper corner of an axis counts only where its fraction is above 0
    (`trilinear_devox.cu`)."""
    b, r = grid.shape[:2]
    c = grid.shape[-1]
    n = nc.shape[1]
    lo = torch.floor(nc)
    fr = nc - lo
    lo = lo.long()
    hi = lo + (fr > 0).long()
    flat = grid.reshape(b, r ** 3, c)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                x = hi[..., 0] if dx else lo[..., 0]
                y = hi[..., 1] if dy else lo[..., 1]
                z = hi[..., 2] if dz else lo[..., 2]
                w = ((fr[..., 0] if dx else 1 - fr[..., 0])
                     * (fr[..., 1] if dy else 1 - fr[..., 1])
                     * (fr[..., 2] if dz else 1 - fr[..., 2]))
                i = (x * r + y) * r + z
                out = out + w[..., None] * torch.gather(
                    flat, 1, i[..., None].expand(b, n, c))
    return out


def to_ndc(points: torch.Tensor, cam: dict):
    """PyTorch3D perspective camera, row vectors: X_view = X R + T, then
    x_ndc = fx x / z + px (each term rounded as PyTorch3D takes it)."""
    r, t = cam["R"], cam["T"]
    view = [(points[..., 0] * r[:, None, 0, k]
             + points[..., 1] * r[:, None, 1, k])
            + points[..., 2] * r[:, None, 2, k] + t[:, None, k]
            for k in range(3)]
    z = view[2]
    inv = 1.0 / z
    f, p = cam["focal_length"], cam["principal_point"]
    x = (f[:, None, 0] * view[0] + p[:, None, 0] * z) * inv
    y = (f[:, None, 1] * view[1] + p[:, None, 1] * z) * inv
    return x, y, z


def surface_projection(points: torch.Tensor, cam: dict,
                       fmap: torch.Tensor, radius: float) -> torch.Tensor:
    """PC2's rasterized projection (`projection_model.py`, points_per_pixel
    1): every pixel centre within `radius` (NDC) of a point is a candidate;
    a pixel goes to its nearest candidate in z; a point that wins pixels
    takes the feature of the first it won in (row, column) order, others
    zeros. points (B, N, 3), fmap (B, S*S, C) -> (B, N, C)."""
    b, n, _ = points.shape
    s = math.isqrt(fmap.shape[1])
    x_ndc, y_ndc, z = to_ndc(points, cam)
    xp = (s * (1.0 - x_ndc) - 1.0) / 2.0
    yp = (s * (1.0 - y_ndc) - 1.0) / 2.0
    pitch = 2.0 / s
    rp = radius / pitch
    k = int(math.floor(2.0 * rp)) + 1
    xs = (torch.floor(xp - rp).long() + 1)[..., None] + torch.arange(
        k, device=points.device)
    ys = (torch.floor(yp - rp).long() + 1)[..., None] + torch.arange(
        k, device=points.device)
    dx = (xp[..., None] - xs) * pitch
    dy = (yp[..., None] - ys) * pitch
    d2 = (dx * dx)[..., None, :] + (dy * dy)[..., :, None]
    valid = (((xs >= 0) & (xs < s))[..., None, :]
             & ((ys >= 0) & (ys < s))[..., :, None]
             & (z > 0)[..., None, None] & (d2 < radius * radius))
    pid = ys[..., :, None] * s + xs[..., None, :]
    pid = torch.where(valid, pid, torch.full_like(pid, s * s))
    pid = pid.reshape(b, n, k * k)
    valid = valid.reshape(b, n, k * k)
    zc = torch.where(valid, z[..., None], torch.full_like(z[..., None],
                                                         _INF))
    zbuf = torch.full((b, s * s + 1), _INF, device=points.device)
    zbuf.scatter_reduce_(1, pid.reshape(b, -1), zc.reshape(b, -1), "amin")
    won = valid & (zc <= torch.gather(zbuf, 1, pid.reshape(b, -1)
                                      ).reshape(b, n, k * k))
    first = torch.argmax(won.int(), dim=-1, keepdim=True)
    chosen = torch.gather(pid, -1, first)[..., 0].clamp(max=s * s - 1)
    feats = torch.gather(fmap, 1, chosen[..., None].expand(
        b, n, fmap.shape[-1]))
    return torch.where(won.any(-1, keepdim=True), feats,
                       torch.zeros_like(feats))
