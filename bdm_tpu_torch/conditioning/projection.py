"""Rasterized surface projection (`bdm_tpu/conditioning/projection.py`).

`splat="multi"` is the exact form: each point competes for every pixel
centre within `radius` in NDC (a K x K window, K = 2 at 224 px); a pixel
goes to the nearest-in-z candidate (a z-buffer scatter-min); a point that
wins takes the feature of the first pixel it won, all others get zeros.
`splat="nearest"` lets a point compete only for its nearest pixel centre
(rounded half to even), under the same z-buffer.

With `group` the points are this rank's shard of a cloud whose point axis
is split over a process group: the z-buffer is the MIN over the ranks of
the shards' z-buffers, so every point competes with the whole cloud.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from bdm_tpu_torch.conditioning.cameras import PerspectiveCamera

_INF = 3.4e38


def _nearest_candidates(x_pix, y_pix, z, s: int, radius: float):
    """Each point's nearest pixel centre -> (pixel id (B, N, 1), valid):
    in front of the camera, inside the image and within `radius`."""
    xi = torch.round(x_pix).to(torch.int32)
    yi = torch.round(y_pix).to(torch.int32)
    pitch = 2.0 / s
    dx = (x_pix - xi) * pitch
    dy = (y_pix - yi) * pitch
    inside = ((xi >= 0) & (xi < s) & (yi >= 0) & (yi < s) & (z > 0)
              & ((dx * dx + dy * dy) < radius * radius))
    pid = torch.where(inside, yi * s + xi, torch.full_like(xi, s * s))
    return pid[..., None].long(), inside[..., None]


def _window_candidates(x_pix, y_pix, z, s: int, radius: float):
    """Every pixel centre within `radius` of each point -> (pixel ids
    (B, N, K*K), valid)."""
    b, n = z.shape
    pitch = 2.0 / s
    rp = radius / pitch
    k = int(math.floor(2.0 * rp)) + 1
    x_base = torch.floor(x_pix - rp).to(torch.int32) + 1
    y_base = torch.floor(y_pix - rp).to(torch.int32) + 1
    offs = torch.arange(k, dtype=torch.int32, device=z.device)
    xs = x_base[..., None] + offs                          # (B, N, K)
    ys = y_base[..., None] + offs
    dx = (x_pix[..., None] - xs) * pitch
    dy = (y_pix[..., None] - ys) * pitch
    d2 = (dx * dx)[..., None, :] + (dy * dy)[..., :, None]  # (B, N, Ky, Kx)
    inside = (((xs >= 0) & (xs < s))[..., None, :]
              & ((ys >= 0) & (ys < s))[..., :, None]
              & (z > 0)[..., None, None] & (d2 < radius * radius))
    pid = ys[..., :, None] * s + xs[..., None, :]
    pid = torch.where(inside, pid, torch.full_like(pid, s * s))
    return pid.reshape(b, n, k * k).long(), inside.reshape(b, n, k * k)


def surface_projection(points: torch.Tensor, camera: PerspectiveCamera,
                       feature_map: torch.Tensor, radius: float = 0.0075,
                       scale_factor: float = 1.0,
                       splat: str = "multi", group=None) -> torch.Tensor:
    """points (B, N, 3); feature_map (B, H, W, C) or pre-flattened
    (B, H*W, C), square -> (B, N, C) in the map's dtype."""
    b, n, _ = points.shape
    if feature_map.dim() == 3:
        s = math.isqrt(feature_map.shape[1])
        flat = feature_map
    else:
        s = feature_map.shape[1]
        flat = feature_map.reshape(b, s * s, feature_map.shape[-1])
    if scale_factor != 1.0:
        camera = camera.scale_T(scale_factor)
    x_ndc, y_ndc, z = camera.transform_points_ndc(points)
    # pixel i has NDC centre 1 - (2i+1)/S  =>  i = (S*(1-ndc) - 1)/2
    x_pix = (s * (1.0 - x_ndc) - 1.0) / 2.0
    y_pix = (s * (1.0 - y_ndc) - 1.0) / 2.0
    if splat == "nearest":
        pid, valid = _nearest_candidates(x_pix, y_pix, z, s, radius)
    elif splat == "multi":
        pid, valid = _window_candidates(x_pix, y_pix, z, s, radius)
    else:
        raise ValueError(f"splat {splat!r}: 'multi' or 'nearest'")
    kk = pid.shape[-1]

    zc = torch.where(valid, z[..., None], torch.full_like(valid, _INF,
                                                          dtype=z.dtype))
    zbuf = torch.full((b, s * s + 1), _INF, dtype=z.dtype, device=z.device)
    zbuf.scatter_reduce_(1, pid.reshape(b, -1), zc.reshape(b, -1), "amin",
                         include_self=True)
    if group is not None:
        dist.all_reduce(zbuf, dist.ReduceOp.MIN, group=group)
    winner = torch.gather(zbuf, 1, pid.reshape(b, -1)).reshape(b, n, kk)
    won = valid & (zc <= winner)
    first = torch.argmax(won.to(torch.int32), dim=-1, keepdim=True)
    any_won = won.any(dim=-1, keepdim=True)
    chosen = torch.gather(pid, -1, first)[..., 0].clamp(max=s * s - 1)
    feats = torch.gather(flat, 1, chosen[..., None].expand(
        b, n, flat.shape[-1]))
    return torch.where(any_won, feats, torch.zeros_like(feats))
