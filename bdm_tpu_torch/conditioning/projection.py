"""Rasterized surface projection (`bdm_tpu/conditioning/projection.py`),
the exact `raster_splat="multi"` form: each point competes for every pixel
centre within `radius` in NDC (a K x K window, K = 2 at 224 px); a pixel
goes to the nearest-in-z candidate (a z-buffer scatter-min); a point that
wins takes the feature of the first pixel it won, all others get zeros.
"""

from __future__ import annotations

import math

import torch

from bdm_tpu_torch.conditioning.cameras import PerspectiveCamera

_INF = 3.4e38


def surface_projection(points: torch.Tensor, camera: PerspectiveCamera,
                       feature_map: torch.Tensor, radius: float = 0.0075,
                       scale_factor: float = 1.0) -> torch.Tensor:
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
    dev = points.device

    x_ndc, y_ndc, z = camera.transform_points_ndc(points)
    # pixel i has NDC centre 1 - (2i+1)/S  =>  i = (S*(1-ndc) - 1)/2
    x_pix = (s * (1.0 - x_ndc) - 1.0) / 2.0
    y_pix = (s * (1.0 - y_ndc) - 1.0) / 2.0
    pitch = 2.0 / s
    rp = radius / pitch
    k = int(math.floor(2.0 * rp)) + 1
    x_base = torch.floor(x_pix - rp).to(torch.int32) + 1
    y_base = torch.floor(y_pix - rp).to(torch.int32) + 1
    offs = torch.arange(k, dtype=torch.int32, device=dev)
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
    pid = pid.reshape(b, n, k * k).long()
    valid = inside.reshape(b, n, k * k)

    zc = torch.where(valid, z[..., None], torch.full_like(valid, _INF,
                                                          dtype=z.dtype))
    zbuf = torch.full((b, s * s + 1), _INF, dtype=z.dtype, device=dev)
    zbuf.scatter_reduce_(1, pid.reshape(b, -1), zc.reshape(b, -1), "amin",
                         include_self=True)
    winner = torch.gather(zbuf, 1, pid.reshape(b, -1)).reshape(b, n, k * k)
    won = valid & (zc <= winner)
    first = torch.argmax(won.to(torch.int32), dim=-1, keepdim=True)
    any_won = won.any(dim=-1, keepdim=True)
    chosen = torch.gather(pid, -1, first)[..., 0].clamp(max=s * s - 1)
    feats = torch.gather(flat, 1, chosen[..., None].expand(
        b, n, flat.shape[-1]))
    return torch.where(any_won, feats, torch.zeros_like(feats))
