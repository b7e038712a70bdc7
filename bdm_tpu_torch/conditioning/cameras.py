"""Perspective cameras with PyTorch3D conventions
(`bdm_tpu/conditioning/cameras.py`): X_view = X_world @ R + T (row
vectors), +Z forward, NDC +X left / +Y up, in-NDC projection
x_ndc = fx * x / z + px."""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class PerspectiveCamera:
    R: torch.Tensor                 # (B, 3, 3)
    T: torch.Tensor                 # (B, 3)
    focal_length: torch.Tensor      # (B, 2)
    principal_point: torch.Tensor   # (B, 2)

    def to(self, device) -> "PerspectiveCamera":
        return PerspectiveCamera(*(getattr(self, f).to(device).float()
                                   for f in ("R", "T", "focal_length",
                                             "principal_point")))

    def scale_T(self, scale: float) -> "PerspectiveCamera":
        return replace(self, T=self.T * scale)

    def transform_points_ndc(self, points: torch.Tensor):
        """(B, N, 3) world points -> (x_ndc, y_ndc, z_view), all float32
        (a 3-term product sum per coordinate, no reduced precision)."""
        p = points.float()
        r = self.R
        view = [(p[..., 0] * r[:, None, 0, k] + p[..., 1] * r[:, None, 1, k])
                + p[..., 2] * r[:, None, 2, k] + self.T[:, None, k]
                for k in range(3)]
        z = view[2]
        inv_z = 1.0 / z
        f, pp = self.focal_length, self.principal_point
        x_ndc = (f[:, None, 0] * view[0] + pp[:, None, 0] * z) * inv_z
        y_ndc = (f[:, None, 1] * view[1] + pp[:, None, 1] * z) * inv_z
        return x_ndc, y_ndc, z
