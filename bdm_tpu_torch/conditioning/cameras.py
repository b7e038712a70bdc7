"""Perspective cameras with PyTorch3D conventions
(`bdm_tpu/conditioning/cameras.py`): X_view = X_world @ R + T (row
vectors), +Z forward, NDC +X left / +Y up, in-NDC projection
x_ndc = fx * x / z + px.

The dataset helpers (`camera_from_r2n2`, `camera_from_screen`,
`compute_extrinsic_matrix`, `compute_camera_calibration`) do their math in
float64 NumPy, as the reference does, and only then make float32 CPU
tensors, so a camera is bit-equal to the JAX package's."""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

# R2N2 intrinsics (`shapenet_r2n2.py:46-53`): focal 2.1875, the z rows are
# irrelevant for the NDC x/y math.
R2N2_FOCAL = 2.1875
MAX_CAMERA_DISTANCE = 1.75  # `shapenet_r2n2.py:374-380`


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


def _f32(x) -> torch.Tensor:
    """float64 NumPy (or a Python number) -> float32 CPU tensor, rounded
    once by NumPy, as `jnp.asarray(x, jnp.float32)` rounds it."""
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def camera_from_screen(r: np.ndarray, t: np.ndarray, focal_px: tuple,
                       principal_px: tuple, image_size: int
                       ) -> PerspectiveCamera:
    """Build an NDC camera from screen-space intrinsics (PyTorch3D
    `in_ndc=False` semantics, used by the Pix3D loader — `pix3d.py:152-159`).

    For a square image of side S: f_ndc = f_px * 2/S and the principal
    point maps left-edge->+1 / right-edge->-1: p_ndc = (S - 2*p_px)/S.
    """
    s = float(image_size)
    fx, fy = focal_px
    px, py = principal_px
    return PerspectiveCamera(
        R=_f32(r)[None],
        T=_f32(t)[None],
        focal_length=_f32([[fx * 2.0 / s, fy * 2.0 / s]]),
        principal_point=_f32([[(s - 2.0 * px) / s, (s - 2.0 * py) / s]]),
    )


def compute_extrinsic_matrix(azimuth: float, elevation: float,
                             distance: float) -> np.ndarray:
    """R2N2 metadata (azim, elev, dist) -> 4x4 world-to-camera matrix,
    including the Blender 90-degree quirk (`dataset/utils.py:40-84`)."""
    az = -math.pi * float(azimuth) / 180.0
    el = -math.pi * float(elevation) / 180.0
    sa, ca = math.sin(az), math.cos(az)
    se, ce = math.sin(el), math.cos(el)
    r_world2obj = np.array([
        [ca * ce, sa * ce, -se],
        [-sa, ca, 0.0],
        [ca * se, sa * se, ce],
    ])
    r_obj2cam = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    r_world2cam = r_obj2cam @ r_world2obj
    cam_location = np.array([[float(distance), 0.0, 0.0]]).T
    t_world2cam = -(r_obj2cam @ cam_location)
    rt = np.concatenate([r_world2cam, t_world2cam], axis=1)
    rt = np.concatenate([rt, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
    rot = np.array([[1.0, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])
    return rt @ rot


def camera_from_r2n2(rs: np.ndarray, ts: np.ndarray, mean: np.ndarray,
                     std: float) -> PerspectiveCamera:
    """Build the normalized-space camera for one R2N2 view
    (`shapenet_r2n2.py:65-95`): fold the dataset-global point normalization
    (x_norm = (x - mean)/std) into R/T, flip x/y for PyTorch3D screen
    convention, focal 2.1875.

    Args:
        rs: (3, 3) rotation from `compute_camera_calibration`.
        ts: (3,) translation.
        mean: (3,) dataset-global point mean.
        std: scalar dataset-global std.

    Returns:
        A single-camera `PerspectiveCamera` with leading batch dim 1.
    """
    pose = np.concatenate([np.asarray(rs), np.asarray(ts)[None]], axis=0)
    extrin = np.concatenate(
        [pose, np.array([[0.0, 0.0, 0.0, 1.0]]).T], axis=1)  # (4, 4)
    shapenet_to_pytorch3d = np.diag([-1.0, -1.0, 1.0, 1.0])
    rt = extrin @ shapenet_to_pytorch3d
    r = rt[:3, :3].copy()
    camera_r = r * std
    t = rt[3, :3].copy()
    camera_t = np.asarray(mean) @ r / std + t
    camera_r[:, :2] *= -1
    camera_t[:2] *= -1
    return PerspectiveCamera(
        R=_f32(camera_r)[None],
        T=_f32(camera_t)[None],
        focal_length=torch.full((1, 2), R2N2_FOCAL, dtype=torch.float32),
        principal_point=torch.zeros((1, 2), dtype=torch.float32),
    )


def compute_camera_calibration(rt: np.ndarray):
    """Split a ShapeNet world-to-camera RT into PyTorch3D R, T
    (`dataset/utils.py:87-114`)."""
    shapenet_to_pytorch3d = np.diag([-1.0, 1.0, -1.0, 1.0])
    rt = rt.T @ shapenet_to_pytorch3d
    return rt[:3, :3], rt[3, :3]


def stack_cameras(cameras: list[PerspectiveCamera]) -> PerspectiveCamera:
    """Concatenate single-view cameras into one batched camera."""
    return PerspectiveCamera(*(
        torch.cat([getattr(c, f) for c in cameras], dim=0)
        for f in ("R", "T", "focal_length", "principal_point")))
