"""Cameras, the rasterized surface projection and the mask distance
transform."""

from bdm_tpu_torch.conditioning.cameras import (
    PerspectiveCamera, camera_from_r2n2, compute_extrinsic_matrix,
    stack_cameras)
from bdm_tpu_torch.conditioning.distance_transform import (
    compute_distance_transform)
from bdm_tpu_torch.conditioning.projection import surface_projection

__all__ = ["PerspectiveCamera", "camera_from_r2n2",
           "compute_distance_transform", "compute_extrinsic_matrix",
           "stack_cameras", "surface_projection"]
