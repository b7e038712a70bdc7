"""Cameras, the rasterized surface projection and the mask distance
transform."""

from bdm_tpu_torch.conditioning.cameras import PerspectiveCamera
from bdm_tpu_torch.conditioning.distance_transform import (
    compute_distance_transform)
from bdm_tpu_torch.conditioning.projection import surface_projection

__all__ = ["PerspectiveCamera", "compute_distance_transform",
           "surface_projection"]
