"""Cameras and the rasterized surface projection."""

from bdm_tpu_torch.conditioning.cameras import PerspectiveCamera
from bdm_tpu_torch.conditioning.projection import surface_projection

__all__ = ["PerspectiveCamera", "surface_projection"]
