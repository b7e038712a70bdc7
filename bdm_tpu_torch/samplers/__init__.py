"""Samplers: PC2 windows, the PVD prior, BDM-Blending and BDM-Merging."""

from bdm_tpu_torch.samplers.blending import bdm_blending, blend_point_clouds
from bdm_tpu_torch.samplers.merging import BDMMergingModel, bdm_merging
from bdm_tpu_torch.samplers.noise import NoiseProvider, TrainNoise
from bdm_tpu_torch.samplers.pc2 import (PC2Model, ProjectionConfig,
                                        compute_dtype_of)
from bdm_tpu_torch.samplers.pvd import PVDModel

__all__ = ["BDMMergingModel", "NoiseProvider", "PC2Model", "PVDModel",
           "ProjectionConfig", "TrainNoise", "bdm_blending", "bdm_merging",
           "blend_point_clouds", "compute_dtype_of"]
