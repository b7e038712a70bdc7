"""Networks, channel-last, with the reference checkpoints' state_dict keys."""

from bdm_tpu_torch.models.feature_model import FeatureModel, VisionTransformer
from bdm_tpu_torch.models.fusion import PVCNNFuse, ZeroConvProj
from bdm_tpu_torch.models.pvcnn import (PVCNN_FP_BLOCKS, PVCNN_SA_BLOCKS,
                                        PVCNN2, PVCNNDecoder, PVCNNEncoder,
                                        build_pvcnn2_specs)

__all__ = ["FeatureModel", "PVCNN2", "PVCNNDecoder", "PVCNNEncoder",
           "PVCNNFuse", "PVCNN_FP_BLOCKS", "PVCNN_SA_BLOCKS",
           "VisionTransformer", "ZeroConvProj", "build_pvcnn2_specs"]
