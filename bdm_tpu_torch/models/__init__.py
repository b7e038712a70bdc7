"""Networks, channel-last, with the reference checkpoints' state_dict keys."""

from bdm_tpu_torch.models.feature_model import FeatureModel, VisionTransformer
from bdm_tpu_torch.models.fusion import PVCNNFuse, ZeroConvProj
from bdm_tpu_torch.models.pvcnn import (PVCNN_FP_BLOCKS, PVCNN_SA_BLOCKS,
                                        PVCNN2, PVCNNDecoder, PVCNNEncoder,
                                        build_pvcnn2_specs)

_COLORING = ("PointCloudColoringModel", "PointCloudModelBlock",
             "PointCloudTransformerModel")


def __getattr__(name):
    """The colouring model is imported at first use: it takes PC2's
    conditioning from `samplers`, which imports this package."""
    if name in _COLORING:
        from bdm_tpu_torch.models import coloring
        return getattr(coloring, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["FeatureModel", "PVCNN2", "PVCNNDecoder", "PVCNNEncoder",
           "PVCNNFuse", "PVCNN_FP_BLOCKS", "PVCNN_SA_BLOCKS",
           "PointCloudColoringModel", "PointCloudModelBlock",
           "PointCloudTransformerModel",
           "VisionTransformer", "ZeroConvProj", "build_pvcnn2_specs"]
