"""Evaluation: batched Chamfer / F-score / Sinkhorn EMD on the card, the
generative metrics, and a directory-walking CLI
(`bdm_tpu_torch.evaluation.cli`); `bdm_tpu/evaluation/` in PyTorch.
"""

from bdm_tpu_torch.evaluation.metrics import (
    chamfer_distance,
    chamfer_distance_sharded,
    emd_sinkhorn,
    fscore,
    pairwise_min_sqdist,
)

__all__ = ["chamfer_distance", "chamfer_distance_sharded", "emd_sinkhorn",
           "fscore", "pairwise_min_sqdist"]
