"""Attention core of the PVConv `Attention` layer
(`bdm_tpu/models/layers.py`): softmax(q k^T) v without the 1/sqrt(C)
scale.

Large voxel sites (S >= 2048, C <= 128: the S = 4096 attention of stage 1)
run the `csrc/attention.cu` kernel, as the TPU path gates its Pallas kernel
on shape alone. The small sites (the global attention over 16 points at
C = 512) stay in plain PyTorch on every device, as the TPU path keeps them
in XLA einsums.
"""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import attention as _attn


def uses_kernel(s: int, c: int) -> bool:
    return s >= 2048 and c <= _attn.MAX_CHANNELS


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """q, k, v (B, S, C) -> (B, S, C) in v's dtype."""
    if uses_kernel(q.shape[1], q.shape[2]):
        return _attn.attention(q.contiguous(), k.contiguous(), v.contiguous())
    logits = torch.matmul(q, k.transpose(1, 2))
    w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.matmul(w, v)
