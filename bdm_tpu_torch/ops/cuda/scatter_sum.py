"""Unsorted segment sum: the `csrc/scatter_sum.cu` kernel and its plain
version.

Replaces `scatter_sum_pallas` (bdm_tpu/ops/pallas/voxelize.py):
out[b, s] = sum of features[b, n] over the rows with ids[b, n] == s,
float32 accumulation in index order, float32 result. The backward of the
three-neighbour blend (`ops.cuda.interp`) is its caller on the training
path; it runs inside that rule, where no graph is built, so it is not
differentiable itself.
"""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import _lib

launches = 0
plain_cuda_calls = 0


def scatter_sum_plain(features: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """features (B, N, C) float32 or bfloat16, ids (B, N) int32 in [0, S)
    -> (B, S, C) float32."""
    global plain_cuda_calls
    if features.is_cuda:
        plain_cuda_calls += 1
    b, n, c = features.shape
    s = int(num_segments)
    flat = ids.long() + torch.arange(b, device=ids.device)[:, None] * s
    out = torch.zeros((b * s, c), dtype=torch.float32,
                      device=features.device)
    out.index_add_(0, flat.reshape(-1), features.reshape(b * n, c).float())
    return out.reshape(b, s, c)


def scatter_sum(features: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    global launches
    features = features.detach()
    if features.device.type == "cpu":
        return scatter_sum_plain(features, ids, num_segments)
    _lib.check(features, "features", tuple(_lib.DTYPE_CODES), 3)
    _lib.check(ids, "ids", (torch.int32,), 2)
    b, n, c = features.shape
    s = int(num_segments)
    if ids.shape != (b, n) or s < 0 or b > 65535:
        raise ValueError(f"scatter_sum: features {tuple(features.shape)}, "
                         f"ids {tuple(ids.shape)}, S={s}")
    out = torch.empty((b, s, c), dtype=torch.float32, device=features.device)
    _lib.launch("bdm_scatter_sum", features.data_ptr(), ids.data_ptr(),
                out.data_ptr(), b, n, c, s, _lib.DTYPE_CODES[features.dtype])
    launches += 1
    return out
