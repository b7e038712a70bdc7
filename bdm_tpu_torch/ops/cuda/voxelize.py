"""Voxel scatter-mean: the `csrc/voxelize.cu` kernel and its plain version.

Replaces `scatter_sum_sorted_padded_pallas` (bdm_tpu/ops/pallas/voxelize.py)
together with the pre-division of `_avg_voxelize_padded_fwd_impl`
(bdm_tpu/ops/voxelize.py): each contribution is divided by its voxel's
count before the sum, the sum runs in sorted order in float32 and is
rounded once to `out_dtype`. Output is the channel-last (B, R, R, R, C)
grid, not the TPU's D-padded layout.
"""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import _lib

launches = 0
plain_cuda_calls = 0


def scatter_mean_plain(features: torch.Tensor, order: torch.Tensor,
                       ids_sorted: torch.Tensor, voxel_lo: torch.Tensor,
                       resolution: int,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """features (B, N, C); order / ids_sorted (B, N) int32 (the stable sort
    of the voxel ids); voxel_lo (B, R^3 + 1) int32 run starts
    -> (B, R, R, R, C) mean grid, empty voxels zero."""
    global plain_cuda_calls
    if features.is_cuda:
        plain_cuda_calls += 1
    b, n, c = features.shape
    r3 = resolution ** 3
    f_sorted = torch.gather(features, 1,
                            order.long()[..., None].expand(b, n, c))
    counts = (voxel_lo[:, 1:] - voxel_lo[:, :-1])                # (B, R^3)
    cnt = torch.gather(counts, 1, ids_sorted.long()).float()     # (B, N)
    fm = f_sorted.float() / cnt[..., None]
    flat = (ids_sorted.long()
            + torch.arange(b, device=features.device)[:, None] * r3)
    out = torch.zeros((b * r3, c), dtype=torch.float32,
                      device=features.device)
    out.index_add_(0, flat.reshape(-1), fm.reshape(b * n, c))
    return out.reshape((b,) + (resolution,) * 3 + (c,)).to(out_dtype)


def scatter_mean(features: torch.Tensor, order: torch.Tensor,
                 ids_sorted: torch.Tensor, voxel_lo: torch.Tensor,
                 resolution: int,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    global launches
    if features.device.type == "cpu":
        return scatter_mean_plain(features, order, ids_sorted, voxel_lo,
                                  resolution, out_dtype)
    dts = tuple(_lib.DTYPE_CODES)
    _lib.check(features, "features", dts, 3)
    _lib.check(order, "order", (torch.int32,), 2)
    _lib.check(voxel_lo, "voxel_lo", (torch.int32,), 2)
    b, n, c = features.shape
    r3 = resolution ** 3
    if (order.shape != (b, n) or voxel_lo.shape != (b, r3 + 1)
            or out_dtype not in _lib.DTYPE_CODES):
        raise ValueError(f"scatter_mean: features {tuple(features.shape)}, "
                         f"order {tuple(order.shape)}, voxel_lo "
                         f"{tuple(voxel_lo.shape)}, R={resolution}, "
                         f"out {out_dtype}")
    out = torch.empty((b,) + (resolution,) * 3 + (c,), dtype=out_dtype,
                      device=features.device)
    _lib.launch("bdm_scatter_mean", features.data_ptr(), order.data_ptr(),
                voxel_lo.data_ptr(), out.data_ptr(), b, n, c, r3,
                _lib.DTYPE_CODES[features.dtype], _lib.DTYPE_CODES[out_dtype])
    launches += 1
    return out
