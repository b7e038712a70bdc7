"""Voxel scatter-mean: the `csrc/voxelize.cu` kernel and its plain version.

Replaces `scatter_sum_sorted_padded_pallas` and `scatter_sum_sorted_pallas`
(bdm_tpu/ops/pallas/voxelize.py) together with the pre-division of
`_avg_voxelize_padded_fwd_impl` and `_avg_voxelize_ctx_fwd_impl`
(bdm_tpu/ops/voxelize.py): each contribution is divided by its voxel's
count before the sum, the sum runs in sorted order in float32 and is
rounded once to `out_dtype`. With `divide=False` the contributions are
summed as they are (the raw-sum contract of `scatter_sum_sorted_pallas`
under `_scatter_augmented`). Output is the channel-last (B, R, R, R, C)
grid, not the TPU's D-padded layout.

The kernel gives each voxel row a group of lanes that walks it in vectors;
`kernel_path` says how many elements a vector and lanes a voxel it takes
for a pair of types and C (the source's `bdm_scatter_mean_vec` and
`bdm_scatter_mean_lanes`).

`scatter_mean` is differentiable in the features
(`_avg_voxelize_ctx_bwd`): d out / d feature = grad[voxel(p)] / count, one
gather, in the features' dtype.
"""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import _lib



def kernel_path(in_dtype: torch.dtype, out_dtype: torch.dtype,
                c: int) -> tuple[int, int]:
    """-> (elements a vector, lanes a voxel): the most of 8, 4, 2, 1 that
    divides C with the wider type at 16 bytes a vector; the row's vectors
    rounded up to a power of two, at most 32."""
    widest = max(in_dtype.itemsize, out_dtype.itemsize)
    vec = next(v for v in (8, 4, 2, 1) if v * widest <= 16 and c % v == 0)
    lanes = 1
    while lanes < c // vec and lanes < 32:
        lanes *= 2
    return vec, lanes


def run_counts(ids_sorted: torch.Tensor,
               voxel_lo: torch.Tensor) -> torch.Tensor:
    """The occupancy of each sorted point's voxel, (B, N) float32 >= 1:
    the length of its run in the sorted ids."""
    counts = voxel_lo[:, 1:] - voxel_lo[:, :-1]                  # (B, R^3)
    return torch.gather(counts, 1, ids_sorted.long()).float()


def scatter_mean_plain(features: torch.Tensor, order: torch.Tensor,
                       ids_sorted: torch.Tensor, voxel_lo: torch.Tensor,
                       resolution: int,
                       out_dtype: torch.dtype = torch.float32,
                       divide: bool = True) -> torch.Tensor:
    """features (B, N, C); order / ids_sorted (B, N) int32 (the stable sort
    of the voxel ids); voxel_lo (B, R^3 + 1) int32 run starts
    -> (B, R, R, R, C) mean grid (sum grid with `divide=False`), empty
    voxels zero."""
    _lib.plain_call("scatter_mean", features)
    b, n, c = features.shape
    r3 = resolution ** 3
    fm = torch.gather(features, 1,
                      order.long()[..., None].expand(b, n, c)).float()
    if divide:
        fm = fm / run_counts(ids_sorted, voxel_lo)[..., None]
    flat = (ids_sorted.long()
            + torch.arange(b, device=features.device)[:, None] * r3)
    out = torch.zeros((b * r3, c), dtype=torch.float32,
                      device=features.device)
    out.index_add_(0, flat.reshape(-1), fm.reshape(b * n, c))
    return out.reshape((b,) + (resolution,) * 3 + (c,)).to(out_dtype)


def _forward(features, order, ids_sorted, voxel_lo, resolution, out_dtype,
             divide):
    if features.device.type == "cpu":
        return scatter_mean_plain(features, order, ids_sorted, voxel_lo,
                                  resolution, out_dtype, divide)
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
    vec = kernel_path(features.dtype, out_dtype, c)[0]
    if features.data_ptr() % (vec * features.element_size()):
        raise ValueError(f"scatter_mean: features must be "
                         f"{vec * features.element_size()}-byte aligned")
    out = torch.empty((b,) + (resolution,) * 3 + (c,), dtype=out_dtype,
                      device=features.device)
    _lib.launch("bdm_scatter_mean", features.data_ptr(), order.data_ptr(),
                voxel_lo.data_ptr(), out.data_ptr(), b, n, c, r3,
                int(bool(divide)), _lib.DTYPE_CODES[features.dtype],
                _lib.DTYPE_CODES[out_dtype])
    return out


class _ScatterMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, order, ids_sorted, voxel_lo, resolution,
                out_dtype, divide, ids):
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(ids, voxel_lo)
            ctx.divide, ctx.in_dtype = divide, features.dtype
        return _forward(features, order, ids_sorted, voxel_lo, resolution,
                        out_dtype, divide)

    @staticmethod
    def backward(ctx, g):
        ids, voxel_lo = ctx.saved_tensors
        b, n = ids.shape
        c = g.shape[-1]
        ids = ids.long()
        rows = torch.gather(g.reshape(b, -1, c), 1,
                            ids[..., None].expand(b, n, c)).float()
        if ctx.divide:
            counts = (voxel_lo[:, 1:] - voxel_lo[:, :-1]).float()
            rows = rows * (1.0 / torch.gather(counts, 1, ids))[..., None]
        return (rows.to(ctx.in_dtype),) + (None,) * 7


def scatter_mean(features: torch.Tensor, order: torch.Tensor,
                 ids_sorted: torch.Tensor, voxel_lo: torch.Tensor,
                 resolution: int, out_dtype: torch.dtype = torch.float32,
                 divide: bool = True, *, ids: torch.Tensor) -> torch.Tensor:
    """`ids` (B, N) int32, the voxel id of every point in the points' own
    order, serves the backward's gather; the other arguments as
    `scatter_mean_plain`."""
    return _ScatterMean.apply(features, order, ids_sorted, voxel_lo,
                              resolution, out_dtype, divide, ids)
