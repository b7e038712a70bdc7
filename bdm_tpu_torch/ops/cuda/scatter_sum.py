"""Unsorted segment sum: the `csrc/scatter_sum.cu` kernels and their plain
version.

Replaces `scatter_sum_pallas` (bdm_tpu/ops/pallas/voxelize.py):
out[b, s] = sum of features[b, n] over the rows with ids[b, n] == s,
float32 accumulation in index order, float32 result; a row whose id lies
outside [0, S) is dropped. The backward of the three-neighbour blend
(`ops.cuda.interp`) is its caller on the training path; it runs inside
that rule, where no graph is built, so it is not differentiable itself.

The source builds a stable CSR of the ids (count, tiles, scan, place) and
sums each segment's run (`csrc/runs.cuh`): five kernels a call, counted as
one launch. This wrapper allocates the CSR's scratch: `order` and `rank`
(B, N), `lo` (B, S + 1) and a (B, tiles, S) table of counters, one row a
tile of `tile(N, S)` ids. The rows are read in the vectors of
`voxelize.kernel_path`, so the features must be aligned to one.
"""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import _lib
from bdm_tpu_torch.ops.cuda import voxelize as _vox



def tile(n: int, s: int) -> int:
    """Ids a warp of the CSR build walks: 256, doubled while the (tiles, S)
    counter table would hold more than 4 (N + S) entries and a tile is
    shorter than N."""
    t = 256
    while tiles(n, t) * s > 4 * (n + s) and t < n:
        t *= 2
    return t


def tiles(n: int, t: int) -> int:
    return max(1, -(-n // t))


def scatter_sum_plain(features: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """features (B, N, C) float32 or bfloat16, ids (B, N) int32
    -> (B, S, C) float32; a row whose id lies outside [0, S) is dropped."""
    _lib.plain_call("scatter_sum", features)
    b, n, c = features.shape
    s = int(num_segments)
    flat = ids.long() + torch.arange(b, device=ids.device)[:, None] * s
    # a dropped row lands in one extra row past the B * S sums; the other
    # rows keep their index order, so their sums do not change
    flat = torch.where((ids >= 0) & (ids < s), flat, b * s)
    out = torch.zeros((b * s + 1, c), dtype=torch.float32,
                      device=features.device)
    out.index_add_(0, flat.reshape(-1), features.reshape(b * n, c).float())
    return out[:-1].reshape(b, s, c)


def scatter_sum(features: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    features = features.detach()
    if features.device.type == "cpu":
        return scatter_sum_plain(features, ids, num_segments)
    _lib.check(features, "features", tuple(_lib.DTYPE_CODES), 3)
    _lib.check(ids, "ids", (torch.int32,), 2)
    b, n, c = features.shape
    s = int(num_segments)
    if ids.shape != (b, n) or s < 0:
        raise ValueError(f"scatter_sum: features {tuple(features.shape)}, "
                         f"ids {tuple(ids.shape)}, S={s}")
    out = torch.empty((b, s, c), dtype=torch.float32, device=features.device)
    vec = _vox.kernel_path(features.dtype, torch.float32, c)[0]
    if features.data_ptr() % (vec * features.element_size()):
        raise ValueError(f"scatter_sum: features must be "
                         f"{vec * features.element_size()}-byte aligned")
    t = tile(n, s)
    order, rank = (torch.empty((b, n), dtype=torch.int32,
                               device=features.device) for _ in range(2))
    lo = torch.empty((b, s + 1), dtype=torch.int32, device=features.device)
    counters = torch.empty((b, tiles(n, t), s), dtype=torch.int32,
                           device=features.device)
    _lib.launch("bdm_scatter_sum", features.data_ptr(), ids.data_ptr(),
                out.data_ptr(), order.data_ptr(), lo.data_ptr(),
                rank.data_ptr(), counters.data_ptr(), b, n, c, s, t,
                _lib.DTYPE_CODES[features.dtype])
    return out
