"""Furthest point sampling: the `csrc/fps.cu` kernel and its plain version.

Replaces `furthest_point_sample_pallas` (bdm_tpu/ops/pallas/fps.py). A CPU
tensor goes to the plain version; a CUDA tensor launches the kernel.

The kernel runs one block a cloud; `threads(n)` is its block size (the
source's `bdm_fps_threads`), and thread t holds the points t, t + T, ...:
`points(n)` of them (`bdm_fps_points`), in registers up to
MAX_REGISTER_POINTS, above it streamed every round with the running
distances in a (B, N) float32 scratch this wrapper allocates, so N has no
limit.
"""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import _lib

POINTS_A_THREAD = 8   # `kPointsAThread` of the source
MAX_REGISTER_POINTS = 16   # the largest K the source keeps in registers


def threads(n: int) -> int:
    """Threads of the block that samples a cloud of `n` points:
    n / POINTS_A_THREAD rounded up to a warp, at most 1024."""
    t = -(-n // POINTS_A_THREAD)
    return min(1024, max(32, -(-t // 32) * 32))


def points(n: int) -> int:
    """Points a thread of that block holds: ceil(n / threads(n)) rounded up
    to a power of two."""
    return 1 << (-(-n // threads(n)) - 1).bit_length()


def _scratch(coords: torch.Tensor):
    """The running distances of the streamed variant, or None."""
    b, n, _ = coords.shape
    if points(n) <= MAX_REGISTER_POINTS:
        return None
    return torch.empty((b, n), dtype=torch.float32, device=coords.device)


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(dx*dx + dy*dy) + dz*dz of a - b over the last axis: the
    evaluation order of the JAX reference and of the kernels."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def furthest_point_sample_plain(coords: torch.Tensor,
                                num_samples: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, M) int32; index 0 first, then the argmax of
    the running min squared distance, lowest index on ties."""
    _lib.plain_call("fps", coords)
    b, n, _ = coords.shape
    m = int(num_samples)
    out = torch.zeros((b, m), dtype=torch.int32, device=coords.device)
    dist = torch.full((b, n), 1e38, dtype=torch.float32, device=coords.device)
    last = coords[:, 0, :]
    rows = torch.arange(b, device=coords.device)
    for j in range(1, m):
        dist = torch.minimum(dist, sqdist(coords, last[:, None, :]))
        best = torch.argmax(dist, dim=1)        # first maximal index
        out[:, j] = best.to(torch.int32)
        last = coords[rows, best]
    return out


@torch.no_grad()   # coordinates carry no gradient
def furthest_point_sample(coords: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, M) int32 furthest point sample."""
    if coords.device.type == "cpu":
        return furthest_point_sample_plain(coords, num_samples)
    _lib.check(coords, "coords", (torch.float32,), 3)
    b, n, c = coords.shape
    m = int(num_samples)
    if c != 3 or not 1 <= m <= n:
        raise ValueError(f"fps: coords {tuple(coords.shape)}, M={m}")
    out = torch.empty((b, m), dtype=torch.int32, device=coords.device)
    dist = _scratch(coords)
    _lib.launch("bdm_fps", coords.data_ptr(),
                None if dist is None else dist.data_ptr(), out.data_ptr(), b,
                n, m)
    return out
