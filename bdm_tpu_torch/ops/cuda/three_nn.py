"""Three nearest neighbours: the `csrc/three_nn.cu` kernel and its plain
version.

Replaces `three_nn_pallas` (bdm_tpu/ops/pallas/three_nn.py). A CPU tensor
goes to the plain version; a CUDA tensor launches the kernel. M >= 1: with
fewer than three centres the last one found repeats, as the JAX reference
gives it.

The kernel splits the centres of a query over `lanes(b, n, m)` lanes of a
warp (the source's `bdm_three_nn_lanes`); lane s scans the steps s, s + L,
... of `step(m)` consecutive centres (`bdm_three_nn_step`), centres staged
in shared memory `TILE` at a time.
"""

from __future__ import annotations

import torch

from bdm_tpu_torch.ops.cuda import _lib
from bdm_tpu_torch.ops.cuda.fps import sqdist

TILE = 2048          # centres staged a pass, `kTile` of the source
STEP_FROM = 256      # M from which a step holds 4 centres, `kStepFrom`
MIN_THREADS = 2 ** 15   # the threads `lanes` aims for


def step(m: int) -> int:
    """Centres a lane scans a step: 4 from STEP_FROM centres on, else 1
    (then the steps are the centres and the second phase is not needed)."""
    return 4 if m >= STEP_FROM else 1


def lanes(b: int, n: int, m: int) -> int:
    """Lanes that share a query's centres: the least power of two from 1 to
    32 that gives B * N * L at least MIN_THREADS threads, and no more than
    one step of centres a lane."""
    u, lanes_ = step(m), 1
    while lanes_ < 32 and b * n * lanes_ < MIN_THREADS and lanes_ * u < m:
        lanes_ *= 2
    return lanes_


def idw_weights(best: torch.Tensor) -> torch.Tensor:
    """(..., 3) squared distances -> inverse-distance weights, after the
    [1e-10, 1e10] clamp, in the reference's evaluation order."""
    best = torch.clamp(best, 1e-10, 1e10)
    d0, d1, d2 = best[..., 0], best[..., 1], best[..., 2]
    denom = (d0 * d1 + d0 * d2) + d1 * d2
    return torch.stack([d1 * d2, d0 * d2, d0 * d1], dim=-1) / denom[..., None]


def three_nn_plain(points: torch.Tensor, centers: torch.Tensor):
    """(B, N, 3), (B, M, 3) -> (idx (B, N, 3) int32, w (B, N, 3) float32);
    three masked argmins, so the lower index wins a tie."""
    _lib.plain_call("three_nn", points)
    m = centers.shape[1]
    d2 = sqdist(points[:, :, None, :], centers[:, None, :, :])   # (B, N, M)
    cur = d2.clone()
    bests, idxs = [], []
    for _ in range(min(3, m)):
        i = torch.argmin(cur, dim=-1, keepdim=True)               # first min
        bests.append(torch.gather(d2, -1, i))
        idxs.append(i)
        cur.scatter_(-1, i, float("inf"))
    while len(idxs) < 3:  # degenerate M < 3: repeat the last centre
        bests.append(bests[-1])
        idxs.append(idxs[-1])
    best = torch.cat(bests, dim=-1)
    idx = torch.cat(idxs, dim=-1).to(torch.int32)
    return idx, idw_weights(best)


@torch.no_grad()   # coordinates carry no gradient
def three_nn(points: torch.Tensor, centers: torch.Tensor):
    if points.device.type == "cpu":
        return three_nn_plain(points, centers)
    _lib.check(points, "points", (torch.float32,), 3)
    _lib.check(centers, "centers", (torch.float32,), 3)
    b, n, _ = points.shape
    m = centers.shape[1]
    if points.shape[-1] != 3 or centers.shape[::2] != (b, 3) or m < 1:
        raise ValueError(f"three_nn: points {tuple(points.shape)}, "
                         f"centers {tuple(centers.shape)} (needs M >= 1)")
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=points.device)
    w = torch.empty((b, n, 3), dtype=torch.float32, device=points.device)
    _lib.launch("bdm_three_nn", points.data_ptr(), centers.data_ptr(),
                idx.data_ptr(), w.data_ptr(), b, n, m)
    return idx, w
