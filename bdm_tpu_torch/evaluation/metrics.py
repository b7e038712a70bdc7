"""Chamfer distance, F-score and Sinkhorn EMD, batched on the device of
their inputs (`bdm_tpu/evaluation/metrics.py`).

Reference semantics:
  * CD — `evaluation_cd.py:111-132`: both clouds recentered by their mean,
    CD = mean-over-points of squared nearest-neighbor distance, summed over
    both directions (PyTorch3D `chamfer_distance` default), reported x1000.
  * F1 — `evaluation_f1.py:90-110`: precision/recall of min *squared*
    distance < threshold (default 0.01), F = 2PR/(P+R).

Squared distances use the JAX package's |a|^2 + |b|^2 - 2ab expansion,
clamped at 0, in that order of operations: the F1 threshold is a squared
distance, so another formula moves points across it. The cross term is
exact float32 on any device and under any TF32 setting: with K = 3 it is
three products summed elementwise (x, then y, then z), no matrix product.
Plain PyTorch: at K = 3 there is no kernel to write.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _recenter(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(dim=1, keepdim=True)


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, N, M) float32 squared distances."""
    a, b = a.float(), b.float()
    a2 = torch.sum(a * a, dim=-1)
    b2 = torch.sum(b * b, dim=-1)
    ab = a[..., :, None, 0] * b[..., None, :, 0]
    for k in (1, 2):
        ab.addcmul_(a[..., :, None, k], b[..., None, :, k])
    d2 = a2[..., :, None] + b2[..., None, :]
    return d2.sub_(ab.mul_(2.0)).clamp_min_(0.0)


def pairwise_min_sqdist(a: torch.Tensor, b: torch.Tensor):
    """Min squared distance from each point of `a` to `b` and vice versa.

    a: (B, N, 3); b: (B, M, 3). Returns ((B, N), (B, M)).
    """
    d2 = _sqdist(a, b)
    return d2.amin(dim=2), d2.amin(dim=1)


def chamfer_distance(pred: torch.Tensor, gt: torch.Tensor,
                     recenter: bool = True) -> torch.Tensor:
    """Symmetric squared chamfer distance per batch element (B,).

    Multiply by 1000 for the reference's reported scale."""
    if recenter:
        pred, gt = _recenter(pred), _recenter(gt)
    d_pg, d_gp = pairwise_min_sqdist(pred, gt)
    return d_pg.mean(dim=1) + d_gp.mean(dim=1)


def fscore(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.01,
           recenter: bool = True):
    """F-score at a *squared*-distance threshold (reference default 0.01).

    Returns (f1, precision, recall), each (B,)."""
    if recenter:
        pred, gt = _recenter(pred), _recenter(gt)
    d_pg, d_gp = pairwise_min_sqdist(pred, gt)
    precision = (d_pg < threshold).float().mean(dim=1)
    recall = (d_gp < threshold).float().mean(dim=1)
    f1 = 2.0 * precision * recall / torch.clamp_min(precision + recall, 1e-8)
    return f1, precision, recall


def chamfer_distance_sharded(pred: torch.Tensor, gt: torch.Tensor, group,
                             recenter: bool = True) -> torch.Tensor:
    """`chamfer_distance` with the `pred` point axis sharded over the ranks
    of a process group: each rank holds its N/P of `pred` and all of `gt`
    -> (B,) on every rank, equal to `chamfer_distance` of the whole. The
    pred -> gt direction is a SUM of the shards' sums, the gt -> pred
    direction a MIN of the shards' minima; recentring takes the mean of
    the whole `pred` from a SUM of the shards' sums."""
    pred = pred.float()
    n = pred.shape[1] * dist.get_world_size(group)
    if recenter:
        s = pred.sum(dim=1, keepdim=True)
        dist.all_reduce(s, group=group)
        pred, gt = pred - s / n, _recenter(gt)
    d_pg, d_gp = pairwise_min_sqdist(pred, gt)
    pg_sum = d_pg.sum(dim=1)
    dist.all_reduce(pg_sum, group=group)
    dist.all_reduce(d_gp, dist.ReduceOp.MIN, group=group)
    return pg_sum / n + d_gp.mean(dim=1)


def emd_sinkhorn(pred: torch.Tensor, gt: torch.Tensor, epsilon: float = 0.002,
                 iters: int = 50, recenter: bool = False) -> torch.Tensor:
    """Entropy-regularized approximation of the earth mover's distance.

    Sinkhorn iterations on the distance cost with uniform marginals,
    reported as the transport-weighted mean distance (the usual point-cloud
    "EMD" convention, comparable to the matched-assignment distance as
    epsilon -> 0). The reference's EMD lived only in its dead TF1 metric
    code (`pvd/utils/metrics.py`).

    pred: (B, N, 3); gt: (B, M, 3). Returns (B,) float32.
    """
    if recenter:
        pred, gt = _recenter(pred), _recenter(gt)
    b, n, m = pred.shape[0], pred.shape[1], gt.shape[1]
    c = _sqdist(pred, gt).sqrt_()                                # (B, N, M)
    log_k = c / -epsilon
    log_a = torch.full((b, n), -float(torch.log(torch.tensor(float(n)))),
                       device=c.device)
    log_b = torch.full((b, m), -float(torch.log(torch.tensor(float(m)))),
                       device=c.device)
    f, g = torch.zeros_like(log_a), torch.zeros_like(log_b)
    for _ in range(iters):
        f = log_a - torch.logsumexp(log_k + g[:, None, :], dim=2)
        g = log_b - torch.logsumexp(log_k + f[:, :, None], dim=1)
    pi = (log_k + f[:, :, None]).add_(g[:, None, :]).exp_()     # (B, N, M)
    return torch.sum(pi.mul_(c), dim=(1, 2))
