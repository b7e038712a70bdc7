"""Generative point-cloud metrics: MMD, Coverage, 1-NNA, JSD
(`bdm_tpu/evaluation/gen_metrics.py`).

Rebuild of the reference's `pvd/utils/metrics.py` surface (SURVEY.md #49 —
TF1-era and effectively dead there): the pairwise chamfer distances are
computed on the device of the clouds, one row at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from bdm_tpu_torch.evaluation.metrics import chamfer_distance


def pairwise_chamfer_matrix(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Chamfer distance between every pair: a (S, N, 3), b (R, M, 3) ->
    (S, R) float32 NumPy."""
    s = a.shape[0]
    out = np.zeros((s, b.shape[0]), dtype=np.float32)
    for i in range(s):
        row = chamfer_distance(a[i][None].expand(b.shape[0], -1, -1), b,
                               recenter=False)
        out[i] = row.cpu().numpy()
    return out


def mmd_cov(sample: torch.Tensor, reference: torch.Tensor):
    """MMD-CD (mean over references of min distance to a sample) and
    Coverage (fraction of references matched by some sample)."""
    d = pairwise_chamfer_matrix(sample, reference)  # (S, R)
    mmd = float(d.min(axis=0).mean())
    cov = float(len(np.unique(d.argmin(axis=1))) / d.shape[1])
    return mmd, cov


def one_nna(sample: torch.Tensor, reference: torch.Tensor) -> float:
    """1-NN two-sample test accuracy (0.5 is ideal)."""
    s, r = sample.shape[0], reference.shape[0]
    allpc = torch.cat([sample, reference], dim=0)
    d = pairwise_chamfer_matrix(allpc, allpc)
    np.fill_diagonal(d, np.inf)
    nn = d.argmin(axis=1)
    labels = np.arange(s + r) < s  # True = sample
    pred = nn < s
    return float((pred == labels).mean())


def jsd_between_point_cloud_sets(sample, reference,
                                 resolution: int = 28) -> float:
    """Jensen-Shannon divergence between voxel-occupancy marginals over
    [-0.5, 0.5]^3 (the standard PVD evaluation grid); NumPy on the host,
    as in the JAX package."""

    def occupancy(clouds):
        grid = np.zeros(resolution ** 3, dtype=np.float64)
        if isinstance(clouds, torch.Tensor):
            clouds = clouds.cpu().numpy()
        for pc in np.asarray(clouds):
            ids = np.clip(((pc + 0.5) * resolution).astype(int), 0,
                          resolution - 1)
            flat = (ids[:, 0] * resolution + ids[:, 1]) * resolution \
                + ids[:, 2]
            grid[np.unique(flat)] += 1.0
        return grid / max(grid.sum(), 1e-12)

    p, q = occupancy(sample), occupancy(reference)
    m = 0.5 * (p + q)

    def kl(x, y):
        mask = x > 0
        return float(np.sum(x[mask] * np.log(x[mask] / y[mask])))

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)
