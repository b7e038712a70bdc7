"""Evaluation CLI over directories of .ply files
(`bdm_tpu/evaluation/cli.py`).

Rebuild of `evaluation_cd.py` / `evaluation_f1.py`: walk the pred dir,
match files by name in the gt dir, recenter, compute CD x1000 (mean +
NaN-name list) and F1@0.01 — batched on the card (or `--device cpu`)
instead of per-pair host loops.

    python -m bdm_tpu_torch.evaluation.cli --pred_dir ... --gt_dir ...
    python -m bdm_tpu_torch.evaluation.cli --metric f1 --pred_dir ... \
        --gt_dir ... --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from bdm_tpu_torch import resolve_device
from bdm_tpu_torch.evaluation.metrics import (chamfer_distance,
                                              emd_sinkhorn, fscore)
from bdm_tpu_torch.utils import read_ply


def evaluate_dirs(pred_dir: str, gt_dir: str, metric: str = "cd",
                  threshold: float = 0.01, batch_size: int = 16,
                  seed: int = 2003, device=None):
    """-> (finite values, names of the pairs whose value was not finite).
    `device=None` is the card."""
    device = resolve_device(device)
    np.random.seed(seed)
    names = sorted(f for f in os.listdir(pred_dir) if f.endswith(".ply"))
    pairs = [(os.path.join(pred_dir, n), os.path.join(gt_dir, n))
             for n in names if os.path.exists(os.path.join(gt_dir, n))]
    missing = [n for n in names
               if not os.path.exists(os.path.join(gt_dir, n))]
    if missing:
        print(f"WARNING: {len(missing)} pred files without gt match")

    values, nan_names = [], []
    for i in range(0, len(pairs), batch_size):
        chunk = pairs[i:i + batch_size]
        pred = torch.from_numpy(np.stack([read_ply(p) for p, _ in chunk]))
        gt = torch.from_numpy(np.stack([read_ply(g) for _, g in chunk]))
        pred, gt = pred.to(device), gt.to(device)
        if metric == "cd":
            v = chamfer_distance(pred, gt) * 1000.0
        elif metric == "f1":
            v = fscore(pred, gt, threshold=threshold)[0]
        elif metric == "emd":
            v = emd_sinkhorn(pred, gt, recenter=True)
        else:
            raise ValueError(metric)
        for (p, _), val in zip(chunk, v.cpu().numpy()):
            if not np.isfinite(val):
                nan_names.append(os.path.basename(p))
            else:
                values.append(float(val))
    return values, nan_names


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred_dir", required=True)
    parser.add_argument("--gt_dir", required=True)
    parser.add_argument("--metric", choices=("cd", "f1", "emd", "both"),
                        default="both")
    parser.add_argument("--threshold", type=float, default=0.01)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seed", type=int, default=2003)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)   # raises before any work

    metrics = ["cd", "f1"] if args.metric == "both" else [args.metric]
    for metric in metrics:
        values, nans = evaluate_dirs(args.pred_dir, args.gt_dir, metric,
                                     args.threshold, args.batch_size,
                                     args.seed, device)
        label = {"cd": "Chamfer-L2 x1000", "emd": "EMD (sinkhorn)"}.get(
            metric, f"F1@{args.threshold}")
        mean = float(np.mean(values)) if values else float("nan")
        print(f"{label}: {mean:.4f} over {len(values)} pairs")
        if nans:
            print(f"  NaN results: {nans}")


if __name__ == "__main__":
    main()
