"""Synthetic dataset: random clouds/images/cameras with the same sample
schema as the real loaders — for tests, smoke runs on the card, and
smoke-training without ShapeNet on disk (`bdm_tpu/data/synthetic.py`: the
same per-index seeding, so the samples equal the JAX package's)."""

from __future__ import annotations

import numpy as np
import torch

from bdm_tpu_torch.conditioning.cameras import R2N2_FOCAL, PerspectiveCamera


class SyntheticDataset:
    def __init__(self, num_samples: int = 64, max_points: int = 4096,
                 image_size: int = 224, seed: int = 0):
        self.num_samples = num_samples
        self.max_points = max_points
        self.image_size = image_size
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        s = self.image_size
        camera = PerspectiveCamera(
            R=torch.eye(3)[None],
            T=torch.tensor([[0.0, 0.0, 1.5]]),
            focal_length=torch.full((1, 2), R2N2_FOCAL),
            principal_point=torch.zeros((1, 2)),
        )
        return {
            "points": rng.standard_normal(
                (self.max_points, 3)).astype(np.float32) * 0.3,
            "image": rng.uniform(0, 1, (s, s, 3)).astype(np.float32),
            "camera": camera,
            "sequence_name": f"synthetic_{idx:05d}",
            "sequence_category": "synthetic",
        }
