"""Seeded stand-ins for what the repository does not hold (the released
checkpoints, a dataset view, training batches), shared by the measurement
scripts."""

from __future__ import annotations

import numpy as np
import torch

from bdm_tpu_torch.conditioning import PerspectiveCamera
from bdm_tpu_torch.samplers import (BDMMergingModel, PC2Model,
                                    ProjectionConfig, PVDModel)

# The tiny PVCNN2 blocks of the quick runs, as `tests/test_models.py` has them
TINY_SA = (
    ((8, 2, 4), (16, 0.3, 8, (8, 16))),
    ((16, 2, 4), (8, 0.4, 8, (16, 32))),
    (None, (4, 0.8, 8, (32, 64))),
)
TINY_FP = (
    ((32, 32), (16, 1, 4)),
    ((16, 16), (16, 1, 4)),
    ((16, 8), (8, 1, 4)),
)


def camera(b: int, device) -> PerspectiveCamera:
    """An R2N2-like view: focal 2.1875, the cloud 1.75 units ahead."""
    return PerspectiveCamera(
        R=torch.eye(3).expand(b, 3, 3).contiguous(),
        T=torch.tensor([0.0, 0.0, 1.75]).expand(b, 3).contiguous(),
        focal_length=torch.full((b, 2), 2.1875),
        principal_point=torch.zeros(b, 2)).to(device)


def synthetic_batch(b: int, n: int, image_size: int,
                    rng: np.random.Generator) -> dict:
    """`__graft_entry__._synthetic_batch`, `bench.py`'s batch, as CPU
    tensors: the same draws in the same order (points N(0, 0.3^2), then the
    image uniform in [0, 1]) and its camera (R = I, the cloud 1.5 units
    ahead, focal 2.1875, principal point 0)."""
    points = rng.standard_normal((b, n, 3)).astype(np.float32) * 0.3
    image = rng.uniform(0, 1, (b, image_size, image_size, 3)).astype(
        np.float32)
    return {
        "points": torch.from_numpy(points),
        "image": torch.from_numpy(image),
        "camera": PerspectiveCamera(
            R=torch.eye(3).expand(b, 3, 3).contiguous(),
            T=torch.tensor([0.0, 0.0, 1.5]).expand(b, 3).contiguous(),
            focal_length=torch.full((b, 2), 2.1875),
            principal_point=torch.zeros(b, 2)),
    }


@torch.no_grad()
def live_zero_convs(merge: BDMMergingModel, seed: int) -> None:
    """Seeded non-zero zero-convs, so the fusion net is not just PC2 and
    the PVD tower reaches the output."""
    g = torch.Generator().manual_seed(seed)
    for proj in merge.fusion.projs:
        w = proj[3].weight
        w.copy_(torch.randn(w.shape, generator=g) * 0.3 / w.shape[1] ** 0.5)


def production_models(seed: int = 0, mixed_precision: str = "bf16",
                      precontract: bool = False, device=None,
                      quick: bool = False):
    """PC2 (ViT-S/16, 387 extra channels), PVD and the fusion model made
    of them, bf16 unless `mixed_precision` says otherwise, random weights
    from `seed`, on the card unless `device` names another. With `quick`
    tiny ones: the identity feature model at image 16, `TINY_SA` /
    `TINY_FP`, embedding 8."""
    blocks, embed = {}, {}
    if quick:
        cfg = ProjectionConfig(image_size=16, image_feature_model="identity",
                               raster_point_radius=0.3,
                               point_cloud_model_embed_dim=8,
                               mixed_precision=mixed_precision,
                               precontract=precontract)
        blocks = {"sa_blocks": TINY_SA, "fp_blocks": TINY_FP}
        embed = {"embed_dim": 8}
    else:
        cfg = ProjectionConfig(mixed_precision=mixed_precision,
                               precontract=precontract)
    pc2 = PC2Model(cfg, device=device, **blocks)
    pvd = PVDModel(mixed_precision=mixed_precision, device=device, **embed,
                   **blocks)
    merge = BDMMergingModel(cfg, device=device, **blocks)
    pc2.reset_parameters(seed)
    pvd.reset_parameters(seed + 1)
    merge.init_from_pretrained(pc2, pvd, seed=seed + 2)
    live_zero_convs(merge, seed + 3)
    return pc2.eval(), pvd.eval(), merge.eval()


def training_batches(seed: int, b: int, n: int, device, image_size: int = 224,
                     repeat: bool = False):
    """An endless iterator of model-form training batches {"image":
    (B, S, S, 3) in [0, 1], "camera", "points": (B, N, 3)} made on the CPU
    from `seed` and moved to `device`: points uniform on the unit sphere,
    scaled to the half-unit extent of a normalised reference cloud. With
    `repeat` every batch is the first one."""
    g = torch.Generator().manual_seed(seed)
    cam = camera(b, device)

    def make():
        p = torch.randn(b, n, 3, generator=g)
        p = 0.5 * p / p.norm(dim=-1, keepdim=True)
        image = torch.rand(b, image_size, image_size, 3, generator=g)
        return {"image": image.to(device), "camera": cam,
                "points": p.to(device)}

    first = make()
    yield first
    while True:
        yield first if repeat else make()
