"""Seeded stand-ins for what the repository does not hold (the released
checkpoints, a dataset view, training batches), shared by the measurement
scripts."""

from __future__ import annotations

import torch

from bdm_tpu_torch.conditioning import PerspectiveCamera
from bdm_tpu_torch.samplers import (BDMMergingModel, PC2Model,
                                    ProjectionConfig, PVDModel)


def camera(b: int, device) -> PerspectiveCamera:
    """An R2N2-like view: focal 2.1875, the cloud 1.75 units ahead."""
    return PerspectiveCamera(
        R=torch.eye(3).expand(b, 3, 3).contiguous(),
        T=torch.tensor([0.0, 0.0, 1.75]).expand(b, 3).contiguous(),
        focal_length=torch.full((b, 2), 2.1875),
        principal_point=torch.zeros(b, 2)).to(device)


@torch.no_grad()
def live_zero_convs(merge: BDMMergingModel, seed: int) -> None:
    """Seeded non-zero zero-convs, so the fusion net is not just PC2 and
    the PVD tower reaches the output."""
    g = torch.Generator().manual_seed(seed)
    for proj in merge.fusion.projs:
        w = proj[3].weight
        w.copy_(torch.randn(w.shape, generator=g) * 0.3 / w.shape[1] ** 0.5)


def production_models(seed: int = 0):
    """PC2 (ViT-S/16, 387 extra channels), PVD and the fusion model made
    of them, bf16, random weights from `seed`, on the card (the entry
    points' default device)."""
    cfg = ProjectionConfig(mixed_precision="bf16")
    pc2 = PC2Model(cfg)
    pvd = PVDModel(mixed_precision="bf16")
    merge = BDMMergingModel(cfg)
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
