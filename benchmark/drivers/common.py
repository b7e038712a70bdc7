"""What the drivers share: the port's models built from a configuration,
seeded weights loaded into them, and the device's clock and memory."""

from __future__ import annotations

import time

import torch

from benchmark import weights
from benchmark.reference.models import PC2, PVD


def blocks(spec):
    """JSON lists -> the nested tuples the port's block specs are."""
    if isinstance(spec, list):
        return tuple(blocks(x) for x in spec)
    return spec


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def build_kernels(dev) -> float:
    """Build or load the port's kernel library: -> seconds it took."""
    t = time.perf_counter()
    if dev.type == "cuda":
        from bdm_tpu_torch.ops import cuda as kernels
        kernels.build()
    return time.perf_counter() - t


def pc2_program(cfg: dict, dev):
    from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig
    c = cfg["pc2"]
    pcfg = ProjectionConfig(
        image_size=c["image_size"],
        image_feature_model=c["image_feature_model"],
        raster_point_radius=c["raster_point_radius"],
        beta_start=c["beta_start"], beta_end=c["beta_end"],
        point_cloud_model_embed_dim=c["embed_dim"],
        mixed_precision=cfg["precision"],
        precontract=cfg.get("precontract", False))
    return PC2Model(pcfg, sa_blocks=blocks(c["sa_blocks"]),
                    fp_blocks=blocks(c["fp_blocks"]), vit_kwargs=c["vit"],
                    device=dev, dropout=c["dropout"])


def pvd_program(cfg: dict, dev):
    from bdm_tpu_torch.samplers import PVDModel
    c = cfg["pvd"]
    return PVDModel(embed_dim=c["embed_dim"], use_att=c["use_att"],
                    beta_start=c["beta_start"], beta_end=c["beta_end"],
                    model_var_type=c["model_var_type"],
                    sa_blocks=blocks(c["sa_blocks"]),
                    fp_blocks=blocks(c["fp_blocks"]),
                    mixed_precision=cfg["precision"], device=dev,
                    dropout=c["dropout"])


def seeded_state(kind: str, cfg: dict, seed: int, dev) -> dict:
    """The run's weights for "pc2" or "pvd", under the reference keys."""
    with torch.device("meta"):
        shape = PC2(cfg["pc2"]) if kind == "pc2" else PVD(cfg["pvd"])
    return weights.state_dict(shape, seed, 2 if kind == "pc2" else 3, dev)


def camera(cam: dict):
    from bdm_tpu_torch.conditioning import PerspectiveCamera
    return PerspectiveCamera(**cam)
