"""PC2, the projection-conditioned point-cloud diffusion model
(`bdm_tpu/samplers/pc2.py`).

The image conditioning map (normalized colours + ViT features) is computed
once per image and flattened and cast to the compute dtype once per
trajectory; each step projects it onto the current points, concatenates
[x_t | projected map] and runs PVCNN2. State-dict keys follow the
reference (`point_cloud_model.model.*`, `feature_model.model.*`).

Supported here: the released PC2 configuration (local colours and
features, no mask, no global features, `raster_splat="multi"`, DDPM and
DDIM windows, `precontract=False`), sampling and the training loss.

The model lives on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn

from bdm_tpu_torch import resolve_device
from bdm_tpu_torch.conditioning import PerspectiveCamera, surface_projection
from bdm_tpu_torch.diffusion import (DDIMScheduler, DDPMScheduler,
                                     linear_betas)
from bdm_tpu_torch.models.feature_model import FeatureModel
from bdm_tpu_torch.models.layers import dropout_masks
from bdm_tpu_torch.models.pvcnn import (PVCNN_FP_BLOCKS, PVCNN_SA_BLOCKS,
                                        PVCNN2)
from bdm_tpu_torch.samplers.noise import TrainNoise


def compute_dtype_of(mixed_precision: str) -> Optional[torch.dtype]:
    """`run.mixed_precision` -> compute dtype (None = float32); "fp16"
    maps to bf16 as in the JAX package."""
    mp = (mixed_precision or "no").lower()
    if mp in ("no", "none", "fp32", "f32", "float32"):
        return None
    if mp in ("bf16", "bfloat16", "fp16", "float16"):
        return torch.bfloat16
    raise ValueError(f"Unknown mixed_precision: {mixed_precision!r}")


@dataclass(frozen=True)
class ProjectionConfig:
    """The fields of `bdm_tpu.samplers.pc2.ProjectionConfig` this port
    honours, with the same defaults."""

    image_size: int = 224
    image_feature_model: str = "vit_small_patch16_224_msn"
    image_color_channels: int = 3
    colors_mean: float = 0.5
    colors_std: float = 0.5
    scale_factor: float = 1.0
    raster_point_radius: float = 0.0075
    beta_start: float = 1e-5
    beta_end: float = 8e-3
    point_cloud_model_embed_dim: int = 64
    mixed_precision: str = "no"


class _Holder(nn.Module):
    """Gives the wrapped network the reference's `<name>.model.` keys."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model


class ProjectionConditioned(nn.Module):
    """What PC2 and the BDM-Merging model share: the image feature model,
    the conditioning map, its projection onto the points and the two
    schedulers."""

    def __init__(self, cfg: ProjectionConfig, vit_kwargs: Optional[dict]):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype_of(cfg.mixed_precision)
        self.feature_model = FeatureModel(cfg.image_size,
                                          cfg.image_feature_model,
                                          vit_kwargs)
        self.in_channels = (3 + cfg.image_color_channels
                            + self.feature_model.feature_dim)
        betas = linear_betas(cfg.beta_start, cfg.beta_end)
        self.schedulers = {"ddpm": DDPMScheduler(betas),
                           "ddim": DDIMScheduler(betas)}
        self.num_train_timesteps = len(betas)

    @torch.no_grad()
    def conditioning_map(self, image: torch.Tensor) -> torch.Tensor:
        """image (B, H, W, 3) in [0, 1] -> (B, H, W, 3 + D) float32. The
        feature model is frozen: no graph is built through it."""
        cfg = self.cfg
        colors = (image - cfg.colors_mean) / cfg.colors_std
        return torch.cat([colors, self.feature_model(image)], dim=-1)

    def prepare_cond(self, cond_map: torch.Tensor) -> torch.Tensor:
        """Flatten to (B, H*W, C) and cast to the compute dtype once per
        trajectory (the map does not change between steps)."""
        m = cond_map.reshape(cond_map.shape[0], -1, cond_map.shape[-1])
        return m if self.compute_dtype is None else m.to(self.compute_dtype)

    def x_t_input(self, x_t: torch.Tensor, camera: PerspectiveCamera,
                  cond: torch.Tensor) -> torch.Tensor:
        proj = surface_projection(x_t[..., :3], camera, cond,
                                  radius=self.cfg.raster_point_radius,
                                  scale_factor=self.cfg.scale_factor)
        return torch.cat([x_t, proj.float()], dim=-1)

    def noised_batch(self, batch: Dict[str, Any], noise: TrainNoise):
        """What the eps-MSE losses share (`model.py:75-121`): x0 = points *
        scale_factor, t uniform in [0, T), x_t = add_noise(x0), and x_t
        with the conditioning map projected onto it
        -> (x_t, [x_t | projection], t, the noise drawn)."""
        x0 = batch["points"] * self.cfg.scale_factor
        t, eps = noise.draw(x0.shape, self.num_train_timesteps)
        x_t = self.schedulers["ddpm"].add_noise(x0, eps, t)
        cond = self.prepare_cond(self.conditioning_map(batch["image"]))
        return x_t, self.x_t_input(x_t, batch["camera"], cond), t, eps


class PC2Model(ProjectionConditioned):
    def __init__(self, cfg: ProjectionConfig = ProjectionConfig(),
                 sa_blocks=PVCNN_SA_BLOCKS, fp_blocks=PVCNN_FP_BLOCKS,
                 vit_kwargs: Optional[dict] = None, device=None,
                 dropout: float = 0.1, width_multiplier: int = 1,
                 voxel_resolution_multiplier: int = 1):
        device = resolve_device(device)
        super().__init__(cfg, vit_kwargs)
        self.point_cloud_model = _Holder(PVCNN2(
            out_channels=3, embed_dim=cfg.point_cloud_model_embed_dim,
            extra_feature_channels=self.in_channels - 3,
            sa_blocks=sa_blocks, fp_blocks=fp_blocks,
            classifier_init_scale=1e-6, dtype=self.compute_dtype,
            dropout=dropout, width_multiplier=width_multiplier,
            voxel_resolution_multiplier=voxel_resolution_multiplier))
        self.to(device).eval()

    @property
    def backbone(self) -> PVCNN2:
        return self.point_cloud_model.model

    def reset_parameters(self, seed: int = 0) -> None:
        self.backbone.reset_parameters(seed)
        if hasattr(self.feature_model, "model"):
            self.feature_model.model.reset_parameters(seed + 1)

    def denoise(self, x_t: torch.Tensor, t: torch.Tensor,
                camera: PerspectiveCamera, cond: torch.Tensor) -> torch.Tensor:
        """One eps prediction; t (B,) int. Differentiable in the backbone's
        parameters; the samplers call it under `inference_mode`."""
        return self.backbone(self.x_t_input(x_t, camera, cond), t)

    # -------------------------------------------------------------- training
    def loss(self, batch: Dict[str, Any], noise: TrainNoise) -> torch.Tensor:
        """eps-MSE training loss (`model.py:75-121`) of one batch {"image":
        (B, H, W, 3), "camera", "points": (B, N, 3)}; dropout follows the
        module's mode (`train.make_train_step` switches it on) and takes
        its masks from `noise`."""
        _, x_in, t, eps = self.noised_batch(batch, noise)
        with dropout_masks(noise):
            eps_hat = self.backbone(x_in, t)
        return torch.mean((eps_hat - eps) ** 2)

    # -------------------------------------------------------------- sampling
    @torch.inference_mode()
    def interaction_sample(self, x_t: torch.Tensor, camera: PerspectiveCamera,
                           cond: torch.Tensor, start_time: int,
                           end_time: int, num_inference_steps: int,
                           noise: Callable[[int, int], torch.Tensor],
                           scheduler: str = "ddpm") -> torch.Tensor:
        """Window over timesteps[S - start : S - end] from x_t with the
        "ddpm" or "ddim" scheduler; `noise(j, n_steps)` gives step j's
        noise (DDIM runs at eta = 0 and ignores it)."""
        s = int(num_inference_steps)
        sched = self.schedulers[scheduler]
        window = sched.set_timesteps(s)[s - start_time:s - end_time]
        b = x_t.shape[0]
        for j, t in enumerate(window):
            tb = torch.full((b,), int(t), dtype=torch.long,
                            device=x_t.device)
            eps = self.denoise(x_t, tb, camera, cond)
            x_t = sched.step(eps, int(t), x_t, noise(j, len(window)))
        return x_t
