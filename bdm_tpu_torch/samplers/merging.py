"""BDM-Merging, the learned fusion sampler (`bdm_tpu/samplers/merging.py`,
reference `model/model.py:320-600` and `main_merging.py:369-523`).

Between milestones the recon (PC2) branch denoises alone, as in
BDM-Blending. At each interior milestone both branches roll from the same
x_t to `milestone - roll_step + 1`, one after the other, and one forward
of the fusion network plus one scheduler step at t = `milestone -
roll_step` merges them (`nstep_fuse`).

Supported here: sampling (`bdm_merging`, `BDMMergingModel.sample`) with
the DDPM and DDIM schedulers, every `ProjectionConfig` option of the
conditioning (the PC2 windows precontract where PC2's configuration asks;
the fusion network reads the raw map), and the training loss of the fusion
network (`BDMMergingModel.loss`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from bdm_tpu_torch import resolve_device
from bdm_tpu_torch.conditioning import PerspectiveCamera
from bdm_tpu_torch.models.fusion import PVCNNFuse
from bdm_tpu_torch.models.layers import dropout_masks
from bdm_tpu_torch.models.pvcnn import PVCNN_FP_BLOCKS, PVCNN_SA_BLOCKS
from bdm_tpu_torch.samplers.blending import coupled_sampler
from bdm_tpu_torch.samplers.noise import NoiseProvider, TrainNoise
from bdm_tpu_torch.samplers.pc2 import (PC2Model, ProjectionConditioned,
                                        ProjectionConfig, _Holder)
from bdm_tpu_torch.samplers.pvd import PVDModel


class BDMMergingModel(ProjectionConditioned):
    """The fusion network with PC2's conditioning. State-dict keys follow
    the reference (`fusion_model.model.*`, `feature_model.model.*`). The
    model lives on the card unless the caller passes `device="cpu"`."""

    def __init__(self, cfg: ProjectionConfig = ProjectionConfig(),
                 sa_blocks=PVCNN_SA_BLOCKS, fp_blocks=PVCNN_FP_BLOCKS,
                 vit_kwargs: Optional[dict] = None, device=None,
                 dropout: float = 0.1, width_multiplier: int = 1,
                 voxel_resolution_multiplier: int = 1):
        device = resolve_device(device)
        super().__init__(cfg, vit_kwargs)
        self.fusion_model = _Holder(PVCNNFuse(
            out_channels=3, embed_dim=cfg.point_cloud_model_embed_dim,
            extra_feature_channels=self.in_channels - 3,
            sa_blocks=sa_blocks, fp_blocks=fp_blocks,
            dtype=self.compute_dtype, dropout=dropout,
            width_multiplier=width_multiplier,
            voxel_resolution_multiplier=voxel_resolution_multiplier))
        self.to(device).eval()

    @property
    def fusion(self) -> PVCNNFuse:
        return self.fusion_model.model

    def reset_parameters(self, seed: int = 0) -> None:
        self.fusion.reset_parameters(seed)
        if hasattr(self.feature_model, "model"):
            self.feature_model.model.reset_parameters(seed + 1)

    @torch.no_grad()
    def init_from_pretrained(self, pc2: PC2Model, pvd: PVDModel,
                             seed: int = 0) -> None:
        """The reference's start of fusion training
        (`pvcnn_fuse.py:30-36,99-105`): the towers are the pretrained
        encoders, the decoder, `embedf` and the feature model copies of
        PC2's, and the projections freshly initialised from `seed` with
        their zero-convs at zero, so the network equals PC2."""
        f, b = self.fusion, pc2.backbone
        pairs = [(f.pc2_model_sa_layers, b.sa_layers),
                 (f.pvd_model_sa_layers, pvd.model.sa_layers),
                 (f.fusion_decoder_fp_layers, b.fp_layers),
                 (f.classifier, b.classifier), (f.embedf, b.embedf),
                 (self.feature_model, pc2.feature_model)]
        if f.pc2_encoder.global_att is not None:
            pairs += [(f.pc2_model_global_att, b.global_att),
                      (f.pvd_model_global_att, pvd.model.global_att)]
        for dst, src in pairs:
            dst.load_state_dict(src.state_dict())
        g = torch.Generator().manual_seed(seed)
        for proj in f.projs:
            proj.reset_parameters(g)

    # -------------------------------------------------------------- training
    def loss(self, batch: Dict[str, Any], noise: TrainNoise) -> torch.Tensor:
        """eps-MSE through the fusion network in "fusion_1step" mode
        (`model.py:372-419`): both towers read the noised cloud. Which
        parameters train is the optimizer's business
        (`train.fusion_freeze_mask`); dropout masks from `noise`."""
        x_t, x_in, t, eps = self.noised_batch(batch, noise)
        with dropout_masks(noise):
            eps_hat = self.fusion(x_in, x_t, t, "fusion_1step")
        return torch.mean((eps_hat - eps) ** 2)

    # -------------------------------------------------------------- sampling
    def predict(self, recon: torch.Tensor, prior: torch.Tensor, t: int,
                camera: PerspectiveCamera, cond: torch.Tensor,
                mode: str) -> torch.Tensor:
        """One eps prediction of the fusion network at timestep t
        (differentiable; the samplers call it under `inference_mode`)."""
        tb = torch.full((recon.shape[0],), int(t), dtype=torch.long,
                        device=recon.device)
        return self.fusion(self.x_t_input(recon, camera, cond), prior, tb,
                           mode)

    @torch.inference_mode()
    def nstep_fuse(self, pred_from_prior: torch.Tensor,
                   pred_from_recon: torch.Tensor, camera: PerspectiveCamera,
                   cond: torch.Tensor, timestep: int, noise: torch.Tensor,
                   scheduler: str = "ddpm",
                   num_inference_steps: int = 1000) -> torch.Tensor:
        """Fuse the two branch outputs at `timestep` (`model.py:510-570`):
        both clouds re-centred, one "fusion_nstep" forward, one scheduler
        step from the recon cloud with the given noise."""
        sched = self.schedulers[scheduler]
        sched.set_timesteps(num_inference_steps)
        prior = pred_from_prior - pred_from_prior.mean(dim=1, keepdim=True)
        recon = pred_from_recon - pred_from_recon.mean(dim=1, keepdim=True)
        eps = self.predict(recon, prior, timestep, camera, cond,
                           "fusion_nstep")
        return sched.step(eps, int(timestep), recon, noise)

    @torch.inference_mode()
    def sample(self, batch: Dict[str, Any], num_points: int,
               noise: Optional[NoiseProvider] = None,
               scheduler: str = "ddpm",
               num_inference_steps: int = 1000) -> torch.Tensor:
        """The full reverse loop through the fusion network alone, in
        "fusion_1step" mode (`model.py:421-508`); the loop draws its noise
        as window "seg" of milestone 0."""
        image, camera = batch["image"], batch["camera"]
        if noise is None:
            noise = NoiseProvider(device=image.device)
        sched = self.schedulers[scheduler]
        timesteps = sched.set_timesteps(num_inference_steps)
        x = noise.initial((image.shape[0], num_points, 3))
        cond = self.prepare_cond(self.batch_conditioning(batch))
        for j, t in enumerate(timesteps):
            eps = self.predict(x, x, t, camera, cond, "fusion_1step")
            x = sched.step(eps, int(t), x,
                           noise.step("seg", 0, j, len(timesteps), x.shape))
        return x / self.cfg.scale_factor


def bdm_merging(merge: BDMMergingModel, pc2: PC2Model, pvd: PVDModel,
                batch: Dict[str, Any], num_points: int,
                milestones: Sequence[int], roll_step: int,
                noise: Optional[NoiseProvider] = None,
                num_inference_steps: int = 1000,
                scheduler: str = "ddpm") -> torch.Tensor:
    """Run the merging sampler for one batch {"image": (B, H, W, 3),
    "camera": PerspectiveCamera}; returns (B, N, 3) points in the model's
    normalized space. The conditioning map comes from `pc2` and serves
    the fusion step as well."""
    def fuse(i, out_recon, out_prior, camera, cond, noise):
        t = int(milestones[i + 1]) - roll_step
        return merge.nstep_fuse(out_prior, out_recon, camera, cond, t,
                                noise.fuse(i, out_recon.shape), scheduler,
                                num_inference_steps)

    # the branch rolls stop one step short: the fusion step takes it
    return coupled_sampler(pc2, pvd, batch, num_points, milestones,
                           roll_step, noise, num_inference_steps, scheduler,
                           1, fuse)
