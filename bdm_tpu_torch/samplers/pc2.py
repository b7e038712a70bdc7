"""PC2, the projection-conditioned point-cloud diffusion model
(`bdm_tpu/samplers/pc2.py`).

The image conditioning map (normalized colours, ViT features, the mask and
its distance transform, as the configuration asks) is computed once per
image and flattened and cast to the compute dtype once per trajectory;
each step projects it onto the current points, concatenates [x_t |
projected map | global features] and runs the backbone (PVCNN2, the simple
point model or PVCNN2++). With `precontract` the map is contracted with the
taps of PVCNN2's first stage-0 conv once per trajectory
(`precontract_cond`), so a step projects the contracted map and skips the
wide voxelization and conv. State-dict keys follow the reference
(`point_cloud_model.model.*`, `feature_model.model.*`).

Sampling: the full reverse loop (`sample`, DDPM, DDIM with eta, PNDM) and
the windows BDM runs (`interaction_sample`, DDPM and DDIM). Noise comes
from a provider (`samplers.noise`), so a test can replay the JAX keys.

The model lives on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Union)

import torch
import torch.nn as nn

from bdm_tpu_torch import resolve_device
from bdm_tpu_torch.conditioning import PerspectiveCamera, surface_projection
from bdm_tpu_torch.diffusion import make_scheduler
from bdm_tpu_torch.models.feature_model import FeatureModel
from bdm_tpu_torch.models.layers import dropout_masks
from bdm_tpu_torch.models.pvcnn import (PVCNN_FP_BLOCKS, PVCNN_SA_BLOCKS,
                                        PVCNN2, tap_weights)
from bdm_tpu_torch.models.simple import PVCNN2PlusPlus, SimplePointModel
from bdm_tpu_torch.samplers.noise import NoiseProvider, TrainNoise
from bdm_tpu_torch.utils.spans import span


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
    """`bdm_tpu.samplers.pc2.ProjectionConfig`, every field with its
    default. `raster_points_per_pixel` is accepted and unused, as in the
    JAX package; `raster_splat` is "multi" (the exact candidate set) or
    "nearest"; `precontract` applies to PVCNN2 sampling that predicts
    shape alone."""

    image_size: int = 224
    image_feature_model: str = "vit_small_patch16_224_msn"
    use_local_colors: bool = True
    use_local_features: bool = True
    use_global_features: bool = False
    use_mask: bool = False
    use_distance_transform: bool = False
    predict_shape: bool = True
    predict_color: bool = False
    process_color: bool = False
    image_color_channels: int = 3
    color_channels: int = 3
    colors_mean: float = 0.5
    colors_std: float = 0.5
    scale_factor: float = 1.0
    raster_point_radius: float = 0.0075
    raster_points_per_pixel: int = 1
    raster_splat: str = "multi"
    beta_start: float = 1e-5
    beta_end: float = 8e-3
    beta_schedule: str = "linear"
    point_cloud_model: str = "pvcnn"
    point_cloud_model_embed_dim: int = 64
    mixed_precision: str = "no"
    precontract: bool = False


class Conditioning(NamedTuple):
    """The local map projected onto the points and, with
    `use_global_features`, the global feature appended to every point:
    the ViT's CLS token (the reference's documented intent; its own call
    cannot run), or with the identity feature model the image's spatial
    mean."""

    local_map: torch.Tensor                   # (B, H, W, L) or (B, H*W, L)
    global_feats: Optional[torch.Tensor]      # (B, G) float32 or None


class PrecontractedCond(NamedTuple):
    """The conditioning of one trajectory, precontracted: `comb_map` is
    [local map | its contraction with the 27 taps of stage 0's first conv]
    per pixel, so one projection per step serves the network input and the
    conv; `gtap` / `gfeats` carry the global features' part."""

    comb_map: torch.Tensor                    # (B, H*W, L + 27 * Cout0)
    gtap: Optional[torch.Tensor]              # (B, 27 * Cout0) or None
    gfeats: Optional[torch.Tensor]            # (B, G) or None


Cond = Union[torch.Tensor, Conditioning, PrecontractedCond]


class _Holder(nn.Module):
    """Gives the wrapped network the reference's `<name>.model.` keys."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model


class ProjectionConditioned(nn.Module):
    """What PC2 and the BDM-Merging model share: the image feature model,
    the conditioning and its projection onto the points, the channel
    accounting and the three schedulers."""

    def __init__(self, cfg: ProjectionConfig, vit_kwargs: Optional[dict]):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype_of(cfg.mixed_precision)
        self.feature_model = FeatureModel(cfg.image_size,
                                          cfg.image_feature_model,
                                          vit_kwargs)
        # input channel accounting (`projection_model.py:66-78`)
        d = self.feature_model.feature_dim
        in_channels = 3
        if cfg.use_local_colors:
            in_channels += cfg.image_color_channels
        if cfg.use_local_features:
            in_channels += d
        if cfg.use_global_features:
            in_channels += d
        if cfg.use_mask:
            in_channels += 2 if cfg.use_distance_transform else 1
        if cfg.process_color:
            in_channels += cfg.color_channels
        self.in_channels = in_channels
        self.out_channels = (3 if cfg.predict_shape else 0) + (
            cfg.color_channels if cfg.predict_color else 0)
        # the projected (local) channels of the input:
        # [x_t (3) | local (L) | global (G)]
        self.local_cond_channels = in_channels - 3 - (
            d if cfg.use_global_features else 0)
        self.schedulers = {
            name: make_scheduler(name, cfg.beta_start, cfg.beta_end,
                                 cfg.beta_schedule)
            for name in ("ddpm", "ddim", "pndm")}
        self.num_train_timesteps = self.schedulers[
            "ddpm"].num_train_timesteps
        self.sp_group = None    # the points' process group (PC2Model)

    @torch.no_grad()
    def conditioning_map(self, image: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         distance_transform: Optional[torch.Tensor] = None
                         ) -> Union[torch.Tensor, Conditioning]:
        """image (B, H, W, 3) in [0, 1], mask and distance transform
        (B, H, W, 1) where the configuration uses them -> the (B, H, W, L)
        float32 local map, or a `Conditioning` with global features. The
        feature model is frozen: no graph is built through it."""
        cfg = self.cfg
        identity = cfg.image_feature_model == "identity"
        parts, gfeats = [], None
        if cfg.use_local_colors:
            parts.append((image - cfg.colors_mean) / cfg.colors_std)
        if cfg.use_local_features and cfg.use_global_features and not identity:
            # one ViT forward serves both
            gfeats, feats = self.feature_model(image, return_type="all")
            parts.append(feats)
        elif cfg.use_local_features:
            parts.append(self.feature_model(image))
        if cfg.use_mask:
            if mask is None:
                raise ValueError("use_mask: the batch has no 'mask'")
            parts.append(mask.float())
        if cfg.use_distance_transform:
            if distance_transform is None:
                raise ValueError("use_distance_transform: the batch has no "
                                 "'distance_transform' (computed on the "
                                 "host, `compute_distance_transform`)")
            parts.append(distance_transform)
        if cfg.use_global_features and gfeats is None:
            gfeats = (image.mean(dim=(1, 2)) if identity else
                      self.feature_model(image, return_type="cls_token"))
        local = torch.cat(parts, dim=-1)
        if cfg.use_global_features:
            return Conditioning(local, gfeats)
        return local

    def batch_conditioning(self, batch: Dict[str, Any]):
        """`conditioning_map` of a batch {"image", and "mask" /
        "distance_transform" where the configuration uses them}."""
        return self.conditioning_map(batch["image"], batch.get("mask"),
                                     batch.get("distance_transform"))

    def prepare_cond(self, cond: Cond) -> Cond:
        """Flatten the map to (B, H*W, C) and cast it to the compute dtype
        once per trajectory (it does not change between steps); global
        features stay float32."""
        dt = self.compute_dtype

        def prep(m):
            m = m.reshape(m.shape[0], -1, m.shape[-1])
            return m if dt is None else m.to(dt)

        if isinstance(cond, PrecontractedCond):
            return cond._replace(comb_map=prep(cond.comb_map))
        if isinstance(cond, Conditioning):
            return Conditioning(prep(cond.local_map), cond.global_feats)
        return prep(cond)

    def _project(self, x_t: torch.Tensor, camera: PerspectiveCamera,
                 cond_map: torch.Tensor) -> torch.Tensor:
        return surface_projection(x_t[..., :3], camera, cond_map,
                                  radius=self.cfg.raster_point_radius,
                                  scale_factor=self.cfg.scale_factor,
                                  splat=self.cfg.raster_splat,
                                  group=self.sp_group)

    def x_t_input(self, x_t: torch.Tensor, camera: PerspectiveCamera,
                  cond: Union[torch.Tensor, Conditioning]) -> torch.Tensor:
        """[x_t | projected local map | global features per point]
        (`projection_model.py:179-231`), float32."""
        if isinstance(cond, PrecontractedCond):
            raise TypeError("x_t_input needs the raw conditioning map; a "
                            "PrecontractedCond serves PC2Model.denoise only")
        gfeats = None
        if isinstance(cond, Conditioning):
            cond, gfeats = cond
        parts = [x_t, self._project(x_t, camera, cond).float()]
        if gfeats is not None:
            parts.append(gfeats[:, None, :].float().expand(
                -1, x_t.shape[1], -1))
        return torch.cat(parts, dim=-1)

    def noised_batch(self, batch: Dict[str, Any], noise: TrainNoise):
        """What the eps-MSE losses share (`model.py:75-121`): x0 = points *
        scale_factor, t uniform in [0, T), x_t = add_noise(x0), and x_t
        with the conditioning projected onto it
        -> (x_t, [x_t | projection], t, the noise drawn)."""
        x0 = batch["points"] * self.cfg.scale_factor
        t, eps = noise.draw(x0.shape, self.num_train_timesteps)
        x_t = self.schedulers["ddpm"].add_noise(x0, eps, t)
        cond = self.prepare_cond(self.batch_conditioning(batch))
        return x_t, self.x_t_input(x_t, batch["camera"], cond), t, eps


class PC2Model(ProjectionConditioned):
    """`sa_blocks`, `fp_blocks`, `width_multiplier` and
    `voxel_resolution_multiplier` shape the PVCNN2 backbone (the blocks
    also PVCNN2++'s inner one). `sp_group` and `sp_min_points` shard the
    PVCNN2 backbone's point axis over a process group (`PVCNN2`): the
    points of `denoise` are then this rank's shard, and the projection
    takes its z-buffer over the whole cloud. The loss and the sampling
    loops refuse a sharded model: their draws would be the shard's shape,
    not this rank's part of the whole cloud's."""

    def __init__(self, cfg: ProjectionConfig = ProjectionConfig(),
                 sa_blocks=PVCNN_SA_BLOCKS, fp_blocks=PVCNN_FP_BLOCKS,
                 vit_kwargs: Optional[dict] = None, device=None,
                 dropout: float = 0.1, width_multiplier: int = 1,
                 voxel_resolution_multiplier: int = 1, sp_group=None,
                 sp_min_points: int = 2048):
        device = resolve_device(device)
        super().__init__(cfg, vit_kwargs)
        # backbone mux (`point_cloud_model.py:14-59`)
        common = dict(out_channels=self.out_channels,
                      embed_dim=cfg.point_cloud_model_embed_dim,
                      extra_feature_channels=self.in_channels - 3,
                      dtype=self.compute_dtype)
        if cfg.point_cloud_model == "pvcnn":
            net = PVCNN2(sa_blocks=sa_blocks, fp_blocks=fp_blocks,
                         classifier_init_scale=1e-6, dropout=dropout,
                         width_multiplier=width_multiplier,
                         voxel_resolution_multiplier=(
                             voxel_resolution_multiplier),
                         sp_group=sp_group, sp_min_points=sp_min_points,
                         **common)
        elif cfg.point_cloud_model == "simple":
            net = SimplePointModel(**common)
        elif cfg.point_cloud_model == "pvcnnplusplus":
            net = PVCNN2PlusPlus(dropout=dropout, sa_blocks=sa_blocks,
                                 fp_blocks=fp_blocks, **common)
        else:
            raise NotImplementedError(cfg.point_cloud_model)
        if sp_group is not None and cfg.point_cloud_model != "pvcnn":
            raise ValueError("sp_group shards the PVCNN2 backbone only, not "
                             f"{cfg.point_cloud_model!r}")
        self.sp_group = sp_group
        self.point_cloud_model = _Holder(net)
        self.precontract_enabled = (
            cfg.precontract and cfg.point_cloud_model == "pvcnn"
            and cfg.predict_shape and not cfg.predict_color
            and not cfg.process_color and bool(net.specs.sa_stages)
            and bool(net.specs.sa_stages[0].convs))
        self.to(device).eval()

    @property
    def backbone(self) -> nn.Module:
        return self.point_cloud_model.model

    def _refuse_sharded(self, what: str) -> None:
        if self.sp_group is not None:
            raise NotImplementedError(
                f"PC2Model.{what} with sp_group: the point-sharded model "
                "serves denoise")

    def reset_parameters(self, seed: int = 0) -> None:
        self.backbone.reset_parameters(seed)
        if hasattr(self.feature_model, "model"):
            self.feature_model.model.reset_parameters(seed + 1)

    # ------------------------------------------------------ precontraction
    def maybe_precontract(self, cond: Cond) -> Cond:
        """The sampling form of a conditioning: precontracted where
        `precontract` applies, else prepared (`prepare_cond`)."""
        if not self.precontract_enabled or isinstance(cond,
                                                      PrecontractedCond):
            return self.prepare_cond(cond)
        return self.precontract_cond(cond)

    @torch.no_grad()
    def precontract_cond(self, cond: Union[torch.Tensor, Conditioning]
                         ) -> PrecontractedCond:
        """Contract the map with rows 3:3+L of each of the 27 taps of the
        first stage-0 conv, once a trajectory, in float32 (a matmul at full
        precision), stored in the compute dtype. Exact up to float
        reassociation: the projection is a gather, the scatter-mean is
        linear per point, the conv is linear per tap."""
        local, gfeats = (cond if isinstance(cond, Conditioning)
                         else (cond, None))
        b, length = local.shape[0], local.shape[-1]
        local = local.reshape(b, -1, length)
        weight = self.backbone.sa_layers[0][0].voxel_layers[0].weight
        store = self.compute_dtype or torch.float32
        d_tap = local.float() @ tap_weights(weight, 3, 3 + length).float()
        comb = torch.cat([local.to(store), d_tap.to(store)], dim=-1)
        gtap = None
        if gfeats is not None:
            w_g = tap_weights(weight, 3 + length, weight.shape[1]).float()
            gtap = (gfeats.float() @ w_g).to(store)
            gfeats = gfeats.to(store)
        return PrecontractedCond(comb, gtap, gfeats)

    def _precontracted_input(self, x_t: torch.Tensor,
                             camera: PerspectiveCamera,
                             pre: PrecontractedCond):
        """-> (x_in (B, N, 3 + L [+ G]) float32, pre_tap (B, N, 27 * Cout0)):
        one projection of the combined map serves both."""
        proj = self._project(x_t, camera, pre.comb_map)
        length = self.local_cond_channels
        local, tap = proj[..., :length], proj[..., length:]
        if pre.gtap is not None:
            tap = tap + pre.gtap[:, None, :]
        parts = [x_t, local.float()]
        if pre.gfeats is not None:
            parts.append(pre.gfeats[:, None, :].float().expand(
                -1, x_t.shape[1], -1))
        return torch.cat(parts, dim=-1), tap

    def denoise(self, x_t: torch.Tensor, t: torch.Tensor,
                camera: PerspectiveCamera, cond: Cond) -> torch.Tensor:
        """One eps prediction; t (B,) int; `cond` a prepared map, a
        `Conditioning` or a `PrecontractedCond`. Differentiable in the
        backbone's parameters; the samplers call it under
        `inference_mode`."""
        if isinstance(cond, PrecontractedCond):
            with span("pc2.condition"):
                x_in, tap = self._precontracted_input(x_t, camera, cond)
            return self.backbone(x_in, t, pre_tap=tap)
        with span("pc2.condition"):
            x_in = self.x_t_input(x_t, camera, cond)
        return self.backbone(x_in, t)

    # -------------------------------------------------------------- training
    def loss(self, batch: Dict[str, Any], noise: TrainNoise) -> torch.Tensor:
        """eps-MSE training loss (`model.py:75-121`) of one batch {"image":
        (B, H, W, 3), "camera", "points": (B, N, 3), and "mask" /
        "distance_transform" where used}; dropout follows the module's mode
        (`train.make_train_step` switches it on) and takes its masks from
        `noise`."""
        self._refuse_sharded("loss")
        _, x_in, t, eps = self.noised_batch(batch, noise)
        with dropout_masks(noise):
            eps_hat = self.backbone(x_in, t)
        return torch.mean((eps_hat - eps) ** 2)

    # -------------------------------------------------------------- sampling
    def _window(self, x: torch.Tensor, camera: PerspectiveCamera,
                cond: Cond, timesteps: Sequence[int], scheduler: str,
                eta: float, noise: Callable[[int, int], torch.Tensor]
                ) -> torch.Tensor:
        """DDPM or DDIM steps over `timesteps`; `noise(j, n_steps)` gives
        step j's noise (DDIM at eta 0 draws it and does not use it)."""
        sched = self.schedulers[scheduler]
        b, n = x.shape[0], len(timesteps)
        for j, t in enumerate(timesteps):
            tb = torch.full((b,), int(t), dtype=torch.long, device=x.device)
            eps = self.denoise(x, tb, camera, cond)
            with span("pc2.update"):
                if scheduler == "ddim":
                    x = sched.step(eps, int(t), x, noise(j, n), eta)
                else:
                    x = sched.step(eps, int(t), x, noise(j, n))
        return x

    @torch.inference_mode()
    def sample(self, batch: Dict[str, Any], num_points: int,
               noise: Optional[NoiseProvider] = None,
               scheduler: str = "ddpm", num_inference_steps: int = 1000,
               eta: float = 0.0, return_sample_every_n_steps: int = -1):
        """The full reverse loop from N(0, I) (`model.py:123-214`) with
        "ddpm", "ddim" (with `eta`) or "pndm" -> (B, N, 3) points
        (unscaled); with `return_sample_every_n_steps` > 0 also the cloud
        after every such segment, (B, S, N, 3). The initial cloud is
        `noise.initial`, step j of segment i draws `noise.step("seg", i, j,
        len(segment), shape)`."""
        self._refuse_sharded("sample")
        if scheduler == "pndm" and return_sample_every_n_steps > 0:
            raise NotImplementedError(
                "evolutions are not supported with the pndm scheduler")
        image, camera = batch["image"], batch["camera"]
        if noise is None:
            noise = NoiseProvider(device=image.device)
        sched = self.schedulers[scheduler]
        ts = [int(t) for t in sched.set_timesteps(num_inference_steps)]
        shape = (image.shape[0], num_points, 3)
        x = noise.initial(shape)
        cond = self.maybe_precontract(self.batch_conditioning(batch))
        scale = self.cfg.scale_factor
        if scheduler == "pndm":
            # multistep state across the whole loop: no windows
            state = sched.init_state()
            for t in ts:
                tb = torch.full((shape[0],), t, dtype=torch.long,
                                device=x.device)
                x, state = sched.step(self.denoise(x, tb, camera, cond), t,
                                      x, state)
            return x / scale
        every = (return_sample_every_n_steps
                 if return_sample_every_n_steps > 0 else len(ts))
        snaps = []
        for i, lo in enumerate(range(0, len(ts), every)):
            x = self._window(x, camera, cond, ts[lo:lo + every], scheduler,
                             eta, lambda j, n, i=i: noise.step(
                                 "seg", i, j, n, shape))
            snaps.append(x)
        if return_sample_every_n_steps <= 0:
            return x / scale
        return x / scale, torch.stack(snaps, dim=1) / scale

    @torch.inference_mode()
    def interaction_sample(self, x_t: torch.Tensor, batch: Dict[str, Any],
                           start_time: int, end_time: int,
                           num_inference_steps: int,
                           noise: Callable[[int, int], torch.Tensor],
                           scheduler: str = "ddpm", eta: float = 0.0,
                           cond: Optional[Cond] = None) -> torch.Tensor:
        """Window over timesteps[S - start : S - end] from x_t
        (`model.py:216-291`) with "ddpm" or "ddim"; `noise(j, n_steps)`
        gives step j's noise. `cond` is built from the batch when not
        given."""
        self._refuse_sharded("interaction_sample")
        if scheduler == "pndm":
            raise ValueError(
                "pndm carries multistep state across the whole trajectory "
                "and cannot be windowed; the reference never composes it "
                "with BDM either. Use scheduler='ddpm' or 'ddim'.")
        s = int(num_inference_steps)
        window = self.schedulers[scheduler].set_timesteps(s)[
            s - start_time:s - end_time]
        if cond is None:
            cond = self.batch_conditioning(batch)
        return self._window(x_t, batch["camera"],
                            self.maybe_precontract(cond), window, scheduler,
                            eta, noise)
