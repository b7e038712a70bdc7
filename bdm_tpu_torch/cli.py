"""Shared CLI orchestration (`bdm_tpu/cli.py`): the run's device, model
building, checkpoint wiring, the sampling jobs' noise and the sampling
output layout. Used by main.py / main_blending.py / main_merging.py.

Under `torchrun` (`WORLD_SIZE` in the environment) each rank joins the
process group (`parallel.init_distributed`): the train jobs split each
batch over the ranks `parallel.batch_group` names, and only rank 0 writes
checkpoints, logs and `.ply` files; a sampling job runs on rank 0.

Checkpoints are the port's `.pt` files: a train checkpoint of
`train/checkpoint.py` ({"model", "optimizer", "step", "best_val"[,
"ema"]}) or a bare `state_dict` under the reference keys.
"""

from __future__ import annotations

import contextlib
import os
import random
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from bdm_tpu_torch.config import ProjectConfig
from bdm_tpu_torch.parallel import init_distributed
from bdm_tpu_torch.samplers import (BDMMergingModel, NoiseProvider, PC2Model,
                                    ProjectionConfig, PVDModel)
from bdm_tpu_torch.utils import write_ply

TRAIN_CHECKPOINT_KEYS = {"model", "optimizer", "step", "best_val", "ema"}


def projection_config(cfg: ProjectConfig) -> ProjectionConfig:
    m = cfg.model
    return ProjectionConfig(
        image_size=int(m.image_size),
        image_feature_model=m.image_feature_model,
        use_local_colors=m.use_local_colors,
        use_local_features=m.use_local_features,
        use_global_features=m.use_global_features,
        use_mask=m.use_mask,
        use_distance_transform=m.use_distance_transform,
        predict_shape=m.predict_shape,
        predict_color=m.predict_color,
        colors_mean=m.colors_mean,
        colors_std=m.colors_std,
        color_channels=m.color_channels,
        scale_factor=float(m.scale_factor),
        raster_point_radius=m.raster_point_radius,
        raster_splat=m.raster_splat,
        beta_start=m.beta_start,
        beta_end=m.beta_end,
        beta_schedule=m.beta_schedule,
        point_cloud_model=m.point_cloud_model,
        point_cloud_model_embed_dim=m.point_cloud_model_embed_dim,
        mixed_precision=cfg.run.mixed_precision,
    )


def run_device(cfg: ProjectConfig) -> torch.device:
    """`run.cpu=True` is the CPU (the reference's
    `Accelerator(cpu=cfg.run.cpu)`, `main.py:41`); otherwise the card, and
    without one this raises before any work is done. Under a process
    group the rank joins it and its card is `cuda:LOCAL_RANK`."""
    try:
        return init_distributed("cpu" if cfg.run.cpu else None)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (on the command line: run.cpu=true)") \
            from None


def build_pc2(cfg: ProjectConfig, ckpt: Optional[str] = None,
              from_ema: bool = False) -> PC2Model:
    """The PC2 model on the run's device: random weights from `run.seed`,
    then a checkpoint's where given. `from_ema` takes the checkpoint's EMA
    weights (`run.sample_from_ema`, reference `main.py:150`)."""
    if from_ema and not ckpt:
        raise ValueError("run.sample_from_ema needs checkpoint.resume")
    pc2 = PC2Model(projection_config(cfg), device=run_device(cfg))
    pc2.reset_parameters(cfg.run.seed)
    if ckpt:
        load_weights(pc2, ckpt, from_ema=from_ema)
    return pc2


def build_pvd(cfg: ProjectConfig, ckpt: Optional[str] = None) -> PVDModel:
    pvd = PVDModel(mixed_precision=cfg.run.mixed_precision,
                   device=run_device(cfg))
    pvd.reset_parameters(cfg.run.seed + 1)
    if ckpt:
        load_weights(pvd, ckpt)
    return pvd


def build_fusion(cfg: ProjectConfig, pc2: PC2Model, pvd: PVDModel,
                 ckpt: Optional[str] = None) -> BDMMergingModel:
    """The fusion network initialised from the two towers
    (`init_from_pretrained`, projections from `run.seed + 2`), then a
    checkpoint's weights where given."""
    merge = BDMMergingModel(projection_config(cfg), device=run_device(cfg))
    merge.init_from_pretrained(pc2, pvd, seed=cfg.run.seed + 2)
    if ckpt:
        load_weights(merge, ckpt)
    return merge


def extract_state(payload, from_ema: bool = False) -> dict:
    """The weights of a loaded `.pt` file: a train checkpoint's "model",
    or with `from_ema` its "ema" (an error when it has none: a silent
    fallback would sample the raw weights while claiming EMA); a bare
    state_dict as it is, and an error with `from_ema`."""
    if isinstance(payload, dict) and "model" in payload and \
            set(payload) <= TRAIN_CHECKPOINT_KEYS:
        if from_ema:
            if "ema" not in payload:
                raise ValueError(
                    "run.sample_from_ema=True but the checkpoint holds no "
                    "ema (trained with ema.use_ema=False?)")
            return payload["ema"]
        return payload["model"]
    if from_ema:
        raise ValueError(
            "run.sample_from_ema=True needs a train checkpoint with ema; "
            "got a bare state_dict")
    return payload


def load_weights(model: nn.Module, path: str, from_ema: bool = False
                 ) -> nn.Module:
    """Overlay a checkpoint's weights on `model`: keys the file lacks keep
    their initialised values (the reference's `strict=False` resume,
    `training_utils.py:273-346`), a key the model does not have raises."""
    device = next(model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state = extract_state(payload, from_ema=from_ema)
    unexpected = sorted(set(state) - set(model.state_dict()))
    if unexpected:
        raise KeyError(f"{path}: keys the model does not have: "
                       f"{unexpected[:5]}{' ...' if len(unexpected) > 5 else ''}")
    model.load_state_dict(state, strict=False)
    return model


@contextlib.contextmanager
def ema_weights(state):
    """The model of a `TrainState` with its EMA weights in place of the
    trained ones for the block (no-op without EMA)."""
    if state.ema is None:
        yield state.model
        return
    params = dict(state.model.named_parameters())
    kept = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, v in state.ema.items():
            params[k].copy_(v)
    try:
        yield state.model
    finally:
        with torch.no_grad():
            for k, v in kept.items():
                params[k].copy_(v)


def make_noise(cfg: ProjectConfig, device) -> NoiseProvider:
    """The noise of a sampling job, one provider for all its batches,
    seeded from `run.manual_seed` or `run.seed` on the run's device (the
    JAX package's `PRNGKey(run.manual_seed or run.seed)`)."""
    return NoiseProvider(seed=cfg.run.manual_seed or cfg.run.seed,
                         device=device)


def resolve_milestones(cfg: ProjectConfig):
    ms = cfg.aux_run.milestones
    if ms is None:
        # the canonical BDM schedule (`example_sample_blending.sh`)
        ms = [1000, 968, 936, 872, 128, 64, 32, 0]
    return [int(m) for m in ms]


def sample_output_dirs(cfg: ProjectConfig, kind: str) -> tuple:
    base = os.path.join(cfg.run.save_dir, cfg.run.name, kind)
    pred = os.path.join(base, "pred", cfg.dataset.category)
    gt = os.path.join(base, "gt", cfg.dataset.category)
    os.makedirs(pred, exist_ok=True)
    os.makedirs(gt, exist_ok=True)
    return pred, gt


def to_numpy(x) -> np.ndarray:
    """A tensor on any device (or an array) -> float32 NumPy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def save_batch_outputs(pred_dir: str, gt_dir: str, batch, pred) -> None:
    """Write pred/gt .ply pairs named by sequence_name (the reference's
    layout, matched by the evaluation CLIs)."""
    names = batch.get("sequence_name")
    pred = to_numpy(pred)
    gt = to_numpy(batch["points"])
    for i in range(pred.shape[0]):
        name = names[i] if names else f"sample_{i:05d}"
        write_ply(os.path.join(pred_dir, f"{name}.ply"), pred[i])
        write_ply(os.path.join(gt_dir, f"{name}.ply"), gt[i])


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
