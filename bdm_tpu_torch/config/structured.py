"""Structured config mirroring the reference CLI surface
(`bdm_tpu/config/structured.py`, copied: the two must give equal dicts).

Key names, groups and defaults follow `experiments/config/structured.py`
so `example_*.sh`-style invocations port mechanically:

    python -m bdm_tpu_torch.main run.job=train dataset=shapenet_r2n2 \
        dataset.category=chair dataset.max_points=4096 \
        dataloader.batch_size=16 aux_run.milestones=[1000,968,...]

Hydra itself is not a dependency: `parse_cli` implements the dotted-override
syntax (group selection like `dataset=pix3d` / `scheduler=fusion`, JSON-ish
value coercion, `${a.b}` interpolation).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class RunConfig:
    """Mirrors `RunConfig` (`structured.py:14-55`)."""
    name: str = "debug"
    job: str = "train"
    mixed_precision: str = "bf16"  # the JAX package's default ('fp16' in
    # the reference); bf16 takes the tensor-core kernels
    cpu: bool = False  # the port: run on the CPU instead of the card
    seed: int = 42
    manual_seed: Optional[int] = None
    val_before_training: bool = False  # schema parity (dead in reference)
    vis_before_training: bool = False
    limit_train_batches: Optional[int] = None
    limit_val_batches: Optional[int] = None
    max_steps: int = 100_000
    checkpoint_freq: int = 1_000
    val_freq: int = 5_000
    vis_freq: int = 5_000
    log_step_freq: int = 20
    print_step_freq: int = 100
    num_inference_steps: int = 1000
    diffusion_scheduler: str = "ddpm"
    num_samples: int = 1
    num_sample_batches: Optional[int] = None
    sample_from_ema: bool = False
    sample_save_evolutions: bool = False
    freeze_feature_model: bool = True
    max_fusion_steps: int = 20_000
    save_dir: str = "./outputs"


@dataclass
class AuxRunConfig:
    """Mirrors `AutomaticalPriorConfig` (`structured.py:58-64`)."""
    roll_step: int = 16
    milestones: Optional[List[int]] = None
    prior_ckpt: Optional[str] = None
    recon_ckpt: Optional[str] = None
    fusion_ckpt: Optional[str] = None


@dataclass
class LoggingConfig:
    wandb: bool = False
    wandb_project: str = "bdm_tpu"  # the JAX package's, kept for parity


@dataclass
class ModelConfig:
    """Mirrors `PointCloudDiffusionModelConfig` (`structured.py:74-111`)."""
    image_size: str | int = "${dataset.image_size}"
    image_feature_model: str = "vit_small_patch16_224_msn"
    use_local_colors: bool = True
    use_local_features: bool = True
    use_global_features: bool = False
    use_mask: bool = False
    use_distance_transform: bool = False
    scale_factor: str | float = "${dataset.scale_factor}"
    colors_mean: float = 0.5
    colors_std: float = 0.5
    color_channels: int = 3
    predict_shape: bool = True
    predict_color: bool = False
    beta_start: float = 1e-5
    beta_end: float = 8e-3
    beta_schedule: str = "linear"
    point_cloud_model: str = "pvcnn"
    point_cloud_model_embed_dim: int = 64
    # rasterization (`projection_model.py:39-41`); raster_splat is a
    # bdm_tpu extension: "multi" (exact PyTorch3D candidates) | "nearest"
    raster_point_radius: float = 0.0075
    raster_splat: str = "multi"


@dataclass
class DatasetConfig:
    """Union of `ShapeNetR2N2Config` / `Pix3DConfig`
    (`structured.py:128-164`)."""
    type: str = "shapenet_r2n2"
    # eval_split / restrict_model_ids / mask_images: schema parity only —
    # the reference never consumes them outside its config either
    eval_split: str = "val"
    max_points: int = 16_384
    image_size: int = 224
    scale_factor: float = 1.0
    subset_ratio: float = 1.0
    restrict_model_ids: Optional[List[str]] = None
    root: str = ""
    category: str = "chair"
    mask_images: str | bool = "${model.use_mask}"
    # shapenet_r2n2
    r2n2_dir: str = ""
    pc_dict: str = "pc_dict_v2.json"
    split_file: str = "R2N2_split.json"
    views_rel_path: str = "ShapeNetRendering"
    which_view_from24: str = "00"
    start_ratio: float = 0.0
    # pix3d
    processed: bool = True


@dataclass
class DataloaderConfig:
    batch_size: int = 8
    num_workers: int = 6


@dataclass
class LossConfig:
    # schema parity only: the reference declares these weights but never
    # reads them either (`grep -r '\.diffusion_weight' experiments/` is
    # empty) — its losses are plain eps-MSE / rgb-MSE
    diffusion_weight: float = 1.0
    rgb_weight: float = 1.0
    consistency_weight: float = 1.0


@dataclass
class CheckpointConfig:
    resume: Optional[str] = None
    resume_training: bool = True
    resume_training_optimizer: bool = True
    resume_training_scheduler: bool = True
    resume_training_state: bool = True


@dataclass
class EMAConfig:
    use_ema: bool = False
    decay: float = 0.999
    update_every: int = 20


@dataclass
class OptimizerConfig:
    """AdamW defaults (`structured.py:222-227`). `type` is schema parity
    with the JAX package; the port reads `name`."""
    type: str = "optax"
    name: str = "AdamW"
    lr: float = 1e-3
    weight_decay: float = 1e-6
    scale_learning_rate_with_batch_size: bool = False
    gradient_accumulation_steps: int = 1
    clip_grad_norm: Optional[float] = 50.0
    kwargs: Dict[str, Any] = field(
        default_factory=lambda: {"betas": (0.95, 0.999)})


@dataclass
class SchedulerConfig:
    """Cosine default (`structured.py:246-253`)."""
    type: str = "optax"
    name: str = "cosine"
    num_warmup_steps: int = 2000
    num_training_steps: str | int = "${run.max_steps}"


@dataclass
class ProjectConfig:
    run: RunConfig = field(default_factory=RunConfig)
    aux_run: AuxRunConfig = field(default_factory=AuxRunConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    dataloader: DataloaderConfig = field(default_factory=DataloaderConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    ema: EMAConfig = field(default_factory=EMAConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)


# Group presets, mirroring the reference's ConfigStore groups
# (`structured.py:298-325`).
_GROUP_PRESETS = {
    "dataset": {
        "shapenet_r2n2": dict(type="shapenet_r2n2"),
        "pix3d": dict(type="pix3d", pc_dict="pix3d.json"),
        "synthetic": dict(type="synthetic"),
    },
    "scheduler": {
        "cosine": dict(name="cosine", num_warmup_steps=2000,
                       num_training_steps="${run.max_steps}"),
        "linear": dict(name="linear", num_warmup_steps=0,
                       num_training_steps="${run.max_steps}"),
        "fusion": dict(name="cosine", num_warmup_steps=200,
                       num_training_steps="${run.max_fusion_steps}"),
        "constant": dict(name="constant"),
    },
    "optimizer": {
        "adam": dict(name="AdamW", weight_decay=1e-6),
        "adadelta": dict(name="Adadelta",
                         kwargs={"weight_decay": 1e-6}),
    },
    "model": {
        "diffrec": dict(),
    },
}


def _coerce(value: str) -> Any:
    v = value.strip()
    if v.lower() in ("null", "none"):
        return None
    if v.lower() == "true":
        return True
    if v.lower() == "false":
        return False
    try:
        return json.loads(v)
    except (json.JSONDecodeError, ValueError):
        return v


def _get_path(cfg: ProjectConfig, dotted: str) -> Any:
    obj: Any = cfg
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _set_path(cfg: ProjectConfig, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    obj: Any = cfg
    for part in parts[:-1]:
        obj = getattr(obj, part)
    if not hasattr(obj, parts[-1]):
        raise KeyError(f"Unknown config key: {dotted}")
    setattr(obj, parts[-1], value)


def _resolve_interpolations(cfg: ProjectConfig) -> None:
    """Resolve `${a.b}` string values anywhere in the tree."""

    def resolve_obj(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                resolve_obj(v)
            elif isinstance(v, str) and v.startswith("${") and v.endswith("}"):
                setattr(obj, f.name, _get_path(cfg, v[2:-1]))

    resolve_obj(cfg)


def parse_cli(argv: List[str]) -> ProjectConfig:
    """Hydra-style dotted overrides: `a.b=c`, group picks `dataset=pix3d`,
    interpolations resolved last."""
    cfg = ProjectConfig()
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"Expected key=value, got: {arg}")
        key, _, raw = arg.partition("=")
        if key in _GROUP_PRESETS:  # group selection
            presets = _GROUP_PRESETS[key]
            if raw not in presets:
                raise ValueError(
                    f"Unknown {key} group '{raw}' "
                    f"(choices: {sorted(presets)})")
            for k, v in presets[raw].items():
                _set_path(cfg, f"{key}.{k}", v)
        else:
            _set_path(cfg, key, _coerce(raw))
    _resolve_interpolations(cfg)
    return cfg


def load_config(path: str) -> ProjectConfig:
    """Load overrides from a JSON file ({'run': {...}, ...})."""
    with open(path) as f:
        data = json.load(f)
    cfg = ProjectConfig()
    for group, values in data.items():
        for k, v in values.items():
            _set_path(cfg, f"{group}.{k}", v)
    _resolve_interpolations(cfg)
    return cfg


def to_dict(cfg: ProjectConfig) -> dict:
    return dataclasses.asdict(cfg)
