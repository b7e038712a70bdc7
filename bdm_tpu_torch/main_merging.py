"""BDM-Merging entry point (jobs: training_bdm_merging, sample_bdm_merging),
on the card (`bdm_tpu/main_merging.py`).

Rebuild of `experiments/main_merging.py`:

    python -m bdm_tpu_torch.main_merging run.job=training_bdm_merging \
        scheduler=fusion run.max_fusion_steps=20000 \
        aux_run.prior_ckpt=<pvd .pt> aux_run.recon_ckpt=<pc2 .pt> ...

    python -m bdm_tpu_torch.main_merging run.job=sample_bdm_merging \
        aux_run.prior_ckpt=<pvd .pt> aux_run.recon_ckpt=<pc2 .pt> \
        aux_run.fusion_ckpt=<save_dir>/<name>/checkpoint-latest.pt ...

Training runs on one device (`run.cpu=true`: the CPU), or data parallel
over the ranks `torchrun` starts (as in `bdm_tpu_torch.main`); sampling
runs on rank 0.
"""

from __future__ import annotations

import os
import sys

from bdm_tpu_torch.cli import (build_fusion, build_pc2, build_pvd,
                               make_noise, resolve_milestones, run_device,
                               sample_output_dirs, save_batch_outputs,
                               set_seed)
from bdm_tpu_torch.config import ProjectConfig, parse_cli
from bdm_tpu_torch.config.structured import to_dict
from bdm_tpu_torch.data import batch_to_device, get_dataset
from bdm_tpu_torch.parallel import batch_group, is_main, replicate
from bdm_tpu_torch.samplers import TrainNoise, bdm_merging
from bdm_tpu_torch.train import (MetricLogger, create_train_state,
                                 fusion_freeze_mask, make_lr_schedule,
                                 make_optimizer, train_loop)
from bdm_tpu_torch.train.checkpoint import save_checkpoint


def _build_all(cfg: ProjectConfig, with_fusion_ckpt: bool):
    pc2 = build_pc2(cfg, cfg.aux_run.recon_ckpt)
    pvd = build_pvd(cfg, cfg.aux_run.prior_ckpt)
    merge = build_fusion(
        cfg, pc2, pvd,
        cfg.aux_run.fusion_ckpt if with_fusion_ckpt else None)
    return pc2, pvd, merge


def training_bdm_merging(cfg: ProjectConfig) -> None:
    """Finetune the fusion decoder (`main_merging.py:242-366`): towers
    frozen, scheduler=fusion (cosine, 200 warmup, max_fusion_steps)."""
    device = run_device(cfg)
    group, rank, n = batch_group(cfg.dataloader.batch_size)
    if rank is None:
        print(f"no shard of a batch of {cfg.dataloader.batch_size} for this "
              f"rank: the data-parallel group is the first {n} rank(s)")
        return
    _, _, merge = _build_all(cfg, with_fusion_ckpt=False)
    if group is not None:
        replicate(merge, group)
    loader_train, _, _ = get_dataset(cfg)

    schedule = make_lr_schedule(
        cfg.scheduler.name, lr=cfg.optimizer.lr,
        num_warmup_steps=cfg.scheduler.num_warmup_steps,
        num_training_steps=int(cfg.scheduler.num_training_steps))
    fusion_freeze_mask(merge)
    opt = make_optimizer(
        merge, cfg.optimizer.name, lr=cfg.optimizer.lr,
        weight_decay=cfg.optimizer.weight_decay,
        betas=tuple(cfg.optimizer.kwargs.get("betas", (0.95, 0.999))),
        clip_grad_norm=cfg.optimizer.clip_grad_norm, schedule=schedule,
        gradient_accumulation_steps=cfg.optimizer
        .gradient_accumulation_steps)
    state = create_train_state(merge, opt, use_ema=cfg.ema.use_ema,
                               ema_decay=cfg.ema.decay,
                               ema_update_every=cfg.ema.update_every)

    ckpt_dir = f"{cfg.run.save_dir}/{cfg.run.name}"
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = MetricLogger(jsonl_path=f"{ckpt_dir}/train_log.jsonl"
                          if is_main() else None)
    state = train_loop(
        state, merge.loss,
        (batch_to_device(b, device) for b in loader_train.infinite()),
        max_steps=cfg.run.max_fusion_steps,
        noise=TrainNoise(cfg.run.seed, device), checkpoint_dir=ckpt_dir,
        checkpoint_freq=cfg.run.checkpoint_freq,
        print_freq=cfg.run.print_step_freq,
        log_step_freq=cfg.run.log_step_freq, logger=logger, group=group)
    save_checkpoint(ckpt_dir, state, config=to_dict(cfg))
    print(f"Fusion training done at step {state.step}; checkpoints in "
          f"{ckpt_dir}")


def sample_bdm_merging(cfg: ProjectConfig) -> None:
    device = run_device(cfg)
    if not is_main():
        return
    pc2, pvd, merge = _build_all(cfg, with_fusion_ckpt=True)
    _, loader_val, _ = get_dataset(cfg)
    milestones = resolve_milestones(cfg)
    pred_dir, gt_dir = sample_output_dirs(cfg, "sample_bdm_merging")
    noise = make_noise(cfg, device)
    for bi, batch in enumerate(loader_val):
        if (cfg.run.num_sample_batches is not None
                and bi >= cfg.run.num_sample_batches):
            break
        pred = bdm_merging(
            merge, pc2, pvd, batch_to_device(batch, device),
            num_points=cfg.dataset.max_points, milestones=milestones,
            roll_step=cfg.aux_run.roll_step, noise=noise,
            num_inference_steps=cfg.run.num_inference_steps,
            scheduler=cfg.run.diffusion_scheduler)
        save_batch_outputs(pred_dir, gt_dir, batch, pred)
        print(f"merged batch {bi}: {pred.shape[0]} clouds -> {pred_dir}")
    print(f"Samples in {pred_dir}; ground truth in {gt_dir}")


def main(argv=None) -> None:
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    run_device(cfg)   # no card and no run.cpu=true: raise before any work
    set_seed(cfg.run.seed)
    if cfg.run.job == "training_bdm_merging":
        training_bdm_merging(cfg)
    elif cfg.run.job == "sample_bdm_merging":
        sample_bdm_merging(cfg)
    else:
        raise ValueError(f"Invalid job: {cfg.run.job}")


if __name__ == "__main__":
    main()
