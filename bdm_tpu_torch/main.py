"""PC2 train / sample / vis entry point, on the card (`bdm_tpu/main.py`).

Rebuild of `experiments/main.py` with the same job names and dotted-override
CLI:

    python -m bdm_tpu_torch.main run.job=train dataset=shapenet_r2n2 \
        dataset.root=... dataset.r2n2_dir=... dataset.category=chair \
        dataset.max_points=4096 dataset.subset_ratio=0.1 \
        dataloader.batch_size=16 run.max_steps=10000

    python -m bdm_tpu_torch.main run.job=sample \
        checkpoint.resume=<save_dir>/<name>/checkpoint-latest.pt ...

Training runs on one device (`run.cpu=true`: the CPU), or data parallel
over the ranks `torchrun` starts, a card each:

    torchrun --nproc_per_node=8 -m bdm_tpu_torch.main run.job=train ...

Each rank takes its rows of every global batch of `dataloader.batch_size`
(`parallel.batch_group`: the largest divisor of the batch that is at most
the world size; the other ranks idle); rank 0 writes.
"""

from __future__ import annotations

import glob
import itertools
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from bdm_tpu_torch.cli import (build_pc2, ema_weights, make_noise,
                               run_device, sample_output_dirs,
                               save_batch_outputs, set_seed, to_numpy)
from bdm_tpu_torch.config import ProjectConfig, parse_cli
from bdm_tpu_torch.config.structured import to_dict
from bdm_tpu_torch.data import batch_to_device, get_dataset
from bdm_tpu_torch.parallel import (ShardedNoise, batch_group, is_main,
                                    replicate, shard_batch)
from bdm_tpu_torch.samplers import NoiseProvider, TrainNoise
from bdm_tpu_torch.train import (MetricLogger, create_train_state,
                                 make_lr_schedule, make_optimizer,
                                 pc2_freeze_mask, restore_checkpoint,
                                 train_loop)
from bdm_tpu_torch.train.checkpoint import save_checkpoint
from bdm_tpu_torch.utils.vis import (WandbLogger, render_evolution,
                                     render_point_cloud)


def train(cfg: ProjectConfig) -> None:
    device = run_device(cfg)
    group, rank, n = batch_group(cfg.dataloader.batch_size)
    if rank is None:
        print(f"no shard of a batch of {cfg.dataloader.batch_size} for this "
              f"rank: the data-parallel group is the first {n} rank(s)")
        return
    pc2 = build_pc2(cfg, cfg.checkpoint.resume if not
                    cfg.checkpoint.resume_training else None)
    if group is not None:
        replicate(pc2, group)
    loader_train, loader_val, _ = get_dataset(cfg)
    # `lr = batch_size * base_lr` when scale_learning_rate_with_batch_size
    # (reference `training_utils.py:34-37`; the batch is the global one,
    # so no num_processes factor)
    lr = cfg.optimizer.lr
    if cfg.optimizer.scale_learning_rate_with_batch_size:
        lr = cfg.dataloader.batch_size * lr
        print(f"lr = {cfg.dataloader.batch_size} (batch_size) * "
              f"{cfg.optimizer.lr} (base lr) = {lr}")
    if cfg.checkpoint.resume_training and (
            cfg.checkpoint.resume_training_scheduler
            != cfg.checkpoint.resume_training_optimizer):
        # the JAX package's surface: its lr schedule lives in the
        # optimizer state, and here the schedule is saved with the
        # optimizer too (`Optimizer.state_dict`)
        raise ValueError(
            "resume_training_scheduler must equal "
            "resume_training_optimizer: the lr-schedule step is part of "
            "the optimizer state")
    schedule = make_lr_schedule(
        cfg.scheduler.name, lr=lr,
        num_warmup_steps=cfg.scheduler.num_warmup_steps,
        num_training_steps=int(cfg.scheduler.num_training_steps))
    pc2_freeze_mask(pc2, cfg.run.freeze_feature_model)
    opt = make_optimizer(
        pc2, cfg.optimizer.name, lr=lr,
        weight_decay=cfg.optimizer.weight_decay,
        betas=tuple(cfg.optimizer.kwargs.get("betas", (0.95, 0.999))),
        clip_grad_norm=cfg.optimizer.clip_grad_norm, schedule=schedule,
        gradient_accumulation_steps=cfg.optimizer
        .gradient_accumulation_steps)
    state = create_train_state(pc2, opt, use_ema=cfg.ema.use_ema,
                               ema_decay=cfg.ema.decay,
                               ema_update_every=cfg.ema.update_every)
    if cfg.checkpoint.resume and cfg.checkpoint.resume_training:
        state = restore_checkpoint(
            cfg.checkpoint.resume, state,
            restore_optimizer=cfg.checkpoint.resume_training_optimizer,
            restore_step=cfg.checkpoint.resume_training_state)

    ckpt_dir = f"{cfg.run.save_dir}/{cfg.run.name}"
    os.makedirs(ckpt_dir, exist_ok=True)
    rank0 = is_main()
    logger = MetricLogger(jsonl_path=f"{ckpt_dir}/train_log.jsonl"
                          if rank0 else None)
    wandb_logger = WandbLogger(cfg.logging.wandb and rank0,
                               cfg.logging.wandb_project, cfg.run.name,
                               config=to_dict(cfg))

    def wandb_cb(step, state, metrics):
        if step % cfg.run.log_step_freq == 0:
            wandb_logger.log({k: float(v) for k, v in metrics.items()},
                             step=step)

    callbacks = [wandb_cb]
    if cfg.run.val_freq and cfg.run.val_freq > 0:
        callbacks.append(make_val_callback(cfg, pc2, loader_val, device,
                                           logger, wandb_logger, group))
    if cfg.run.vis_freq and cfg.run.vis_freq > 0 and rank0:
        callbacks.append(make_vis_callback(cfg, pc2, loader_val, device,
                                           ckpt_dir,
                                           wandb_logger=wandb_logger))
    if cfg.run.vis_before_training and rank0:
        # render once before the loop (reference `main.py:132`)
        make_vis_callback(cfg, pc2, loader_val, device, ckpt_dir,
                          force=True)(0, state, {})

    batches = loader_train.infinite()
    if cfg.run.limit_train_batches is not None:
        # cap the epoch at N batches (reference `main.py:199-201`): cycle
        # the first N batches forever
        batches = itertools.cycle(list(itertools.islice(
            iter(loader_train), int(cfg.run.limit_train_batches))))

    state = train_loop(
        state, pc2.loss, (batch_to_device(b, device) for b in batches),
        max_steps=cfg.run.max_steps, noise=TrainNoise(cfg.run.seed, device),
        checkpoint_dir=ckpt_dir, checkpoint_freq=cfg.run.checkpoint_freq,
        print_freq=cfg.run.print_step_freq,
        log_step_freq=cfg.run.log_step_freq, logger=logger,
        callbacks=callbacks, group=group)
    wandb_logger.finish()
    save_checkpoint(ckpt_dir, state, config=to_dict(cfg))
    print(f"Training done at step {state.step}; checkpoints in {ckpt_dir}")


def make_val_callback(cfg: ProjectConfig, pc2, loader_val, device, logger,
                      wandb_logger, group=None):
    """Every `run.val_freq` steps compute the eps-MSE loss on held-out
    batches with the (EMA) weights and log it — the reference's in-loop
    validation (`main.py:286-303`, `run.val_freq` /
    `run.limit_val_batches`). Each batch draws from a fresh
    `TrainNoise(0)`, so the metric is comparable across evaluations.
    With a data-parallel `group` each rank takes its rows of every batch
    and draws (`main.py:150-161` shards them) and the loss is the mean
    over the ranks, the loss of the whole batch."""
    # limit_val_batches unset -> validate the FULL held-out loader, like
    # the reference's val loop (`main.py:286-303` iterates dataloader_val)
    limit = cfg.run.limit_val_batches
    val_batches = [batch_to_device(b, device) for b in itertools.islice(
        loader_val, limit)]
    rank, n = 0, 1
    if group is not None:
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        val_batches = [shard_batch(b, rank, n) for b in val_batches]
    print(f"val callback: {len(val_batches)} batch(es) per eval")

    def batch_loss(model, batch):
        loss = model.loss(batch, ShardedNoise(TrainNoise(0, device), rank,
                                              n))
        if group is not None:
            dist.all_reduce(loss, group=group)
            loss /= n
        return float(loss)

    def val_cb(step, state, metrics):
        if step % cfg.run.val_freq != 0 or not val_batches:
            return
        with ema_weights(state) as model, torch.no_grad():
            losses = [batch_loss(model, b) for b in val_batches]
        val_loss = float(np.mean(losses))
        logger.update(val_loss=val_loss)
        logger.log_jsonl(step, val_loss=val_loss)
        wandb_logger.log({"val_loss": val_loss}, step=step)
        print(f"val @ step {step}: loss {val_loss:.4f}")

    return val_cb


def make_vis_callback(cfg: ProjectConfig, pc2, loader_val, device, ckpt_dir,
                      force: bool = False, wandb_logger=None):
    """Every `run.vis_freq` steps sample ONE held-out batch with the
    current (EMA) weights and save a scatter render under the run dir —
    the reference's in-loop `visualize` (`main.py:277-285`, and
    `run.vis_before_training` for the pre-loop call at `main.py:132`)."""
    batch = None

    def vis_cb(step, state, metrics):
        nonlocal batch
        if not force and (cfg.run.vis_freq <= 0
                          or step % cfg.run.vis_freq != 0 or step == 0):
            return
        if batch is None:
            batch = batch_to_device(next(iter(loader_val)), device)
        with ema_weights(state) as model:
            pred = model.sample(
                batch, num_points=cfg.dataset.max_points,
                noise=NoiseProvider(0, device),
                scheduler=cfg.run.diffusion_scheduler,
                num_inference_steps=cfg.run.num_inference_steps)
        out = os.path.join(ckpt_dir, f"vis_step{int(step):08d}.png")
        pts = to_numpy(pred[0])
        render_point_cloud(pts, out)
        if wandb_logger is not None:
            # interactive 3D panels, like the reference's wandb.Object3D
            # artifacts (`main.py:387-448`)
            wandb_logger.log_point_clouds(
                {"vis/pred": pts, "vis/gt": to_numpy(batch["points"][0])},
                step=step)
        print(f"vis @ step {step}: {out}")

    return vis_cb


def sample(cfg: ProjectConfig) -> None:
    device = run_device(cfg)
    if not is_main():
        return
    pc2 = build_pc2(cfg, cfg.checkpoint.resume,
                    from_ema=cfg.run.sample_from_ema)
    _, loader_val, _ = get_dataset(cfg)
    pred_dir, gt_dir = sample_output_dirs(cfg, "sample")
    evo_every = 100 if cfg.run.sample_save_evolutions else -1
    noise = make_noise(cfg, device)
    for bi, batch in enumerate(loader_val):
        if (cfg.run.num_sample_batches is not None
                and bi >= cfg.run.num_sample_batches):
            break
        out = pc2.sample(batch_to_device(batch, device),
                         num_points=cfg.dataset.max_points, noise=noise,
                         scheduler=cfg.run.diffusion_scheduler,
                         num_inference_steps=cfg.run.num_inference_steps,
                         return_sample_every_n_steps=evo_every)
        if evo_every > 0:
            pred, evolutions = out
            names = batch.get("sequence_name")
            for i in range(min(2, pred.shape[0])):  # a couple per batch
                name = names[i] if names else f"sample_{bi}_{i}"
                render_evolution(
                    to_numpy(evolutions[i]),
                    os.path.join(pred_dir, f"{name}_evolution.png"))
        else:
            pred = out
        save_batch_outputs(pred_dir, gt_dir, batch, pred)
        print(f"sampled batch {bi}: {pred.shape[0]} clouds -> {pred_dir}")
    print(f"Samples in {pred_dir}; ground truth in {gt_dir}")


def vis(cfg: ProjectConfig) -> None:
    """Save a handful of predictions as .ply plus matplotlib scatter PNGs
    (replaces the reference's pytorch3d/W&B renders, `main.py:306-451`)."""
    from bdm_tpu_torch.utils import read_ply
    cfg.run.num_sample_batches = 1
    sample(cfg)
    pred_dir, _ = sample_output_dirs(cfg, "sample")
    for path in sorted(glob.glob(os.path.join(pred_dir, "*.ply")))[:4]:
        render_point_cloud(read_ply(path), path.replace(".ply", ".png"))
    print(f"Visualizations next to the .ply files in {pred_dir}")


def main(argv=None) -> None:
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    run_device(cfg)   # no card and no run.cpu=true: raise before any work
    set_seed(cfg.run.seed)
    if cfg.run.job == "train":
        train(cfg)
    elif cfg.run.job == "sample":
        sample(cfg)
    elif cfg.run.job == "vis":
        vis(cfg)
    else:
        raise ValueError(f"Invalid job: {cfg.run.job}")


if __name__ == "__main__":
    main()
