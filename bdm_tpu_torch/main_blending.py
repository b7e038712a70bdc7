"""BDM-Blending entry point (job: sample_bdm_blending), on the card
(`bdm_tpu/main_blending.py`).

Rebuild of `experiments/main_blending.py`:

    python -m bdm_tpu_torch.main_blending run.job=sample_bdm_blending \
        dataset=shapenet_r2n2 dataset.max_points=4096 \
        aux_run.roll_step=16 aux_run.milestones=[1000,968,936,872,128,64,32,0] \
        aux_run.prior_ckpt=<pvd .pt> aux_run.recon_ckpt=<pc2 .pt>

`run.cpu=true` runs it on the CPU. Under `torchrun` rank 0 samples.
"""

from __future__ import annotations

import sys

from bdm_tpu_torch.cli import (build_pc2, build_pvd, make_noise,
                               resolve_milestones, run_device,
                               sample_output_dirs, save_batch_outputs,
                               set_seed)
from bdm_tpu_torch.config import ProjectConfig, parse_cli
from bdm_tpu_torch.data import batch_to_device, get_dataset
from bdm_tpu_torch.parallel import is_main
from bdm_tpu_torch.samplers import bdm_blending


def sample_bdm_blending(cfg: ProjectConfig) -> None:
    device = run_device(cfg)
    if not is_main():
        return
    recon_ckpt = cfg.aux_run.recon_ckpt or cfg.checkpoint.resume
    # run.sample_from_ema selects the recon checkpoint's EMA weights
    # (reference main_blending.py:148-157)
    pc2 = build_pc2(cfg, recon_ckpt, from_ema=cfg.run.sample_from_ema)
    pvd = build_pvd(cfg, cfg.aux_run.prior_ckpt)
    _, loader_val, _ = get_dataset(cfg)
    milestones = resolve_milestones(cfg)
    pred_dir, gt_dir = sample_output_dirs(cfg, "sample_bdm_blending")
    noise = make_noise(cfg, device)
    for bi, batch in enumerate(loader_val):
        if (cfg.run.num_sample_batches is not None
                and bi >= cfg.run.num_sample_batches):
            break
        pred = bdm_blending(
            pc2, pvd, batch_to_device(batch, device),
            num_points=cfg.dataset.max_points, milestones=milestones,
            roll_step=cfg.aux_run.roll_step, noise=noise,
            num_inference_steps=cfg.run.num_inference_steps,
            scheduler=cfg.run.diffusion_scheduler)
        save_batch_outputs(pred_dir, gt_dir, batch, pred)
        print(f"blended batch {bi}: {pred.shape[0]} clouds -> {pred_dir}")
    print(f"Samples in {pred_dir}; ground truth in {gt_dir}")


def main(argv=None) -> None:
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    run_device(cfg)   # no card and no run.cpu=true: raise before any work
    set_seed(cfg.run.seed)
    if cfg.run.job == "sample_bdm_blending":
        sample_bdm_blending(cfg)
    else:
        raise ValueError(f"Invalid job: {cfg.run.job}")


if __name__ == "__main__":
    main()
