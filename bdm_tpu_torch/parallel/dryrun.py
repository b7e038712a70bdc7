"""`__graft_entry__.dryrun_multichip`'s counterpart: `n` spawned ranks over
a `torch.distributed` process group, at its tiny specs.

    python -m bdm_tpu_torch.parallel.dryrun [N] [--device cpu]

Each rank (1) takes one data-parallel PC2 training step on its rows of a
batch of N, (2) samples BDM-Blending on those rows, and (3) runs one PC2
denoise with the point axis sharded over the ranks, held against the
unsharded denoise of the same weights. On the card every rank uses it,
over gloo when the ranks share it (`parallel.backend_rule`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _rank(device) -> None:
    import torch.distributed as dist

    from bdm_tpu_torch.parallel import (ShardedNoise, init_distributed,
                                        shard_batch)
    from bdm_tpu_torch.parallel.point_sharded import own_rows
    from bdm_tpu_torch.samplers import (NoiseProvider, PC2Model, PVDModel,
                                        ProjectionConfig, TrainNoise,
                                        bdm_blending)
    from bdm_tpu_torch.tools.standins import (TINY_FP, TINY_SA,
                                              synthetic_batch)
    from bdm_tpu_torch.train import (create_train_state, make_optimizer,
                                     make_train_step, pc2_freeze_mask)

    torch.set_num_threads(1)
    dev = init_distributed(device)
    rank, n = dist.get_rank(), dist.get_world_size()
    group = dist.group.WORLD
    say = print if rank == 0 else (lambda *a: None)
    cfg = ProjectionConfig(image_size=16, image_feature_model="identity",
                           raster_point_radius=0.3,
                           point_cloud_model_embed_dim=8)
    blocks = dict(sa_blocks=TINY_SA, fp_blocks=TINY_FP)

    def to_dev(batch):
        return {k: v.to(dev) for k, v in batch.items()}

    # (1) one data-parallel training step, one sample a rank
    pc2 = PC2Model(cfg, device=dev, **blocks)
    pc2.reset_parameters(0)
    pc2_freeze_mask(pc2)
    state = create_train_state(pc2, make_optimizer(pc2, lr=1e-3),
                               use_ema=True)
    batch = to_dev(synthetic_batch(n, 32, 16, np.random.default_rng(1)))
    local = shard_batch(batch, rank, n)
    m = make_train_step(pc2.loss, group)(state, local, TrainNoise(2, dev))
    loss = float(m["loss"])
    if not np.isfinite(loss) or state.step != 1:
        raise RuntimeError(f"dryrun_multichip({n}): loss {loss}, step "
                           f"{state.step}")
    say(f"dryrun_multichip({n}): ok, loss={loss:.4f}, step={state.step}")

    # (2) BDM-Blending on this rank's rows, its draws those of one process
    pvd = PVDModel(embed_dim=8, device=dev, **blocks)
    pvd.reset_parameters(3)
    out = bdm_blending(pc2, pvd, local, num_points=32,
                       milestones=[8, 6, 2, 0], roll_step=2,
                       noise=ShardedNoise(NoiseProvider(4, dev), rank, n),
                       num_inference_steps=8, scheduler="ddpm")
    if out.shape != (1, 32, 3) or not torch.isfinite(out).all():
        raise RuntimeError(f"dryrun_multichip({n}): blending gave "
                           f"{tuple(out.shape)}")
    say(f"dryrun_multichip({n}): sharded bdm_blending ok, out mean="
        f"{float(out.mean()):.4f}")

    # (3) the denoise with the point axis sharded over the ranks
    pc2_sp = PC2Model(cfg, device=dev, sp_group=group, sp_min_points=32,
                      **blocks)
    pc2_sp.load_state_dict(pc2.state_dict())
    rng = np.random.default_rng(5)
    sb = to_dev(synthetic_batch(2, 32, 16, rng))
    x = torch.from_numpy(rng.standard_normal((2, 32, 3)).astype(
        np.float32)).to(dev)
    t = torch.full((2,), 5, dtype=torch.long, device=dev)
    with torch.inference_mode():
        cond = pc2.prepare_cond(pc2.batch_conditioning(sb))
        eps_sp = pc2_sp.denoise(own_rows(x, group), t, sb["camera"], cond)
        eps = pc2.denoise(x, t, sb["camera"], cond)
    err = torch.tensor(float((eps_sp - own_rows(eps, group)).abs().max()))
    dist.all_reduce(err, dist.ReduceOp.MAX)
    if not torch.isfinite(eps_sp).all() or not float(err) < 1e-4:
        raise RuntimeError(f"dryrun_multichip({n}): the point-sharded "
                           f"denoise is off the unsharded one by {err}")
    say(f"dryrun_multichip({n}): sequence-parallel denoise ok, "
        f"max|SP - unsharded|={float(err):.2e}")


def dryrun_multichip(n: int, device=None, timeout: float = 600.0) -> None:
    """Run the three checks on `n` spawned ranks (the card unless `device`
    names another); raises if a rank fails."""
    from bdm_tpu_torch.parallel import spawn_ranks
    spawn_ranks(_rank, n, (device,), timeout)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
