"""The rank functions of the CPU tests of `bdm_tpu_torch.parallel`: each
runs in a process that `bdm_tpu_torch.parallel.spawn_ranks` starts, on one
thread, reads its inputs from `<dir>/inputs.pt` and writes what it found to
`<dir>/rank<r>.pt`. This module imports torch and the port only (a spawned
rank imports it), never JAX."""

import os

import numpy as np
import torch
import torch.distributed as dist

from bdm_tpu_torch.conditioning import PerspectiveCamera
from bdm_tpu_torch.parallel import init_distributed, point_sharded as psh

TINY_SA = (((8, 2, 4), (16, 0.3, 8, (8, 16))),
           ((16, 2, 4), (8, 0.4, 8, (16, 32))),
           (None, (4, 0.8, 8, (32, 64))))
TINY_FP = (((32, 32), (16, 1, 4)), ((16, 16), (16, 1, 4)),
           ((16, 8), (8, 1, 4)))


def _start(d, device="cpu"):
    torch.set_num_threads(1)
    dev = init_distributed(device)
    return torch.load(os.path.join(d, "inputs.pt"), map_location=dev,
                      weights_only=False)


def _finish(d, out):
    torch.save(out, os.path.join(d, f"rank{dist.get_rank()}.pt"))


def params(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


# ------------------------------------------------------ data parallel

def tiny_pc2(cfg, state, dropout, device="cpu"):
    from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig
    pc2 = PC2Model(ProjectionConfig(**cfg), TINY_SA, TINY_FP, device=device,
                   dropout=dropout)
    pc2.load_state_dict(state)
    return pc2


def batch_of(inp):
    b = inp["batch"]
    return dict(b, camera=PerspectiveCamera(**b["camera"]))


def sgd_state(pc2, accumulation=1):
    from bdm_tpu_torch.train import create_train_state, make_optimizer
    return create_train_state(
        pc2, make_optimizer(pc2, "SGD", lr=1e-2,
                            gradient_accumulation_steps=accumulation),
        use_ema=True, ema_update_every=1)


def dp_rank(d):
    """The data-parallel step and loop on the world group (2 ranks)."""
    import bdm_tpu_torch.train.step as step_mod
    from bdm_tpu_torch.parallel import shard_batch
    from bdm_tpu_torch.samplers import TrainNoise
    from bdm_tpu_torch.train import (NaNLossError, create_train_state,
                                     make_optimizer, make_train_step,
                                     train_loop)
    inp = _start(d)
    rank, world = dist.get_rank(), dist.get_world_size()
    group = dist.group.WORLD
    batch = batch_of(inp)
    local = shard_batch(batch, rank, world)
    out = {}

    # three AdamW steps, dropout 0, the JAX key tree's draws
    pc2 = tiny_pc2(inp["cfg"], inp["state"], 0.0)
    state = create_train_state(pc2, make_optimizer(pc2))
    step = make_train_step(pc2.loss, group)
    noise = TrainNoise(device="cpu", replay=inp["draws"])
    out["jax_steps"] = [{k: float(v) for k, v in
                         step(state, local, noise).items()} for _ in range(3)]

    # three SGD steps, dropout 0.1 from the seed, EMA every step
    pc2 = tiny_pc2(inp["cfg"], inp["state"], 0.1)
    state = sgd_state(pc2)
    step = make_train_step(pc2.loss, group)
    noise = TrainNoise(7, "cpu")
    out["sgd_steps"] = []
    for _ in range(3):
        m = step(state, local, noise)
        out["sgd_steps"].append(({k: float(v) for k, v in m.items()},
                                 params(pc2)))
    out["sgd_ema"] = {k: v.clone() for k, v in state.ema.items()}

    # accumulation over two micro-steps: one all-reduce a window
    calls = []
    reduce = step_mod.all_reduce_mean

    def counted(tensors, g):
        calls.append(len(tensors))
        reduce(tensors, g)

    step_mod.all_reduce_mean = counted
    try:
        pc2 = tiny_pc2(inp["cfg"], inp["state"], 0.1)
        state = sgd_state(pc2, accumulation=2)
        step = make_train_step(pc2.loss, group)
        noise = TrainNoise(7, "cpu")
        out["accum_steps"] = [{k: float(v) for k, v in
                               step(state, local, noise).items()}
                              for _ in range(4)]
        out["accum_params"] = params(pc2)
    finally:
        step_mod.all_reduce_mean = reduce
    out["accum_reduce_sizes"] = calls

    # a NaN on rank 1 alone at micro-step 3 (a step that does not close
    # its accumulation window, so no loss is reduced there)
    pc2 = tiny_pc2(inp["cfg"], inp["state"], 0.1)
    state = sgd_state(pc2, accumulation=2)
    n_calls = [0]

    def loss_fn(b, noise):
        n_calls[0] += 1
        loss = pc2.loss(b, noise)
        return loss * float("nan") if (rank == 1 and n_calls[0] == 3) \
            else loss

    try:
        train_loop(state, loss_fn, iter(lambda: batch, None), 10,
                   TrainNoise(7, "cpu"), log_step_freq=5,
                   print_freq=10 ** 9, group=group)
        out["nan"] = (None, state.step)
    except NaNLossError as e:
        out["nan"] = (str(e), state.step)

    # two loop steps with checkpoints: rank 0 writes, in its own directory
    pc2 = tiny_pc2(inp["cfg"], inp["state"], 0.1)
    state = sgd_state(pc2)
    train_loop(state, pc2.loss, iter(lambda: batch, None), 2,
               TrainNoise(7, "cpu"), checkpoint_dir=os.path.join(
                   d, f"ckpt{rank}"), print_freq=10 ** 9, group=group)
    out["loop_params"] = params(pc2)
    _finish(d, out)


def cuda_dp_rank(d):
    """One data-parallel SGD step of the tiny PC2 on the card, dropout 0.1:
    its metrics and parameters, and the kernel launches of the step."""
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.parallel import shard_batch
    from bdm_tpu_torch.samplers import TrainNoise
    from bdm_tpu_torch.train import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = _start(d, "cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    pc2 = tiny_pc2(inp["cfg"], inp["state"], 0.1, dev)
    state = sgd_state(pc2)
    kernels.reset_counts()
    m = make_train_step(pc2.loss, dist.group.WORLD)(
        state, shard_batch(batch_of(inp), rank, world), TrainNoise(7, dev))
    _finish(d, {"metrics": {k: float(v) for k, v in m.items()},
                "params": {k: v.cpu() for k, v in params(pc2).items()},
                "counts": kernels.counts(),
                "backend": dist.get_backend()})


def cuda_gn_rank(d):
    """The point-sharded GroupNorm + SiLU through the kernel pair on the
    card: this rank's rows of the output, of x's gradient, its part of the
    weight's and bias's gradients, and the GroupNorm counts of the two
    calls (forward under autograd, then under no_grad)."""
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.ops.cuda import groupnorm
    inp = _start(d, "cuda")
    group = dist.group.WORLD
    x = psh.own_rows(inp["x"], group).contiguous().requires_grad_(True)
    w = inp["w"].clone().requires_grad_(True)
    b = inp["b"].clone().requires_grad_(True)
    kernels.reset_counts()
    y = groupnorm.group_norm(x, w, b, 8, 1e-5, silu=True, group=group)
    (y.float() * psh.own_rows(inp["cot"], group)).sum().backward()
    with torch.no_grad():
        again = groupnorm.group_norm(x, w, b, 8, 1e-5, silu=True,
                                     group=group)
    _finish(d, {"y": y.detach().cpu(), "dx": x.grad.cpu(),
                "dw": w.grad.cpu(), "db": b.grad.cpu(),
                "counts": kernels.counts()["groupnorm"],
                "again_equal": bool(torch.equal(again, y.detach()))})


# ---------------------------------------------------- point sharding

def _shards(x, group):
    return None if x is None else psh.own_rows(x, group)


def point_rank(d):
    """Every point-sharded function on 2 and 4 ranks (4 ranks: the world
    group; 2: each half of it), the tiny PVCNN2 and PC2 denoise sharded
    against their unsharded forms, the sharded GroupNorm, and data x
    point parallel on a 2 x 2 grid."""
    from bdm_tpu_torch.models import PVCNN2
    from bdm_tpu_torch.models.layers import GroupNormCL
    inp = _start(d)
    rank = dist.get_rank()
    halves = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups = {4: dist.group.WORLD, 2: halves[rank // 2]}
    out = {}
    for name, case in inp["cases"].items():
        g = groups[case["p"]]
        fn = getattr(psh, case["fn"])
        args = [_shards(a, g) if sharded else a
                for a, sharded in case["args"]]
        if case["fn"] == "point_to_voxel_to_point_sharded":
            args.insert(3, lambda grid: torch.tanh(grid) + grid * 0.5)
        res = fn(*args, g)
        out[name] = res
    out["sp_active"] = {k: psh.sp_active(groups[p] if p > 1 else None, n,
                                         m)
                        for k, (p, n, m) in inp["sp_active"].items()}

    # the tiny PVCNN2, sharded over 2 ranks, against the unsharded one
    g = groups[2]
    common = inp["pvcnn_common"]
    model = PVCNN2(**common)
    model.load_state_dict(inp["pvcnn_state"])
    model_sp = PVCNN2(**common, sp_group=g, sp_min_points=64)
    model_sp.load_state_dict(inp["pvcnn_state"])
    x, t = inp["pvcnn_x"], inp["pvcnn_t"]
    out["pvcnn_want"] = model(x, t).detach()
    out["pvcnn_got"] = model_sp(psh.own_rows(x, g), t).detach()
    # gradients: the loss is the mean over the whole; each rank
    # backpropagates its part, and the parameter gradients are summed
    xg, tgtg = inp["pvcnn_grad_x"], inp["pvcnn_grad_tgt"]
    loss = torch.mean((model(xg, t) - tgtg) ** 2)
    loss.backward()
    out["grad_want"] = {k: p.grad.clone()
                        for k, p in model.named_parameters()}
    part = torch.sum((model_sp(psh.own_rows(xg, g), t)
                      - psh.own_rows(tgtg, g)) ** 2) / tgtg.numel()
    part.backward()
    grads = {}
    for k, p in model_sp.named_parameters():
        dist.all_reduce(p.grad, group=g)
        grads[k] = p.grad.clone()
    out["grad_got"] = grads

    # the sharded GroupNorm statistics and their gradient (4 ranks)
    gn = GroupNormCL(4, 16)
    with torch.no_grad():
        gn.weight.copy_(inp["gn_weight"])
        gn.bias.copy_(inp["gn_bias"])
    xs = psh.own_rows(inp["gn_x"], groups[4]).clone().requires_grad_(True)
    y = gn(xs, group=groups[4])
    (y * psh.own_rows(inp["gn_dy"], groups[4])).sum().backward()
    dist.all_reduce(gn.weight.grad)
    out["gn"] = (y.detach(), xs.grad.clone(), gn.weight.grad.clone())

    # data x point parallel: batch row rank // 2, point half rank % 2
    model_dp = PVCNN2(**common, sp_group=g, sp_min_points=64)
    model_dp.load_state_dict(inp["pvcnn_state"])
    row = slice(rank // 2, rank // 2 + 1)
    out["dp_sp"] = model_dp(psh.own_rows(x[row], g), t[row]).detach()

    # PC2's denoise, the projection's z-buffer over the whole cloud
    from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig
    cfg = ProjectionConfig(**inp["pc2_cfg"])
    pc2 = PC2Model(cfg, TINY_SA, TINY_FP, device="cpu")
    pc2.load_state_dict(inp["pc2_state"])
    pc2_sp = PC2Model(cfg, TINY_SA, TINY_FP, device="cpu", sp_group=g,
                      sp_min_points=32)
    pc2_sp.load_state_dict(inp["pc2_state"])
    cam = PerspectiveCamera(**inp["pc2_camera"])
    xt, tt = inp["pc2_x"], inp["pc2_t"]
    with torch.no_grad():
        cond = pc2.prepare_cond(pc2.conditioning_map(inp["pc2_image"]))
        out["denoise_want"] = pc2.denoise(xt, tt, cam, cond)
        out["denoise_got"] = pc2_sp.denoise(psh.own_rows(xt, g), tt, cam,
                                            cond)
    _finish(d, out)


# ------------------------------------------------------------ metrics

def chamfer_rank(d):
    from bdm_tpu_torch.evaluation import chamfer_distance_sharded
    inp = _start(d)
    out = {r: chamfer_distance_sharded(psh.own_rows(inp["pred"],
                                                    dist.group.WORLD),
                                       inp["gt"], dist.group.WORLD,
                                       recenter=r)
           for r in (True, False)}
    _finish(d, out)


def run(fn, world, d, inputs):
    """Write `inputs`, run `fn` on `world` spawned ranks, -> each rank's
    results."""
    from bdm_tpu_torch.parallel import spawn_ranks
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    spawn_ranks(fn, world, (str(d),), timeout=300)
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def rng_cloud(seed, shape, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))
