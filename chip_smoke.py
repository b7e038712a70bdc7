#!/usr/bin/env python3
"""Smoke run of bdm_tpu_torch on one NVIDIA GPU: build the Hopper kernels,
check each against its plain PyTorch version, forward and backward, then
run the port's paths at full model width: BDM-Blending and BDM-Merging
sampling, PC2 and PVD sampling, PC2's conditioning options and backbones,
the precontracted stage-0 conv, training of PC2, PVD and the fusion
network, the three command-line entry points with the evaluation CLI, the
colouring model and the parallel paths on two ranks.

    python3 chip_smoke.py

Phases, in the order they run (any failure exits non-zero):
  a. every kernel against its plain version at the paths' shapes (those
     of PC2, PVD, the fusion network and PVD at twice the width), float32
     and bfloat16; indices exact, floats under a stated tolerance; median
     times of kernel, plain version and, where one PyTorch call computes
     the same function, that call (CUDA events, after warm-up); the least
     time the card could take for the same work (`bound_ms`); for the two
     kernels with a tensor-core and a CUDA-core form (attention, conv3d)
     also ragged and narrow shapes, the dispatch rule of the source against
     the wrapper's `kernel_path`, and, printed beside the new bfloat16
     time, the recorded time of the CUDA-core kernel that served bfloat16
     before (a constant, so it stays out of the `kernels` line); FPS also on
     tie-heavy clouds (the integer lattice, exact duplicates) at every level
     and at N that is no multiple of its block; ball query on
     those clouds at every level, on the lattice at r = 1.0 (a face
     neighbour at d2 = r2 exactly is out) and at N < U, timed at the five
     shapes of the paths; three-NN on those clouds at every level (the
     lattice also against its cell centres), with fewer centres than three
     and than a query's lanes, the source's lanes and step rule against the
     wrapper's, timed at the five shapes of the paths beside the issue
     floor of a distance without FMAs; scatter-sum equal to the CPU's
     `index_add_` bit for bit (float32 and bf16 rows, ids -1 and S
     dropped, every row on one id) at the two shapes of the blend's
     backward, beside `index_add_`'s time at both; scatter-mean with its
     vector and lanes rule against the source's and float32 bit for bit
     against the CPU; beside the times of fps, ball query, three-NN,
     scatter-sum and scatter-mean, those of the kernels they replaced
     (`BEFORE_MS`); the float32 attention at C 64 and 128
     against the float32 fused attention, and the float32 conv
     (no TF32 in the library call) at 64 -> 64 and 390 -> 32 and 32 -> 32
     R 32, 128 -> 128 R 9 and 512 -> 512 R 8, beside the recorded times of
     the float32 kernels they replaced (`REPLACED_F32_MS`); FPS past what a
     thread holds in registers (`FPS_LARGE`, N up to 40,000), exact; the
     stage-0 conv at the widths of the options (`STAGE0_CINS`: 391, 392,
     774 and 67 -> 32, R 32) timed beside `F.conv3d`, and the precontract
     tap scatter (bf16 in, float32 out, C 864) bit for bit against the CPU
     and timed beside `index_add_`; the bf16 blend bit for bit against its
     plain version at the two FP stages and at the edge shapes of
     `INTERP_SHAPES` (B 1, N no multiple of a block's rows, C 8, 40, 264,
     one channel a group at C 12 and 200, M 128), timed back to back and
     one launch beside `F.embedding_bag`, and the host's cost of
     enqueueing one call (1,000 calls, no synchronise); GroupNorm at
     every (S, C) of `GN_SHAPES`, float32 and bf16, with and without its
     SiLU, against the float32 plain form (float32 within 1e-5 of the
     largest value, bf16 within one bf16 rounding of each element), and at
     the paths' largest site (S 32,768, C 64, bf16 + SiLU) at B 8 and B 64
     timed against its bound and its two-pass floor, beside the plain form
     and `F.group_norm` on a channels-first copy; the gated devoxelization
     bit for bit against its plain version at the 14 PVConvs of a PVCNN2
     forward (`DEVOX_SHAPES`) and every other shape of the paths
     (`DEVOX_MORE`), float32 and bf16, at B 8 and B 64, and at the edge
     shapes of `DEVOX_EDGES` (N no multiple of a block, R odd), then those
     of a forward at B 64, bf16, each timed against its
     bound (out, pf, coordinates, gate and the grid rows its corners
     touch), the plain version and `F.grid_sample` (3-D, align_corners, on
     a channels-first copy: the sample alone), summed over a forward;
  a'. gradients: each differentiable wrapper forward through its kernel
     and backward on the card, against forward and backward of its plain
     version under PyTorch's own autograd on the card (GroupNorm + SiLU
     and the gated devoxelization too);
  d. tiny BDM-Blending, BDM-Merging, BDM-Blending with `precontract`,
     PC2 `sample` with PNDM and PC2 `sample` with the mask, its distance
     transform and global features, through the kernels against the same
     runs on the CPU through the plain versions, same weights (the fusion
     zero-convs non-zero) and noise; BDM-Blending with and without
     `precontract` on the card agree (float32);
  f. tiny PC2 training, three steps on the card through the kernels
     against the same three steps on the CPU through the plain versions
     (same weights, timesteps and noise, dropout 0);
  b. one PC2 denoise step and one fusion forward at B=8, N=4096, bf16,
     production widths, with the kernel launches of each; then PC2's
     PVCNN2 forward at B 8 and B 64 run eagerly and replayed from its
     CUDA graph (`models.graphs`), in turns, bit for bit equal;
  c. BDM-Blending end to end at production widths (PC2 with ViT-S/16 +
     PVD), B=2, N=4096, bf16, 50 DDPM steps with three interior
     milestones;
  e. BDM-Merging end to end at production widths (PC2 + PVD + the fusion
     network initialised from them, zero-convs non-zero), B=2, N=4096,
     bf16, 50 DDPM steps, five interior milestones with roll step 2, so
     each runs a one-step roll of both branches and a fusion step;
  i. `PC2Model.sample` at production widths, B=2, N=4096, bf16: DDPM 50
     steps, DDIM 50 steps at eta 0.5 keeping the cloud every 10, PNDM 50
     inference steps; `PVDModel.sample` over a 50-step chain, fixedsmall
     and fixedlarge;
  j. one PC2 denoise and DDPM step at B=8, N=4096, bf16 for each option
     of `OPTIONS`: mask + distance transform, global features, nearest
     splat, custom betas, PVCNN2++ and the simple backbone (no kernel);
  k. `precontract` against the plain stage-0 conv: BDM-Blending as in c
     with it (the clouds within a stated Chamfer bound), then one denoise
     step at B=8 both ways in turns: its error against a float32 twin, the
     stage-0 conv each way, the step's device time, `precontract_cond`'s
     time and the peak memory;
  g. PC2 training at production widths, B=8, N=4096, four steps of
     `train_loop` (AdamW, clip 50, EMA) on a repeated seeded batch, in
     float32 and then at bf16 compute; before the float32 steps, the loss
     with dropout on (p = 0.1) from `TrainNoise` seeds 1, 1 and 2: the
     first two agree, the third differs;
  h. PVD training at `width_multiplier=2`, B=4, N=2048, float32, two
     steps (its 512 -> 512 conv at R=8), then one training step of the
     fusion network at production widths, B=2, bf16, both towers frozen;
  l. the CLIs as a user runs them, in a temporary directory, synthetic
     data, production widths, B=2, N=4096, bf16 (the config's default),
     random weights from `run.seed` (no checkpoint file but those the runs
     write): `bdm_tpu_torch.main_blending` (BDM-B, 50 DDPM steps, phase c's
     milestones); `main_merging` fusion training for 2 steps, then BDM-M
     sampling from its `checkpoint-latest.pt` (phase e's milestones);
     `main` PC2 training for 2 steps (EMA, one validation loss), then DDPM
     50-step sampling from that checkpoint's EMA weights. Each run's wall,
     and that of its parts (model builds, dataset, batch moves, sampler or
     training loop, `.ply` writes); every sampling run wrote 2 finite pred
     clouds and 2 gt clouds. Then the evaluation CLI on the card on the
     BDM-B clouds, held to `evaluate_dirs(..., device="cpu")` (CD x1000
     within rtol 1e-4, F1 within 1/N), and CD, F1 and EMD timed at the
     eval CLI's default batch, 16 pairs of 4,096 points, with their peak
     memory;
  m. the colouring model: tiny, on the card against the CPU (`predict`
     within 1e-4, the loss within 1e-4 relative; run after f, before the
     shapes of the paths are noted); at full width (ViT-S/16
     at 224 px, embedding 64, one block), B=8, N=4096, `predict` at
     mixed_precision bf16 and "no" (its backbone is float32 either way:
     the same colours within 1e-5), each timed on the host clock (median
     of 3 after a warm-up) with its peak memory, and two training steps
     through `train_loop`.
  n. `bdm_tpu_torch.parallel` on two ranks spawned over gloo (both on the
     one card: NCCL refuses two ranks on one GPU), PC2 at full width: two
     data-parallel float32 SGD steps at B 8, four rows a rank, against one
     process's two steps on the 8 rows (loss within 1e-5 relative, the
     gradient norm within 1e-4, every parameter within 1e-5 of its tensor's
     largest entry over a floor of 1e-6 of the model's largest), one bf16
     step (every kernel; `scatter_sum` twice for the blend and once a
     PVConv for the devoxelization); the Chamfer distance of
     16 x 4,096 points with pred's points split over the ranks against the
     dense one (1e-5 relative); PC2's denoise at B 8, N 4,096 and 16,384,
     float32, with the point axis sharded over the ranks, against the
     unsharded denoise (rtol 1e-4, atol 5e-5, the JAX tests'), its walls
     beside the unsharded ones, and one backward at N 4,096 (every
     gradient within the JAX test's rtol 2e-4, atol 1e-5, or within twice
     what an ulp's nudge of the input moves the unsharded gradient itself:
     a max-pool's gradient jumps where two neighbours nearly tie); every
     kernel of each path
     launched on each rank, checked as a path is; before them the
     scatter-sum at the sharded grid's partial-sum shapes, bit for bit the
     CPU's `index_add_`, timed; after them one world-1 step over NCCL
     against the one process's first, the ranks' checkpoint restored in one
     process, and `parallel.dryrun.dryrun_multichip(2)` on the card.
In c, e, g, h, i, j, k, l, m and n every kernel of the path must have
launched and no plain version may have run on the card (the simple backbone
of j: none may launch); on the bfloat16 paths (b, c, e, i, j, k, l, bf16 g,
the fusion step of h, n's bf16 step) every launch of
attention and conv3d must have taken the tensor-core kernel, on the float32
paths (the colouring model's whatever its configuration) the CUDA-core one.
Every path in this process notes its CUDA graph captures and replays
(`graphs_by_path` in the kernels line); the sampling paths (b's PC2 step,
c, e, i, j but the simple backbone, k's BDM-B, l's three sampling runs)
fail unless their PVCNN2 forwards replayed.
In the phases at production widths (b, c, e, i, j, k, g, h, l, m, n, whose
ranks note theirs and hand them back) every launch of
the kernels whose shapes follow the model's widths (conv3d, attention,
scatter_mean) notes its shape; the run fails if a path gave a kernel a
shape that phase a did not hold against the plain version.

Weights are random from a seed (the released checkpoints are not in the
repository); throughput does not depend on them. The last line of standard
output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0])


def timed_ms(fn, reps: int = 5, warmup: int = 2, inner: int = 1) -> float:
    """Median device time of one fn() over `reps` runs (CUDA events).

    A call of a few microseconds is shorter than the host takes to issue
    it, so events around it would time the host. With `inner` > 1 the card
    is first kept busy by a large matmul while the host queues `inner`
    calls behind it; the events then bracket the calls running back to
    back on the card."""
    import torch
    for _ in range(warmup):
        fn()
    busy = (torch.empty(8192, 8192, device="cuda").normal_()
            if inner > 1 else None)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if busy is not None:
            busy @ busy
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# The published memory rate of one H100 SXM (NVIDIA's data sheet); its
# peak dense rates are the bench's `PEAK_FLOPS`.
HBM_BYTES_PER_S = 3.35e12


def bound(tensors, flops: float, kind: str) -> dict:
    """The least time one H100 SXM could take: the bytes of `tensors`
    (each input read once, each output written once) over the memory
    rate, or `flops` over the peak rate of `kind`, whichever is larger."""
    from bdm_tpu_torch.bench import H100, PEAK_FLOPS
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[H100][kind] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def conv_bound_ms(b, cin, cout, r):
    """The least time of one bf16 conv launch by `benchmark/counting.py`'s
    rule: x, the weights, the float32 bias and the output once over the
    memory rate, or 2 B R^3 27 Cin Cout operations over the bf16 peak."""
    from bdm_tpu_torch.bench import H100, PEAK_FLOPS
    e, r3 = 2, r ** 3
    nbytes = (b * r3 * cin * e + cout * cin * 27 * e + cout * 4
              + b * r3 * cout * e)
    flops = 2 * 27 * cin * cout * r3 * b
    return max(nbytes / HBM_BYTES_PER_S,
               flops / PEAK_FLOPS[H100]["bf16"]) * 1e3


# Times of the CUDA-core kernels that served bfloat16 before the tensor-core
# ones, ms at B=8 on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6
# keeps them in rows 5, 11, 12 and 12u).
PREVIOUS_MS = {
    "attention": {(4096, 64): 8.3895, (4096, 128): 16.3172},
    "conv3d": {(390, 32, 32): 17.5726, (64, 64, 32): 2.9222,
               (512, 512, 8): 4.5892},
}

# Times of the float32 CUDA-core kernels that the present ones replaced: ms
# at B=8 on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6 keeps
# them in rows 5, 9 and 12u)
REPLACED_F32_MS = {
    "attention": {(4096, 64): 8.7200},
    "conv3d": {(64, 64, 32): 2.8040, (128, 128, 9): 0.4323,
               (512, 512, 8): 3.7334},
}

# FPS clouds past what a thread holds in registers (K 16 at 1,024 threads),
# (N, M): N 16,384 is the reference's `dataset.max_points`
FPS_LARGE = [(16384, 4096), (20000, 5000), (40000, 10000)]

# Times of the kernels that the present ones replaced: ms at B=8 on an
# NVIDIA H100 80GB HBM3 at 700.00 W, with how they were timed: one launch
# between CUDA events or launches back to back behind a matmul (PERF.md
# section 6 keeps them in rows 1, 2, 3, 6, 7 and 8; three-NN's timed in
# one call beside the parent tree's kernel)
BEFORE_MS = {
    "fps N4096 M1024": (1.0275, "one launch"),
    "scatter_mean bf16 C390 R32": (0.4598, "one launch"),
    "scatter_mean f32 C64 R32 mean": (0.1144, "one launch"),
    "scatter_mean f32 C64 R32 sum": (0.1093, "one launch"),
    "ball_query N4096 M1024 r0.1": (0.3366, "one launch"),
    "three_nn N4096 M1024": (0.0583, "back to back"),
    "scatter_sum N12288 S1024 C128": (0.1113, "back to back"),
    "scatter_sum N3072 S256 C256": (0.0240, "back to back"),
    "interp_mm N4096 M1024 C128": (0.0067, "back to back"),
    "interp_mm N1024 M256 C256": (0.0047, "back to back")}


# PC2's stage-0 input widths under the options: mask (391), mask and
# distance transform (392), global ViT features (3 + 3 + 384 + 384), and
# PVCNN2++'s inner PVCNN2 (3 + 64)
STAGE0_CINS = (391, 392, 774, 67)
# The precontracted stage-0 conv scatters 27 taps of its 32 outputs
TAP_C = 27 * 32

# Phase a holds conv3d at the convs of PC2, PVD and the fusion network,
# (Cin, Cout, R); an odd grid (R=9, the TPU's per-slab `conv3d_pallas`);
# those of PVD at twice the width, the widest of them Cin 512 (the TPU's
# unpadded `conv3d_mm`); the colouring model's stage 0 (64 -> 32, float32)
CONVS = [(390, 32, 32), (3, 32, 32), (32, 32, 32), (128, 64, 16),
         (64, 64, 16), (192, 128, 8), (128, 128, 8), (256, 256, 8),
         (128, 128, 16), (64, 64, 32), (128, 128, 9),
         (3, 64, 32), (128, 128, 32), (192, 128, 16), (256, 256, 16),
         (320, 256, 8), (512, 512, 8), (64, 32, 32)] + [
             (c, 32, 32) for c in STAGE0_CINS]
# ... the ten of them a PC2 and a PVD forward run (the benchmark cell's)
FORWARD_CONVS = CONVS[:10]
# ... and attention at (S, C): C 64 at the published widths, C 128 (the
# kernel's widest) in PVD at twice the width
ATTNS = [(4096, 64), (4096, 128)]
# ... and scatter_mean at the voxel sites of PC2, PVD and the fusion
# network, (C, R, N): 390 = PC2 stage-0 input; then those of PVD at twice
# the width on 2,048 points; those of the stages at the input level of PC2
# on 16,384 points (phase n's unsharded reference)
SITES = [(390, 32, 4096), (3, 32, 4096), (32, 32, 4096),
         (192, 8, 256), (256, 8, 64), (256, 8, 256), (128, 16, 1024),
         (64, 32, 4096),
         (3, 32, 2048), (64, 32, 2048), (128, 32, 2048), (192, 16, 1024),
         (256, 16, 1024), (320, 8, 256), (512, 8, 64), (512, 8, 256),
         (TAP_C, 32, 4096)] + [(c, 32, 4096) for c in STAGE0_CINS] + [
             (390, 32, 16384), (32, 32, 16384), (64, 32, 16384)]

# Phase a holds the bf16 blend bit for bit at (B, N, M, C): the two FP
# stages of the paths, then B 1, N no multiple of a block's rows (64 at
# C 128: 4,000 = 62 blocks and 32 rows), C 8, 40 and 264 (one, five and
# 33 groups of 8 channels), C 12 and 200 (one channel a group, "scalar";
# 200 groups span two passes of a 128-thread block), M 128 (the dispatch's
# least) and N 300, 64
INTERP_SHAPES = [(8, 4096, 1024, 128), (8, 1024, 256, 256),
                 (1, 4096, 1024, 128), (8, 4000, 1024, 128),
                 (8, 4096, 128, 8), (8, 4096, 256, 40),
                 (8, 1024, 256, 264), (8, 4096, 128, 12),
                 (8, 512, 128, 128), (2, 64, 1024, 128),
                 (8, 300, 1024, 12), (2, 1000, 128, 200)]

# ... and GroupNorm at (S, C), S the positions of a sample: those of PC2
# and PVD on 4,096 points, PVD on 2,048, PC2 on 16,384 and 8,192 (phase n's
# unsharded reference and its shards), PVD at twice the width on 2,048
# points; each is held at float32 and bf16
GN_SHAPES = [(16, 512), (64, 256), (256, 128), (256, 256), (512, 128),
             (512, 256), (512, 512), (1024, 64), (1024, 128), (1024, 256),
             (2048, 128), (2048, 256), (4096, 32), (4096, 64), (4096, 128),
             (8192, 64), (8192, 128), (32768, 32), (32768, 64),
             (2048, 32), (2048, 64), (16384, 32), (16384, 64), (16384, 128),
             (8192, 32),
             (16, 1024), (64, 512), (256, 512), (512, 1024), (1024, 512),
             (2048, 512), (4096, 256), (8192, 256), (32768, 128)]

# ... and the gated devoxelization at (N, C, R) of the 14 PVConvs of a
# PVCNN2 forward (PC2 and PVD alike), SA stages then FP stages
DEVOX_SHAPES = [(4096, 32, 32), (4096, 32, 32), (1024, 64, 16),
                (256, 128, 8)] + [(64, 256, 8)] * 3 + [(256, 256, 8)] * 3 + [
                    (1024, 128, 16)] * 2 + [(4096, 64, 32)] * 2
DEVOX_A_FORWARD = len(DEVOX_SHAPES)
# ... and at the other (N, C, R) of the paths: the input level's two
# (R 32, C 32 and 64) of PVD on 2,048 points, of PC2 on 16,384 (phase n's
# unsharded reference) and of its 8,192-point shards (the 4,096-point
# cloud's shards are 2,048), those of PVD at twice the width on 2,048
# points that no other path has, and its input level on 4,096; every shape
# here and in DEVOX_SHAPES is held at float32 and bf16
DEVOX_MORE = [(n, c, 32) for n in (2048, 8192, 16384) for c in (32, 64)] + [
    (2048, 128, 32), (64, 512, 8), (256, 512, 8), (1024, 256, 16),
    (4096, 128, 32)]
# ... and at (B, N, C, R) off the paths: N no multiple of a block's points,
# R odd, C of one to eight 16-byte groups
DEVOX_EDGES = [(2, 37, 8, 5), (3, 1000, 24, 9), (2, 300, 16, 4),
               (1, 4095, 64, 32), (2, 77, 40, 7)]

# The shapes the paths gave the kernels whose shapes follow the model's
# widths: conv3d (Cin, Cout, R, the planes of its tile: `conv_key`),
# attention (S, C), scatter_mean (C, R, N),
# groupnorm (S, C, dtype), devox (N, C, R, dtype).
SEEN = {"conv3d": set(), "attention": set(), "scatter_mean": set(),
        "groupnorm": set(), "devox": set()}


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def record_shapes():
    """From here on (the phases at production widths) every launch of
    conv3d, attention, scatter_mean, GroupNorm and the gated
    devoxelization notes its shape in SEEN."""
    from bdm_tpu_torch.ops.cuda import (attention, conv3d, devox, groupnorm,
                                        voxelize)
    keys = {
        "devox": (devox, lambda grid, x, *_: (
            x.shape[1], grid.shape[-1], grid.shape[1],
            _dtype_name(grid.dtype))),
        "groupnorm": (groupnorm, lambda x, *_: (
            x.numel() // (x.shape[0] * x.shape[-1]), x.shape[-1],
            _dtype_name(x.dtype))),
        "conv3d": (conv3d, lambda x, w, b: conv_key(x, w)),
        "attention": (attention, lambda q, k, v: tuple(q.shape[1:])),
        "scatter_mean": (voxelize, lambda f, order, ids_sorted, lo, r, *_:
                         (f.shape[-1], r, f.shape[1])),
    }
    for name, (mod, key) in keys.items():
        def noting(*args, _inner=mod._forward, _key=key, _name=name):
            SEEN[_name].add(_key(*args))
            return _inner(*args)
        mod._forward = noting


def conv_key(x, w):
    """(Cin, Cout, R, planes) of a conv: the z-planes a warpgroup of its
    tile takes follow the batch (`bdm_conv3d_planes`; 0 at float32), so a
    shape is held at each depth a path ran it at."""
    from bdm_tpu_torch.ops.cuda import _lib
    b, r, cin = x.shape[0], x.shape[1], x.shape[-1]
    planes = _lib.library().bdm_conv3d_planes(
        _lib.DTYPE_CODES[x.dtype], b, r, cin, w.shape[0],
        int(x.data_ptr() % 16 == 0))
    return cin, w.shape[0], r, planes


def check_shapes_covered(checked):
    for name, seen in SEEN.items():
        print(f"{name} shapes on the paths:", sorted(seen))
        if not seen:
            fail(f"no shape of {name} was noted on any path")
        if seen - checked[name]:
            fail(f"{name} ran on a path at {sorted(seen - checked[name])}, "
                 f"which phase a did not hold against the plain version")


# ------------------------------------------------------------ phase a

def check_kernels(dev):
    """-> ({name: {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
    "library_ms"}} at production shapes, B=8, and the shapes at which
    conv3d, attention and scatter_mean were held against their plain
    versions, keyed as SEEN). Operation counts: 8 flops a squared distance
    plus the compares of the scan; 2 a multiply-add."""
    import torch
    import torch.nn.functional as F
    from bdm_tpu_torch import ops
    from bdm_tpu_torch.ops.cuda import (_lib, attention, ball_query, conv3d,
                                        fps, groupnorm, interp, scatter_sum,
                                        three_nn, voxelize)

    g = torch.Generator().manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def rel_err(a, b, tol, what):
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        if not err <= tol * scale:
            fail(f"{what}: max|err| {err} > {tol} * {scale}")
        return err

    res = {}
    b = 8
    lib = _lib.library()
    # PVCNN2 levels (N, M, radius): FPS and ball query at every SA stage,
    # three-NN at every FP stage
    levels = [(4096, 1024, 0.1), (1024, 256, 0.2), (256, 64, 0.4),
              (64, 16, 0.8)]
    pts = {4096: randn(b, 4096, 3, scale=0.3)}
    for n, m, _ in levels:
        idx = fps.furthest_point_sample(pts[n], m)
        if not torch.equal(idx, fps.furthest_point_sample_plain(pts[n], m)):
            fail(f"fps differs at N={n}, M={m}")
        pts[m] = ops.gather(pts[n], idx).contiguous()
    # and on tie-heavy clouds at every level: the integer lattice (64
    # points repeated: many exactly equal distances) and exact duplicates
    # in shuffled order; then N that is no multiple of the block or of 32
    lattice = torch.stack(torch.meshgrid(*[torch.arange(4.0)] * 3,
                                         indexing="ij"), -1).reshape(-1, 3)
    ties = {}
    for n, m in [(n, m) for n, m, _ in levels] + [(96, 96), (1000, 300),
                                                    (64, 64)]:
        half = randn(b, -(-n // 2), 3)
        clouds = {"lattice": lattice.repeat(-(-n // 64), 1)[:n].expand(
                      b, n, 3).contiguous().to(dev),
                  "duplicates": torch.cat([half, half.flip(1)], 1)[
                      :, torch.randperm(n, generator=g)].contiguous()}
        if n % 32:
            clouds["random"] = randn(b, n, 3)
        ties[n, m] = clouds
        for kind, x in clouds.items():
            if not torch.equal(fps.furthest_point_sample(x, m),
                               fps.furthest_point_sample_plain(x, m)):
                fail(f"fps differs on the {kind} cloud at N={n}, M={m}")
        if (lib.bdm_fps_threads(n), lib.bdm_fps_points(n)) != (
                fps.threads(n), fps.points(n)):
            fail(f"fps: the source's block for N={n} is not `threads`, "
                 f"`points`")
    # the first level of a cloud of 2,048 points (PVD at twice the width)
    pts[2048] = pts[4096][:, :2048].contiguous()
    pts[16384] = randn(b, 16384, 3, scale=0.3)     # phase n's largest cloud
    idx2 = fps.furthest_point_sample(pts[2048], 1024)
    if not torch.equal(idx2, fps.furthest_point_sample_plain(pts[2048],
                                                             1024)):
        fail("fps differs at N=2048, M=1024")
    half = ops.gather(pts[2048], idx2).contiguous()
    if not torch.equal(ball_query.ball_query(half, pts[2048], 0.1, 32),
                       ball_query.ball_query_plain(half, pts[2048], 0.1,
                                                   32)):
        fail("ball_query differs at N=2048, M=1024")
    i, w = three_nn.three_nn(pts[2048], half)
    pi, pw = three_nn.three_nn_plain(pts[2048], half)
    if not torch.equal(i, pi):
        fail("three_nn indices differ at N=2048, M=1024")
    rel_err(w, pw, 1e-6, "three_nn weights N=2048")
    # past the registers: the streamed variant, exact against the plain
    # version, one launch timed
    large = {}
    for n, m in FPS_LARGE:
        x = randn(b, n, 3, scale=0.3)
        if not torch.equal(fps.furthest_point_sample(x, m),
                           fps.furthest_point_sample_plain(x, m)):
            fail(f"fps differs at N={n}, M={m}")
        if (lib.bdm_fps_threads(n), lib.bdm_fps_points(n)) != (
                fps.threads(n), fps.points(n)):
            fail(f"fps: the source's block for N={n} is not `threads`, "
                 f"`points`")
        large[f"N{n}_M{m}"] = timed_ms(
            lambda: fps.furthest_point_sample(x, m), 3, 1)
    c0, p0 = pts[1024], pts[4096]
    res["fps"] = dict(
        max_abs_err=0.0,
        ms=timed_ms(lambda: fps.furthest_point_sample(p0, 1024), inner=10),
        ms_one_launch=timed_ms(lambda: fps.furthest_point_sample(p0, 1024)),
        timing="10 launches back to back behind a matmul",
        ms_one_launch_large_n=large,
        plain_ms=timed_ms(
            lambda: fps.furthest_point_sample_plain(p0, 1024), 3, 1),
        library_ms=None,
        # each of M - 1 rounds: N distances, a min and an argmax compare
        **bound([p0, idx.new_empty((b, 1024))], b * 1023 * 4096 * 10, "f32"))

    def hold_ball_query(c, x, r, what):
        got = ball_query.ball_query(c, x, r, 32)
        if not torch.equal(got, ball_query.ball_query_plain(c, x, r, 32)):
            fail(f"ball_query differs {what}")
        return got

    for n, m, r in levels:
        a = hold_ball_query(pts[m], pts[n], r, f"at N={n}, M={m}, r={r}")
        # the tie clouds of the FPS loop, their centres by FPS
        for kind, x in ties[n, m].items():
            c = ops.gather(x, fps.furthest_point_sample(x, m)).contiguous()
            hold_ball_query(c, x, r, f"on the {kind} cloud at N={n}")
    # the lattice at r = 1.0: a face neighbour lies at d2 = r2 exactly and
    # is out (strict <); then fewer points than slots
    lat = ties[4096, 1024]["lattice"]
    hold_ball_query(lat[:, :1024].contiguous(), lat, 1.0,
                    "on the lattice at r=1.0")
    few = pts[4096][:, :20].contiguous()
    hold_ball_query(few[:, :8].contiguous(), few, 0.4, "at N=20 < U=32")
    # the scan of a centre may stop at its 32nd hit: count the pairs this
    # data needs, not all M * N
    hits = (fps.sqdist(c0[:, :, None, :], p0[:, None, :, :])
            < torch.tensor(0.1, device=dev) ** 2).cumsum(-1)
    scanned = torch.where(hits[..., -1] >= 32,
                          (hits < 32).sum(-1) + 1, 4096).sum().item()
    # back to back at every shape of the paths: the four SA levels and the
    # first level of PVD at twice the width
    by_shape = {f"N{n}_M{m}": timed_ms(
        lambda: ball_query.ball_query(pts[m], pts[n], r, 32), inner=10)
        for n, m, r in levels}
    by_shape["N2048_M1024"] = timed_ms(
        lambda: ball_query.ball_query(half, pts[2048], 0.1, 32), inner=10)
    res["ball_query"] = dict(
        max_abs_err=0.0,
        ms=by_shape["N4096_M1024"], ms_by_shape=by_shape,
        ms_one_launch=timed_ms(lambda: ball_query.ball_query(c0, p0, 0.1,
                                                             32)),
        timing="10 launches back to back behind a matmul",
        plain_ms=timed_ms(lambda: ball_query.ball_query_plain(c0, p0, 0.1,
                                                              32)),
        library_ms=None,
        **bound([c0, p0, a.new_empty((b, 1024, 32))], scanned * 9, "f32"))

    def hold_three_nn(x, c, what):
        i, w = three_nn.three_nn(x, c)
        pi, pw = three_nn.three_nn_plain(x, c)
        if not torch.equal(i, pi):
            fail(f"three_nn indices differ {what}")
        return i, w, rel_err(w, pw, 1e-6, f"three_nn weights {what}")

    err = 0.0
    nn = {}
    for n, m, _ in levels:
        i, w, e = hold_three_nn(pts[n], pts[m], f"at N={n}, M={m}")
        err = max(err, e)
        nn[n] = (i, w)
        # the tie clouds of the FPS loop against their FPS centres, and the
        # lattice's cell centres (eight corners at one distance)
        for kind, x in ties[n, m].items():
            c = ops.gather(x, fps.furthest_point_sample(x, m)).contiguous()
            err = max(err, hold_three_nn(x, c, f"on the {kind} cloud at "
                                         f"N={n}")[2])
            if kind == "lattice":
                err = max(err, hold_three_nn(
                    x + 0.5, c, f"at the lattice's cell centres, N={n}")[2])
        if (lib.bdm_three_nn_lanes(b, n, m), lib.bdm_three_nn_step(m)) != (
                three_nn.lanes(b, n, m), three_nn.step(m)):
            fail(f"three_nn: the source's split for N={n}, M={m} is not "
                 f"`lanes`, `step`")
    # fewer centres than three; at N 64 also fewer than a query's lanes
    # (M 3, 5, 17 give L 4, 8, 32: whole lanes hold only sentinels)
    for n in (4096, 64):
        for m in (1, 2, 3, 5, 17):
            err = max(err, hold_three_nn(pts[n], pts[16][:, :m].contiguous(),
                                         f"at N={n}, M={m}")[2])
    if not all(m < three_nn.lanes(b, 64, m) for m in (3, 5, 17)):
        fail("three_nn: no case with fewer centres than lanes")
    # back to back at every shape of the paths: the four FP levels and the
    # first level of PVD at twice the width
    by_shape = {f"N{n}_M{m}": timed_ms(
        lambda: three_nn.three_nn(pts[n], pts[m]), inner=10)
        for n, m, _ in levels}
    by_shape["N2048_M1024"] = timed_ms(
        lambda: three_nn.three_nn(pts[2048], half), inner=10)
    pairs = b * 4096 * 1024
    res["three_nn"] = dict(
        max_abs_err=err,
        ms=by_shape["N4096_M1024"], ms_by_shape=by_shape,
        ms_one_launch=timed_ms(lambda: three_nn.three_nn(p0, c0)),
        timing="10 launches back to back behind a matmul",
        plain_ms=timed_ms(lambda: three_nn.three_nn_plain(p0, c0)),
        library_ms=None,
        # a distance and one compare against the third-best a pair (an
        # insertion is rare)
        **bound([p0, c0, *nn[4096]], pairs * 9, "f32"))

    # the bf16 blend, bit for bit against the plain version at the two FP
    # stages that take it and at the edge shapes of INTERP_SHAPES; the
    # source's split is the wrapper's
    if (lib.bdm_interp_threads(), lib.bdm_interp_rows()) != (
            interp.THREADS, interp.ROWS):
        fail("interp_mm: the source's split is not `THREADS`, `ROWS`")
    for bi, n, m, c in INTERP_SHAPES:
        x = randn(bi, n, 3, scale=0.3)
        i, w = three_nn.three_nn(x, randn(bi, m, 3, scale=0.3))
        f = randn(bi, m, c, dtype=torch.bfloat16)
        if not torch.equal(interp.interp_mm(i, w, f),
                           interp.interp_mm_plain(i, w, f)):
            fail(f"interp_mm B={bi} N={n} M={m} C={c}: not the plain "
                 f"version bit for bit")
    by_shape = {}
    for n, m, c in ((1024, 256, 256), (4096, 1024, 128)):
        i, w = nn[n]
        f = randn(b, m, c, dtype=torch.bfloat16)
        out = interp.interp_mm(i, w, f)
        if not torch.equal(out, interp.interp_mm_plain(i, w, f)):
            fail(f"interp_mm N={n} M={m} C={c}: not the plain version bit "
                 f"for bit")
        # one PyTorch call for the same blend: a weighted embedding bag
        # over the flattened (B*M, C) table
        flat = (i.long() + torch.arange(b, device=dev)[:, None, None] * m
                ).reshape(-1, 3)
        wb = w.to(torch.bfloat16).reshape(-1, 3)
        table = f.reshape(b * m, c)
        bag = F.embedding_bag(flat, table, per_sample_weights=wb,
                              mode="sum")
        rel_err(bag.reshape(out.shape), out, 2 ** -7,
                "embedding_bag yardstick")
        # the host's cost of enqueueing one call: 1,000 calls on the host
        # clock with no synchronise (after 100 warm-up calls)
        for _ in range(100):
            interp.interp_mm(i, w, f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            interp.interp_mm(i, w, f)
        enqueue_us = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        by_shape[f"N{n}_M{m}_C{c}"] = dict(
            ms=timed_ms(lambda: interp.interp_mm(i, w, f), inner=20),
            ms_one_launch=timed_ms(lambda: interp.interp_mm(i, w, f)),
            enqueue_us=enqueue_us,
            library_ms=timed_ms(lambda: F.embedding_bag(
                flat, table, per_sample_weights=wb, mode="sum"), inner=20),
            # three multiply-adds a channel, not the one-hot product's 2*M
            **bound([i, w, f, out], b * n * c * 6, "f32"))
    res["interp_mm"] = dict(
        by_shape["N4096_M1024_C128"], max_abs_err=0.0,
        ms_by_shape=by_shape,
        # unlike the other rows: inputs and the recycled output stay in L2
        timing="20 launches back to back behind a matmul, warm L2",
        plain_ms=timed_ms(lambda: interp.interp_mm_plain(i, w, f)))

    # the backward of the blend at the same two stages: 3N float32 rows
    # summed into M centres by the unsorted three-NN indices. The card's
    # `index_add_` adds with atomics in an order that changes from run to
    # run: 1e-5 of the largest sum; the CPU's adds in index order, as the
    # kernel does: equal bit for bit, for float32 and bf16 rows, with ids
    # -1 and S (dropped) and with every row on one id
    err = 0.0
    by_shape = {}
    for n, m, c in ((1024, 256, 256), (4096, 1024, 128)):
        ids = nn[n][0].reshape(b, 3 * n).contiguous()
        rows = randn(b, 3 * n, c)
        sums = scatter_sum.scatter_sum(rows, ids, m)
        err = max(err, rel_err(sums, scatter_sum.scatter_sum_plain(
            rows, ids, m), 1e-5, f"scatter_sum N={3 * n} S={m} C={c}"))
        dropped = ids.clone()
        dropped[:, ::7] = -1
        dropped[:, 3::11] = m
        cases = {"float32 rows": (rows, ids),
                 "bf16 rows": (rows.to(torch.bfloat16), ids),
                 "ids -1 and S": (rows, dropped),
                 "every row on one id": (rows, torch.full_like(ids, m // 2))}
        for what, (x, i) in cases.items():
            if not torch.equal(scatter_sum.scatter_sum(x, i, m).cpu(),
                               scatter_sum.scatter_sum_plain(x.cpu(),
                                                             i.cpu(), m)):
                fail(f"scatter_sum N={3 * n} S={m} C={c} {what}: not the "
                     f"CPU's index_add_ bit for bit")
        sdst = (ids.long()
                + torch.arange(b, device=dev)[:, None] * m).reshape(-1)
        flat_rows = rows.reshape(-1, c)
        sacc = torch.empty((b * m, c), device=dev)
        by_shape[f"N{3 * n}_S{m}_C{c}"] = dict(
            ms=timed_ms(lambda: scatter_sum.scatter_sum(rows, ids, m),
                        inner=20),
            ms_one_launch=timed_ms(
                lambda: scatter_sum.scatter_sum(rows, ids, m)),
            library_ms=timed_ms(
                lambda: sacc.zero_().index_add_(0, sdst, flat_rows),
                inner=20),
            # one add a feature
            **bound([rows, ids, sums], rows.numel(), "f32"))
    res["scatter_sum"] = dict(
        by_shape["N12288_S1024_C128"], max_abs_err=err, ms_by_shape=by_shape,
        timing="20 launches back to back behind a matmul",
        plain_ms=timed_ms(lambda: scatter_sum.scatter_sum_plain(rows, ids,
                                                                m)))

    ctxs = {}
    err = 0.0
    for c, r, n in SITES:
        ctx = ctxs.setdefault((r, n), ops.make_voxel_context(pts[n], r))
        for ti in _lib.DTYPE_CODES:
            for to in _lib.DTYPE_CODES:
                src = (lib.bdm_scatter_mean_vec(_lib.DTYPE_CODES[ti],
                                                _lib.DTYPE_CODES[to], c),
                       lib.bdm_scatter_mean_lanes(_lib.DTYPE_CODES[ti],
                                                  _lib.DTYPE_CODES[to], c))
                if src != voxelize.kernel_path(ti, to, c):
                    fail(f"scatter_mean C={c} {ti} -> {to}: the source's "
                         f"vector and lanes {src} are not `kernel_path`")
        # means and, with divide off, raw sums (the float32 unpadded
        # contract of the TPU's `scatter_sum_sorted_pallas`)
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
            f = randn(b, n, c, dtype=dt)
            for divide in (True, False):
                args = (f, ctx.order, ctx.ids_sorted, ctx.voxel_lo, r, dt,
                        divide)
                grid = voxelize.scatter_mean(*args, ids=ctx.ids)
                err = max(err, rel_err(
                    grid, voxelize.scatter_mean_plain(*args), tol,
                    f"scatter_mean C={c} R={r} {dt} divide={divide}"))
    ctx0 = ctxs[(32, 4096)]
    # float32 sums in the reference's order: equal, bit for bit, to the
    # plain version on the CPU (the card's `index_add_` adds with atomics)
    for c in (390, 64):
        f = randn(b, 4096, c)
        for divide in (True, False):
            args = (f, ctx0.order, ctx0.ids_sorted, ctx0.voxel_lo, 32,
                    torch.float32, divide)
            on_cpu = voxelize.scatter_mean_plain(
                *(t.cpu() if torch.is_tensor(t) else t for t in args))
            if not torch.equal(voxelize.scatter_mean(*args, ids=ctx0.ids)
                               .cpu(), on_cpu):
                fail(f"scatter_mean float32 C={c} R=32 divide={divide} is "
                     f"not the CPU's plain version bit for bit")
    f0 = randn(b, 4096, 390, dtype=torch.bfloat16)
    vargs = (f0, ctx0.order, ctx0.ids_sorted, ctx0.voxel_lo, 32,
             torch.bfloat16)
    vmean = partial(voxelize.scatter_mean, ids=ctx0.ids)
    grid0 = vmean(*vargs)
    # one PyTorch call: `index_add_` of the sorted, pre-divided rows into
    # a zeroed float32 grid
    cnt = torch.gather(ctx0.voxel_lo[:, 1:] - ctx0.voxel_lo[:, :-1], 1,
                       ctx0.ids_sorted.long()).float()
    rows = (torch.gather(f0, 1, ctx0.order.long()[..., None].expand_as(f0))
            .float() / cnt[..., None]).reshape(-1, 390)
    dst = (ctx0.ids_sorted.long()
           + torch.arange(b, device=dev)[:, None] * 32 ** 3).reshape(-1)
    acc = torch.empty((b * 32 ** 3, 390), device=dev)

    def f32_site(c, divide):
        """Times of the float32 unpadded store at R=32, N=4096: the shape
        a float32 training step gives the last FP stage."""
        f = randn(b, 4096, c)
        a = (f, ctx0.order, ctx0.ids_sorted, ctx0.voxel_lo, 32,
             torch.float32, divide)
        out = vmean(*a)
        src = torch.gather(f, 1, ctx0.order.long()[..., None].expand_as(f))
        if divide:
            src = src / cnt[..., None]
        src = src.reshape(-1, c)
        acc32 = torch.empty((b * 32 ** 3, c), device=dev)
        return dict(
            ms=timed_ms(lambda: vmean(*a), inner=20),
            ms_one_launch=timed_ms(lambda: vmean(*a)),
            plain_ms=timed_ms(lambda: voxelize.scatter_mean_plain(*a)),
            library_ms=timed_ms(lambda: acc32.zero_().index_add_(0, dst,
                                                                 src),
                                inner=20),
            library_ms_one_launch=timed_ms(
                lambda: acc32.zero_().index_add_(0, dst, src)),
            **bound([f, ctx0.order, ctx0.voxel_lo, out],
                    b * 4096 * c * (2 if divide else 1), "f32"))

    # kernel and library call as 20 calls back to back behind a matmul (one
    # launch is shorter than the host takes to launch it); beside them one
    # launch between events, as the kernels they replaced were timed
    res["scatter_mean"] = dict(
        f32_c64_r32_mean=f32_site(64, True),
        f32_c64_r32_sum=f32_site(64, False),
        max_abs_err=err, ms=timed_ms(lambda: vmean(*vargs), inner=20),
        ms_one_launch=timed_ms(lambda: vmean(*vargs)),
        timing="20 launches back to back behind a matmul",
        plain_ms=timed_ms(lambda: voxelize.scatter_mean_plain(*vargs)),
        library_ms=timed_ms(lambda: acc.zero_().index_add_(0, dst, rows),
                            inner=20),
        library_ms_one_launch=timed_ms(
            lambda: acc.zero_().index_add_(0, dst, rows)),
        # a divide and an add a feature
        **bound([f0, ctx0.order, ctx0.voxel_lo, grid0], b * 4096 * 390 * 2,
                "f32"))

    # the precontracted stage-0 conv's tap scatter: bf16 taps, float32 out
    # at C 864, equal to the CPU's plain version bit for bit; one PyTorch
    # call: `index_add_` of the pre-divided float32 rows
    taps = randn(b, 4096, TAP_C, dtype=torch.bfloat16)
    targs = (taps, ctx0.order, ctx0.ids_sorted, ctx0.voxel_lo, 32,
             torch.float32)
    tgrid = vmean(*targs)
    if not torch.equal(tgrid.cpu(), voxelize.scatter_mean_plain(
            *(t.cpu() if torch.is_tensor(t) else t for t in targs))):
        fail(f"scatter_mean bf16 -> float32 C={TAP_C} is not the CPU's "
             f"plain version bit for bit")
    trows = (torch.gather(taps, 1, ctx0.order.long()[..., None].expand_as(
        taps)).float() / cnt[..., None]).reshape(-1, TAP_C)
    tacc = torch.empty((b * 32 ** 3, TAP_C), device=dev)
    res["scatter_mean"]["precontract_bf16_to_f32_c864_r32"] = dict(
        kernel_path=voxelize.kernel_path(torch.bfloat16, torch.float32,
                                         TAP_C),
        ms=timed_ms(lambda: vmean(*targs), inner=20),
        ms_one_launch=timed_ms(lambda: vmean(*targs)),
        plain_ms=timed_ms(lambda: voxelize.scatter_mean_plain(*targs)),
        library_ms=timed_ms(lambda: tacc.zero_().index_add_(0, dst, trows),
                            inner=20),
        **bound([taps, ctx0.order, ctx0.voxel_lo, tgrid],
                b * 4096 * TAP_C * 2, "f32"))
    del taps, tgrid, trows, tacc

    def bf16_site(c):
        """Times of the bf16 stage-0 voxelize at width C (R 32, N 4096)
        beside `index_add_` of the pre-divided float32 rows."""
        f = randn(b, 4096, c, dtype=torch.bfloat16)
        a = (f, ctx0.order, ctx0.ids_sorted, ctx0.voxel_lo, 32,
             torch.bfloat16)
        out = vmean(*a)
        src = (torch.gather(f, 1, ctx0.order.long()[..., None].expand_as(f))
               .float() / cnt[..., None]).reshape(-1, c)
        acc_c = torch.empty((b * 32 ** 3, c), device=dev)
        return dict(
            ms=timed_ms(lambda: vmean(*a), inner=20),
            library_ms=timed_ms(lambda: acc_c.zero_().index_add_(0, dst, src),
                                inner=20),
            **bound([f, ctx0.order, ctx0.voxel_lo, out], b * 4096 * c * 2,
                    "f32"))

    res["scatter_mean"]["stage0_bf16_by_c"] = {
        str(c): bf16_site(c) for c in STAGE0_CINS}

    convs = CONVS
    # beside them, held but on no path: every Cin of the list on the odd
    # grid (tiles ragged in all three axes), a Cout that is no multiple of
    # the N tile, and an odd Cout
    ragged = sorted({(cin, 32, 9) for cin, _, _ in convs}) + [
        (64, 130, 9), (16, 7, 5)]
    err = 0.0
    conv_checked = set()
    for cin, cout, r in convs + ragged:
        wt = randn(cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        # bf16 also at B 1, where most shapes take the one-plane tile
        for dt, tol, bb in ((torch.float32, 1e-4, b),
                            (torch.bfloat16, 1e-2, 1),
                            (torch.bfloat16, 1e-2, b)):
            code = _lib.DTYPE_CODES[dt]
            if lib.bdm_conv3d_n_tile(code, cout) != conv3d.n_tile(dt, cout):
                fail(f"conv3d: the source's N tile for Cout={cout} {dt} is "
                     f"not the wrapper's")
            path = lib.bdm_conv3d_path(code, cin, cout, r)
            if path != conv3d.PATH_CODES[conv3d.kernel_path(dt, cin, cout,
                                                            r)]:
                fail(f"conv3d {cin}->{cout} R={r} {dt}: the source's "
                     f"dispatch is not `kernel_path`")
            x = randn(bb, r, r, r, cin, dtype=dt)
            err = max(err, rel_err(conv3d.conv3d(x, wt, bias),
                                   conv3d.conv3d_plain(x, wt, bias), tol,
                                   f"conv3d {cin}->{cout} R={r} B={bb} {dt}"))
            conv_checked.add(conv_key(x, wt))

    def conv_times(cin, cout, r, dt=torch.bfloat16):
        """Kernel, plain and one-call (cuDNN, channels-last, in the grid's
        type; float32 without TF32) times and the bound of one conv; the
        one call must agree. Kernel and one call are timed 10 launches back
        to back behind a matmul (the card's time, not the host's: one
        launch of the wrapper costs the host some 50 us), the kernel also
        one launch between events."""
        x = randn(b, r, r, r, cin, dtype=dt)
        wt = randn(cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        y = conv3d.conv3d(x, wt, bias)
        xl = x.permute(0, 4, 1, 2, 3)
        wl = wt.to(dt).contiguous(memory_format=torch.channels_last_3d)
        bl = bias.to(dt)
        bf16 = dt == torch.bfloat16
        rel_err(F.conv3d(xl, wl, bl, padding=1).permute(0, 2, 3, 4, 1), y,
                2e-2 if bf16 else 1e-4,
                f"F.conv3d {dt} yardstick {cin}->{cout}")
        return dict(
            ms=timed_ms(lambda: conv3d.conv3d(x, wt, bias), inner=10),
            ms_one_launch=timed_ms(lambda: conv3d.conv3d(x, wt, bias)),
            timing="10 launches back to back behind a matmul",
            plain_ms=timed_ms(lambda: conv3d.conv3d_plain(x, wt, bias)),
            library_ms=timed_ms(lambda: F.conv3d(xl, wl, bl, padding=1),
                                inner=10),
            **bound([x, wt, bias, y], 2 * 27 * cin * cout * r ** 3 * b,
                    "bf16" if bf16 else "f32"))

    def conv_by_shape(cin, cout, r, bb):
        """One bf16 conv at batch `bb`, held against the plain version: 10
        launches back to back behind a matmul, against
        `benchmark/counting.py`'s bound."""
        x = randn(bb, r, r, r, cin, dtype=torch.bfloat16)
        wt = randn(cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        rel_err(conv3d.conv3d(x, wt, bias), conv3d.conv3d_plain(x, wt, bias),
                1e-2, f"conv3d {cin}->{cout} R={r} B={bb} bfloat16")
        conv_checked.add(conv_key(x, wt))
        ms = timed_ms(lambda: conv3d.conv3d(x, wt, bias), inner=10)
        bound = conv_bound_ms(bb, cin, cout, r)
        return dict(ms=ms, bound_ms=bound, share=bound / ms)

    # timed at PC2's wide stage-0 conv (the TPU's conv3d_mm) and at the
    # largest narrow one (conv3d_ms): the last FP stage's 64 -> 64, R 32
    # and at the contracts of the TPU's other convs: a float32 grid, an
    # odd resolution, an unpadded input wider than 256 channels
    res["conv3d"] = dict(
        max_abs_err=err, **conv_times(390, 32, 32),
        narrow_64_64_r32=conv_times(64, 64, 32),
        f32_64_64_r32=conv_times(64, 64, 32, torch.float32),
        f32_128_128_r9=conv_times(128, 128, 9, torch.float32),
        f32_512_512_r8=conv_times(512, 512, 8, torch.float32),
        # the float32 convs that dominate a float32 PC2 step
        f32_390_32_r32=conv_times(390, 32, 32, torch.float32),
        f32_32_32_r32=conv_times(32, 32, 32, torch.float32),
        # the colouring model's stage-0 conv (its backbone is float32)
        f32_64_32_r32=conv_times(64, 32, 32, torch.float32),
        bf16_512_512_r8=conv_times(512, 512, 8),
        # stage 0 under the options (bf16): mask, mask + distance
        # transform, global ViT features, PVCNN2++
        stage0_by_cin={str(c): conv_times(c, 32, 32) for c in STAGE0_CINS},
        # every conv of the list at B 8 and at the benchmark's B 64, bf16
        bf16_by_shape={f"{cin}_{cout}_r{r}_b{bb}": conv_by_shape(
            cin, cout, r, bb) for cin, cout, r in CONVS for bb in (8, 64)})

    attns = ATTNS

    def hold_attention(s, c, dt, tol, scale=0.3):
        tc = lib.bdm_attention_path(_lib.DTYPE_CODES[dt], s, c) == 1
        if tc != (attention.kernel_path(dt, s, c) == "tc"):
            fail(f"attention S={s} C={c} {dt}: the source's dispatch is "
                 f"not `kernel_path`")
        qkv = [randn(b, s, c, scale=scale, dtype=dt) for _ in range(3)]
        out = attention.attention(*qkv)
        if not torch.isfinite(out).all():
            fail(f"attention S={s} C={c} {dt}: output not finite")
        return rel_err(out, attention.attention_plain(*qkv), tol,
                       f"attention S={s} C={c} {dt}")

    def attn_times(s, c):
        """Holds attention at (S, C) in both types; -> the bf16 times, the
        one PyTorch call (fused attention with the scale the layer uses,
        1) and the bound: q k^T and p v, two products of 2 * S * S * C."""
        err = 0.0
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            err = max(err, hold_attention(s, c, dt, tol))
        qkv = [randn(b, s, c, scale=0.3, dtype=torch.bfloat16)
               for _ in range(3)]
        out = attention.attention(*qkv)
        heads = [t[:, None] for t in qkv]
        rel_err(F.scaled_dot_product_attention(*heads, scale=1.0)[:, 0], out,
                2e-2, "scaled_dot_product_attention yardstick")
        return dict(
            max_abs_err=err,
            ms=timed_ms(lambda: attention.attention(*qkv), inner=10),
            ms_one_launch=timed_ms(lambda: attention.attention(*qkv)),
            timing="10 launches back to back behind a matmul",
            plain_ms=timed_ms(lambda: attention.attention_plain(*qkv)),
            library_ms=timed_ms(
                lambda: F.scaled_dot_product_attention(*heads, scale=1.0),
                inner=10),
            **bound([*qkv, out], 4 * s ** 2 * c * b, "bf16"))

    def attn_times_f32(s, c):
        """The float32 CUDA-core kernel at (S, C) against the float32 fused
        attention with scale 1; bound at the float32 peak."""
        if attention.kernel_path(torch.float32, s, c) != "simt":
            fail(f"attention S={s} C={c} float32 is not on the CUDA cores")
        qkv = [randn(b, s, c, scale=0.3) for _ in range(3)]
        out = attention.attention(*qkv)
        heads = [t[:, None] for t in qkv]
        rel_err(F.scaled_dot_product_attention(*heads, scale=1.0)[:, 0], out,
                1e-3, "scaled_dot_product_attention float32 yardstick")
        return dict(
            ms=timed_ms(lambda: attention.attention(*qkv), inner=10),
            ms_one_launch=timed_ms(lambda: attention.attention(*qkv)),
            timing="10 launches back to back behind a matmul",
            plain_ms=timed_ms(lambda: attention.attention_plain(*qkv)),
            library_ms=timed_ms(
                lambda: F.scaled_dot_product_attention(*heads, scale=1.0),
                inner=10),
            **bound([*qkv, out], 4 * s ** 2 * c * b, "f32"))

    wide = attn_times(4096, 128)
    res["attention"] = dict(attn_times(4096, 64), s4096_c128=wide,
                            f32_s4096_c64=attn_times_f32(4096, 64),
                            f32_s4096_c128=attn_times_f32(4096, 128))
    # held but on no path: S of an odd grid (729 = 9^3: a ragged last key
    # tile and query tile) at narrow and wide C, rows peaked by a larger
    # scale; S below one tile; a C that is no multiple of 8 (CUDA cores)
    odd = max(hold_attention(s, c, dt, tol, scale)
              for s, c, scale in ((729, 16, 1.0), (729, 32, 1.0),
                                  (729, 128, 0.3), (64, 16, 1.0),
                                  (125, 64, 0.5), (300, 48, 0.5),
                                  (200, 12, 1.0))
              for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)))
    res["attention"]["max_abs_err"] = max(res["attention"]["max_abs_err"],
                                          wide["max_abs_err"], odd)

    # GroupNorm at every shape of the paths, float32 and bf16, with and
    # without SiLU, against the float32 plain form: float32 within 1e-5 of
    # the largest value (the last bits of the statistics, the fast exp of
    # the SiLU), bf16 within one bf16 rounding of each element over those
    # last bits
    gn_checked = set()
    gn_worst = 0.0
    for s_, c_ in GN_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = randn(2, s_, c_, scale=1.7, dtype=dt) + 0.4
            w, bias = randn(c_), randn(c_)
            for silu in (False, True):
                out = groupnorm.group_norm(x, w, bias, 8, 1e-5, silu=silu)
                ref = groupnorm.group_norm_plain(x.float(), w, bias, 8, 1e-5,
                                                 torch.float32, silu)
                err = (out.float() - ref).abs()
                top = ref.abs().max()
                lim = (1e-5 * top if dt == torch.float32
                       else 2 ** -8 * ref.abs() + 1e-5 * top)
                if out.dtype != dt or (err > lim).any():
                    fail(f"groupnorm S={s_} C={c_} {dt} silu={silu}: "
                         f"max|err| {err.max().item()} past its limit")
                gn_worst = max(gn_worst, (err.max() / top).item())
            gn_checked.add((s_, c_, _dtype_name(dt)))
    print(f"groupnorm: {len(GN_SHAPES)} path shapes x float32, bf16 x "
          f"SiLU or not within their limits, worst max|err| / max|ref| "
          f"{gn_worst:.3e}")

    # GroupNorm + SiLU at the paths' largest site, S 32,768 (an R-32 grid;
    # 1,024 centres of 32 neighbours), C 64, bf16, at B 8 and B 64: within
    # one bf16 rounding of the float32 form (and the last bits of its
    # statistics); the plain form, and `F.group_norm` on a channels-first
    # copy (bf16 affine, no SiLU). The bound reads x and writes the output
    # once (4 bytes an element); the two-pass design's floor reads x twice
    # (6 bytes an element)
    def gn_times(bb):
        x = randn(bb, 32768, 64, scale=1.7, dtype=torch.bfloat16)
        w, bias = randn(64), randn(64)
        out = groupnorm.group_norm(x, w, bias, 8, 1e-5, silu=True)
        ref = groupnorm.group_norm_plain(x.float(), w, bias, 8, 1e-5,
                                         torch.float32, True)
        err = (out.float() - ref).abs()
        if (err > 2 ** -8 * ref.abs() + 1e-5 * ref.abs().max()).any():
            fail(f"groupnorm B={bb}: {err.max().item()} past one bf16 "
                 f"rounding of the float32 form")
        xcf = x.transpose(1, 2).contiguous()
        wb, bb16 = w.to(torch.bfloat16), bias.to(torch.bfloat16)
        return dict(
            ms=timed_ms(lambda: groupnorm.group_norm(
                x, w, bias, 8, 1e-5, silu=True), inner=10),
            ms_one_launch=timed_ms(lambda: groupnorm.group_norm(
                x, w, bias, 8, 1e-5, silu=True)),
            ms_no_silu=timed_ms(lambda: groupnorm.group_norm(
                x, w, bias, 8, 1e-5), inner=10),
            plain_ms=timed_ms(lambda: groupnorm.group_norm_plain(
                x, w, bias, 8, 1e-5, None, True)),
            library_ms=timed_ms(lambda: F.group_norm(xcf, 8, wb, bb16, 1e-5),
                                inner=10),
            max_abs_err=err.max().item(),
            two_pass_floor_ms=6 * x.numel() / HBM_BYTES_PER_S * 1e3,
            **bound([x, out], 0, "f32"))

    res["groupnorm"] = dict(gn_times(8), b64_s32768_c64=gn_times(64),
                            timing="10 launches back to back behind a matmul")
    res["groupnorm"]["max_abs_err"] = max(res["groupnorm"]["max_abs_err"],
                                          gn_worst)
    for key, r in (("B 8", res["groupnorm"]),
                   ("B 64", res["groupnorm"]["b64_s32768_c64"])):
        print(f"groupnorm {key} S 32768 C 64 bf16 + SiLU: {r['ms']:.4f} ms "
              f"back to back ({r['bound_ms'] / r['ms']:.1%} of the bound "
              f"{r['bound_ms']:.5f} ms, {r['two_pass_floor_ms'] / r['ms']:.1%}"
              f" of the two-pass floor {r['two_pass_floor_ms']:.5f} ms), "
              f"{r['ms_one_launch']:.4f} ms one call, without SiLU "
              f"{r['ms_no_silu']:.4f} ms; plain {r['plain_ms']:.4f} ms; "
              f"F.group_norm channels-first {r['library_ms']:.4f} ms")
    res["devox"], devox_checked = check_devox(dev, randn, rel_err)
    for name, r in res.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"kernel {name}: max_abs_err {r['max_abs_err']:.3e}  "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}  bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})")
    for name in ("conv3d", "scatter_mean", "attention"):
        for key, val in res[name].items():
            if isinstance(val, dict):
                print(f"{name} {key}:", json.dumps(val))
    for name in ("interp_mm", "scatter_sum", "ball_query", "three_nn"):
        print(f"{name} by shape, ms:", json.dumps(res[name]["ms_by_shape"]))
    # the new bfloat16 times beside the recorded ones of the CUDA-core kernels
    now = {"attention": {(4096, 64): res["attention"]["ms"],
                         (4096, 128): wide["ms"]},
           "conv3d": {(390, 32, 32): res["conv3d"]["ms"],
                      (64, 64, 32): res["conv3d"]["narrow_64_64_r32"]["ms"],
                      (512, 512, 8): res["conv3d"]["bf16_512_512_r8"]["ms"]}}
    for name, shapes in PREVIOUS_MS.items():
        for shape, before in shapes.items():
            ms = now[name][shape]
            print(f"{name} {shape} bf16: {ms:.4f} ms on the tensor cores "
                  f"(CUDA-core kernel before: {before} ms, {before / ms:.1f}x)")
    # the new float32 times beside the recorded ones of the kernels they
    # replaced, and the one PyTorch call of this run
    now = {"attention": {(4096, 64): res["attention"]["f32_s4096_c64"]},
           "conv3d": {(64, 64, 32): res["conv3d"]["f32_64_64_r32"],
                      (128, 128, 9): res["conv3d"]["f32_128_128_r9"],
                      (512, 512, 8): res["conv3d"]["f32_512_512_r8"]}}
    for name, shapes in REPLACED_F32_MS.items():
        for shape, before in shapes.items():
            r = now[name][shape]
            print(f"{name} {shape} float32: {r['ms']:.4f} ms back to back, "
                  f"{r['ms_one_launch']:.4f} ms one launch, on the CUDA cores "
                  f"(before: {before} ms one launch, "
                  f"{before / r['ms_one_launch']:.2f}x; one PyTorch call "
                  f"{r['library_ms']:.4f} ms back to back; bound "
                  f"{r['bound_ms']:.5f} ms)")
    fr, sm, tn = res["fps"], res["scatter_mean"], res["three_nn"]
    # 9 instructions a pair, one a lane and clock on 132 SMs of 128 lanes,
    # at the card's highest SM clock: the floor of a distance without FMAs
    floor = 8 * 4096 * 1024 * 9 / (132 * 128 * sm_clock_mhz() * 1e6) * 1e3
    print(f"three_nn N=4096 M=1024: {tn['ms']:.4f} ms back to back; issue "
          f"floor without FMAs {floor:.5f} ms ({floor / tn['ms']:.1%}), "
          f"operations bound {tn['bound_ms']:.5f} ms "
          f"({tn['bound_ms'] / tn['ms']:.1%})")
    print("fps past the registers, one launch, ms:",
          json.dumps(fr["ms_one_launch_large_n"]))
    ss = res["scatter_sum"]["ms_by_shape"]
    im = res["interp_mm"]["ms_by_shape"]
    for key, r in im.items():
        print(f"interp_mm {key}: {r['ms']:.4f} ms back to back "
              f"({r['bound_ms'] / r['ms']:.1%} of the bound "
              f"{r['bound_ms']:.5f} ms), {r['ms_one_launch']:.4f} ms one "
              f"launch; embedding_bag {r['library_ms']:.4f} ms; host "
              f"enqueue {r['enqueue_us']:.2f} us a call")
    redesigned = {
        "fps N4096 M1024": fr,
        "scatter_mean bf16 C390 R32": sm,
        "scatter_mean f32 C64 R32 mean": sm["f32_c64_r32_mean"],
        "scatter_mean f32 C64 R32 sum": sm["f32_c64_r32_sum"],
        "ball_query N4096 M1024 r0.1": res["ball_query"],
        "three_nn N4096 M1024": res["three_nn"],
        "scatter_sum N12288 S1024 C128": ss["N12288_S1024_C128"],
        "scatter_sum N3072 S256 C256": ss["N3072_S256_C256"],
        "interp_mm N4096 M1024 C128": im["N4096_M1024_C128"],
        "interp_mm N1024 M256 C256": im["N1024_M256_C256"]}
    for key, (before, how) in BEFORE_MS.items():
        r = redesigned[key]
        now = r["ms_one_launch" if how == "one launch" else "ms"]
        print(f"{key}: {r['ms']:.4f} ms back to back, "
              f"{r['ms_one_launch']:.4f} ms one launch (before: {before} ms "
              f"{how}, {before / now:.2f}x)")
    for key, r in ss.items():
        print(f"scatter_sum {key}: {r['ms']:.4f} ms back to back, one "
              f"PyTorch call (zero_().index_add_) {r['library_ms']:.4f} ms, "
              f"{r['library_ms'] / r['ms']:.2f}x; bound {r['bound_ms']:.5f}")
    return res, {"conv3d": conv_checked, "attention": set(attns),
                 "scatter_mean": set(SITES), "groupnorm": gn_checked,
                 "devox": devox_checked}


def check_devox(dev, randn, rel_err):
    """Phase a's gated devoxelization: bit for bit the plain version at
    every shape of `DEVOX_SHAPES` and `DEVOX_MORE` (B 8 and B 64) and
    `DEVOX_EDGES`, float32 and bf16; then each shape of a forward at B 64,
    bf16, timed: -> (phase a's row, the 14 calls of a forward summed; the
    (N, C, R, dtype) held, keyed as SEEN)."""
    import torch
    import torch.nn.functional as F
    from bdm_tpu_torch import ops
    from bdm_tpu_torch.ops.cuda import devox

    def inputs(bb, n, c, r, dt):
        """Coordinates of a cloud through `normalize_coords`; a quarter of
        them whole numbers, an eighth at R - 1 along x."""
        x = ops.normalize_coords(randn(bb, n, 3, scale=0.3), r)[0]
        q = n // 4
        x[:, :q] = torch.floor(x[:, :q])
        x[:, q:q + q // 2, 0] = r - 1
        return (randn(bb, r, r, r, c, dtype=dt), x.contiguous(),
                randn(bb, c).sigmoid(), randn(bb, n, c, scale=0.5, dtype=dt))

    held = [(bb, n, c, r) for bb in (8, 64)
            for n, c, r in sorted(set(DEVOX_SHAPES + DEVOX_MORE))]
    checked = set()
    for bb, n, c, r in held + DEVOX_EDGES:
        for dt in (torch.float32, torch.bfloat16):
            args = inputs(bb, n, c, r, dt)
            if not torch.equal(devox.gated_devoxelize(*args),
                               devox.gated_devoxelize_plain(*args)):
                fail(f"devox B={bb} N={n} C={c} R={r} {dt}: not the plain "
                     f"version bit for bit")
            checked.add((n, c, r, _dtype_name(dt)))
            del args
    print(f"devox: {len(held + DEVOX_EDGES)} shapes x float32, bf16 bit "
          f"for bit")

    def times(n, c, r, b=64):
        grid, x, gate, pf = inputs(b, n, c, r, torch.bfloat16)
        out = devox.gated_devoxelize(grid, x, gate, pf)
        ids = devox.corners(x, r)[0]
        rows = sum(torch.unique(ids[i]).numel() for i in range(b))
        nbytes = ((out.numel() + pf.numel() + rows * c) * 2
                  + (x.numel() + gate.numel()) * 4)
        # F.grid_sample takes (B, C, D, H, W) and (x, y, z) locations in
        # [-1, 1] along (W, H, D): the grid's (X, Y, Z) axes as (D, H, W)
        cf = grid.permute(0, 4, 1, 2, 3).contiguous()
        loc = (x.flip(-1) / (r - 1) * 2 - 1).reshape(b, 1, 1, n, 3)
        want = devox.trilinear_devoxelize(grid, x)
        got = F.grid_sample(cf.float(), loc, align_corners=True)
        rel_err(got.reshape(b, c, n).transpose(1, 2), want, 1e-5,
                f"grid_sample yardstick N={n} C={c} R={r}")
        try:        # the library call in the grid's type where it has one
            F.grid_sample(cf, loc.to(cf.dtype), align_corners=True)
            lib_in = (cf, loc.to(cf.dtype))
        except RuntimeError:
            lib_in = (cf.float(), loc)
        return dict(
            ms=timed_ms(lambda: devox.gated_devoxelize(grid, x, gate, pf),
                        inner=10),
            ms_one_launch=timed_ms(
                lambda: devox.gated_devoxelize(grid, x, gate, pf)),
            plain_ms=timed_ms(
                lambda: devox.gated_devoxelize_plain(grid, x, gate, pf)),
            library_ms=timed_ms(lambda: F.grid_sample(
                *lib_in, align_corners=True), inner=10),
            library_dtype=_dtype_name(lib_in[0].dtype),
            grid_rows_read=rows,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")

    by_shape = {f"N{n}_C{c}_R{r}": times(n, c, r)
                for n, c, r in sorted(set(DEVOX_SHAPES))}
    row = {k: sum(by_shape[f"N{n}_C{c}_R{r}"][k]
                  for n, c, r in DEVOX_SHAPES)
           for k in ("ms", "ms_one_launch", "plain_ms", "library_ms",
                     "bound_ms")}
    for key, r in by_shape.items():
        print(f"devox B 64 {key} bf16: {r['ms']:.4f} ms back to back "
              f"({r['bound_ms'] / r['ms']:.1%} of the bound "
              f"{r['bound_ms']:.5f} ms, {r['grid_rows_read']} grid rows "
              f"read), {r['ms_one_launch']:.4f} ms one launch; plain "
              f"{r['plain_ms']:.4f} ms; F.grid_sample "
              f"({r['library_dtype']}) {r['library_ms']:.4f} ms")
    print(f"devox B 64, the 14 calls of a forward: {row['ms']:.4f} ms back "
          f"to back ({row['bound_ms'] / row['ms']:.1%} of the bound "
          f"{row['bound_ms']:.5f} ms), {row['ms_one_launch']:.4f} ms one "
          f"launch each; plain {row['plain_ms']:.4f} ms; F.grid_sample "
          f"{row['library_ms']:.4f} ms")
    return dict(row, bound_by="bytes", max_abs_err=0.0, ms_by_shape=by_shape,
                timing="B 64 bf16, the 14 calls of a PVCNN2 forward summed; "
                       "10 launches back to back behind a matmul"), checked


def check_gradients(dev):
    """Phase a': each differentiable wrapper forward through its kernel and
    backward through its own rule, against its plain version under
    PyTorch's autograd, all on the card at a shape of the training path.
    Tolerances are relative to the largest entry of the plain gradient:
    float32 1e-4 (sums in another order; PyTorch's backward of `gather`
    and `index_add_` uses atomics, whose order changes from run to run),
    bf16 1e-2 (a few bf16 roundings at other places: the plain attention
    differentiates through float32 copies, the blend's plain backward
    uses the bf16-rounded weights where the rule uses the float32 ones).
    `scatter_sum` is the blend's backward, so that comparison holds it."""
    import torch
    from bdm_tpu_torch import ops
    from bdm_tpu_torch.ops.cuda import (attention, conv3d, devox, groupnorm,
                                        interp, three_nn, voxelize)
    g = torch.Generator().manual_seed(SEED + 7)
    b = 8

    def randn(*shape, scale=1.0, dtype=torch.float32, grad=True):
        t = (torch.randn(*shape, generator=g) * scale).to(dev, dtype)
        return t.requires_grad_(grad)

    def compare(what, fn, plain, inputs, tol):
        """Backward of sum(out * cotangent) through both versions."""
        outs = []
        for f in (fn, plain):
            for t in inputs:
                t.grad = None
            out = f(*inputs)
            if not outs:
                cot = torch.randn(out.shape, generator=g).to(dev, out.dtype)
            (out.float() * cot.float()).sum().backward()
            outs.append([t.grad.clone() for t in inputs])
        worst = 0.0
        for i, (got, want) in enumerate(zip(*outs)):
            if got.dtype != want.dtype or got.shape != want.shape:
                fail(f"{what}: gradient {i} is {got.dtype} "
                     f"{tuple(got.shape)}, plain {want.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            if not (scale > 0 and err <= tol * scale):
                fail(f"{what}: gradient {i} max|err| {err} > {tol} * {scale}")
            worst = max(worst, err / scale)
        print(f"gradient {what}: max relative error {worst:.3e} "
              f"(tolerance {tol})")

    pts = randn(b, 4096, 3, scale=0.3, grad=False)
    ctx = ops.make_voxel_context(pts, 32)
    for divide in (True, False):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            compare(
                f"scatter_mean C=64 R=32 {dt} divide={divide}",
                lambda f: voxelize.scatter_mean(
                    f, ctx.order, ctx.ids_sorted, ctx.voxel_lo, 32, dt,
                    divide, ids=ctx.ids),
                lambda f: voxelize.scatter_mean_plain(
                    f, ctx.order, ctx.ids_sorted, ctx.voxel_lo, 32, dt,
                    divide),
                [randn(b, 4096, 64, dtype=dt)], tol)
    for (cin, cout, r), dt, tol in (((64, 64, 32), torch.float32, 1e-4),
                                    ((64, 64, 32), torch.bfloat16, 1e-2),
                                    ((512, 512, 8), torch.float32, 1e-4)):
        compare(f"conv3d {cin}->{cout} R={r} {dt}", conv3d.conv3d,
                conv3d.conv3d_plain,
                [randn(b, r, r, r, cin, dtype=dt),
                 randn(cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5),
                 randn(cout, scale=0.1)], tol)
    for c in (64, 128):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            compare(f"attention S=4096 C={c} {dt}", attention.attention,
                    attention.attention_plain,
                    [randn(b, 4096, c, scale=0.3, dtype=dt)
                     for _ in range(3)], tol)
    # GroupNorm's backward recomputes the normalised input from the
    # statistics the apply kernel used
    for (s, c), dt, silu, tol in (((32768, 64), torch.bfloat16, True, 1e-2),
                                  ((32768, 64), torch.float32, True, 1e-4),
                                  ((4096, 128), torch.float32, False, 1e-4),
                                  ((16, 512), torch.bfloat16, True, 1e-2)):
        compare(f"groupnorm S={s} C={c} {dt} silu={silu}",
                partial(groupnorm.group_norm, groups=8, eps=1e-5, silu=silu),
                partial(groupnorm.group_norm_plain, groups=8, eps=1e-5,
                        silu=silu),
                [randn(b, s, c, scale=1.7, dtype=dt), randn(c, scale=0.5),
                 randn(c, scale=0.5)], tol)
    # the gated devoxelization: its backward scatter-sums the corners' rows
    # in float32; the plain version runs in float32 (bf16 inputs upcast,
    # the gradients cast back once), since at bf16 it scatters its corners
    # with bf16 atomics (1.04e-2 of the largest entry at N 256, C 128, R 8)
    for (n, c, r), dt, tol in (((4096, 32, 32), torch.float32, 1e-4),
                               ((4096, 32, 32), torch.bfloat16, 1e-2),
                               ((1024, 128, 16), torch.float32, 1e-4),
                               ((256, 128, 8), torch.bfloat16, 1e-2)):
        x = ops.normalize_coords(randn(b, n, 3, scale=0.3, grad=False), r)[0]
        compare(f"gated_devoxelize N={n} C={c} R={r} {dt}",
                partial(lambda x_, *a: devox.gated_devoxelize(
                    a[0], x_, *a[1:]), x),
                partial(lambda x_, grid, gate, pf:
                        devox.gated_devoxelize_plain(grid.float(), x_, gate,
                                                     pf.float()), x),
                [randn(b, r, r, r, c, dtype=dt), randn(b, c).sigmoid()
                 .detach().requires_grad_(True),
                 randn(b, n, c, scale=0.5, dtype=dt)], tol)
    centers = ops.gather(pts, ops.furthest_point_sample(pts, 1024))
    idx, w = three_nn.three_nn(pts, centers.contiguous())
    compare("interp_mm N=4096 M=1024 C=128 bf16",
            lambda f: interp.interp_mm(idx, w, f),
            lambda f: interp.interp_mm_plain(idx, w, f),
            [randn(b, 1024, 128, dtype=torch.bfloat16)], 1e-2)


# ------------------------------------------------------------ models

class _CpuNoise:
    """Draws on the CPU from one seed and moves to `device`, so a CPU and a
    GPU run see the same numbers."""

    def __init__(self, seed, device):
        import torch
        from bdm_tpu_torch.samplers import NoiseProvider
        self.inner = NoiseProvider(seed, "cpu")
        self.device = torch.device(device)

    def initial(self, shape):
        return self.inner.initial(shape).to(self.device)

    def step(self, *args):
        return self.inner.step(*args).to(self.device)

    def mask(self, i, shape):
        return self.inner.mask(i, shape).to(self.device)

    def fuse(self, i, shape):
        return self.inner.fuse(i, shape).to(self.device)


TINY_SA = (((8, 2, 4), (16, 0.3, 8, (8, 16))),
           ((16, 2, 4), (8, 0.4, 8, (16, 32))),
           (None, (4, 0.8, 8, (32, 64))))
TINY_FP = (((32, 32), (16, 1, 4)), ((16, 16), (16, 1, 4)),
           ((16, 8), (8, 1, 4)))


def tiny_config():
    from bdm_tpu_torch.samplers import ProjectionConfig
    return ProjectionConfig(image_size=16, image_feature_model="identity",
                            raster_point_radius=0.3,
                            point_cloud_model_embed_dim=8)


def tiny_parity(dev):
    """Phase d: tiny BDM-Blending and BDM-Merging, BDM-Blending with
    `precontract`, PC2 `sample` with PNDM and PC2 `sample` (DDPM) with the
    mask, its distance transform and global features, each on the card
    (kernels) vs on the CPU (plain versions); 1e-3 absolute, as the CPU
    tests hold the port to the JAX reference. -> max|err| between BDM-B
    with and without `precontract` on the card, float32: the same sum
    reassociated, so it bounds what is not bf16 rounding in phase k."""
    import dataclasses

    import torch
    from bdm_tpu_torch.conditioning import compute_distance_transform
    from bdm_tpu_torch.samplers import (BDMMergingModel, PC2Model, PVDModel,
                                        bdm_blending, bdm_merging)
    from bdm_tpu_torch.tools.standins import camera, live_zero_convs
    sa, fp, cfg = TINY_SA, TINY_FP, tiny_config()
    outs = {k: [] for k in ("BDM-B", "BDM-M", "BDM-B precontract",
                            "PC2 PNDM", "PC2 mask + DT + global")}
    image = torch.rand(2, 16, 16, 3,
                       generator=torch.Generator().manual_seed(1))
    mask = (torch.rand(2, 16, 16, 1, generator=torch.Generator()
                       .manual_seed(2)) > 0.4).float()
    dt = torch.from_numpy(compute_distance_transform(mask.numpy()))
    for d in ("cpu", dev):
        pc2 = PC2Model(cfg, sa, fp, device=d)
        pvd = PVDModel(embed_dim=8, sa_blocks=sa, fp_blocks=fp, device=d)
        merge = BDMMergingModel(cfg, sa, fp, device=d)
        pc2.reset_parameters(SEED)
        pvd.reset_parameters(SEED + 1)
        with torch.no_grad():   # a visible head, the same on both devices
            head = pc2.backbone.classifier[2].weight
            head.copy_(torch.randn(
                head.shape, generator=torch.Generator().manual_seed(5)) * 0.1)
        merge.init_from_pretrained(pc2, pvd, seed=SEED + 2)
        live_zero_convs(merge, SEED + 3)
        batch = {"image": image.to(d),
                 "camera": camera(2, d)}
        outs["BDM-B"].append(bdm_blending(
            pc2, pvd, batch, 64, [8, 7, 5, 3, 0], 1,
            noise=_CpuNoise(SEED, d), num_inference_steps=8).cpu())
        outs["BDM-M"].append(bdm_merging(
            merge, pc2, pvd, batch, 64, [8, 6, 4, 2, 0], 2,
            noise=_CpuNoise(SEED, d), num_inference_steps=8).cpu())
        pre = PC2Model(dataclasses.replace(cfg, precontract=True), sa, fp,
                       device=d)
        pre.load_state_dict(pc2.state_dict())
        outs["BDM-B precontract"].append(bdm_blending(
            pre, pvd, batch, 64, [8, 7, 5, 3, 0], 1,
            noise=_CpuNoise(SEED, d), num_inference_steps=8).cpu())
        outs["PC2 PNDM"].append(pc2.sample(
            batch, 64, noise=_CpuNoise(SEED, d), scheduler="pndm",
            num_inference_steps=8).cpu())
        opt = PC2Model(dataclasses.replace(
            cfg, use_mask=True, use_distance_transform=True,
            use_global_features=True), sa, fp, device=d)
        opt.reset_parameters(SEED)
        with torch.no_grad():
            head = opt.backbone.classifier[2].weight
            head.copy_(torch.randn(
                head.shape, generator=torch.Generator().manual_seed(5)) * 0.1)
        outs["PC2 mask + DT + global"].append(opt.sample(
            dict(batch, mask=mask.to(d), distance_transform=dt.to(d)), 64,
            noise=_CpuNoise(SEED, d), num_inference_steps=8).cpu())
    for name, (cpu, card) in outs.items():
        err = (cpu - card).abs().max().item()
        print(f"tiny {name}, kernels vs CPU plain: max|err| {err:.3e}")
        if not (torch.isfinite(card).all() and err < 1e-3):
            fail(f"tiny {name} on the card differs from the CPU run: {err}")
    pre_err = (outs["BDM-B precontract"][1] - outs["BDM-B"][1]).abs().max()
    print(f"tiny BDM-B float32 on the card, precontract vs not: max|err| "
          f"{pre_err.item():.3e}")
    if not pre_err < 1e-3:
        fail(f"tiny BDM-B with precontract differs from without: {pre_err}")
    return pre_err.item()


def tiny_training(dev):
    """Phase f: three training steps of a tiny PC2 (a visible head, dropout
    0) on the card through the kernels against the same steps on the CPU
    through the plain versions: same weights, batch, timesteps and noise.
    Losses within 1e-3 relative (float32 sums in another order through
    three optimizer steps)."""
    import torch
    from bdm_tpu_torch.samplers import PC2Model, TrainNoise
    from bdm_tpu_torch.tools.standins import training_batches
    from bdm_tpu_torch.train import (create_train_state, make_optimizer,
                                     make_train_step, pc2_freeze_mask)
    g = torch.Generator().manual_seed(SEED + 6)
    draws = [(torch.randint(0, 1000, (2,), generator=g),
              torch.randn(2, 64, 3, generator=g)) for _ in range(3)]
    losses = []
    for d in ("cpu", dev):
        pc2 = PC2Model(tiny_config(), TINY_SA, TINY_FP, device=d, dropout=0.0)
        pc2.reset_parameters(SEED)
        with torch.no_grad():
            head = pc2.backbone.classifier[2].weight
            head.copy_(torch.randn(
                head.shape, generator=torch.Generator().manual_seed(5)) * 0.1)
        state = create_train_state(
            pc2, make_optimizer(pc2_freeze_mask(pc2)), use_ema=True)
        step = make_train_step(pc2.loss)
        noise = TrainNoise(device=d, replay=draws)
        batches = training_batches(SEED + 1, 2, 64, d, image_size=16)
        losses.append([float(step(state, next(batches), noise)["loss"])
                       for _ in range(3)])
    print(f"tiny PC2 training, losses on the CPU {losses[0]}, on the card "
          f"{losses[1]}")
    for cpu, card in zip(*losses):
        if not abs(cpu - card) <= 1e-3 * abs(cpu):
            fail(f"tiny training on the card differs from the CPU: "
                 f"{losses}")


def forwards(pc2, merge, dev):
    """Phase b: one PC2 denoise step and one fusion forward, B=8, N=4096,
    bf16: host clock around a synchronised call, median after warm-up, and
    the kernel launches of one call."""
    import torch
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.tools.standins import camera
    g = torch.Generator().manual_seed(SEED + 2)
    b, n = 8, 4096
    image = torch.rand(b, 224, 224, 3, generator=g).to(dev)
    cond = pc2.prepare_cond(pc2.conditioning_map(image))
    cam = camera(b, dev)
    x = (torch.randn(b, n, 3, generator=g) * 0.3).to(dev)
    prior = (torch.randn(b, n, 3, generator=g) * 0.3).to(dev)
    t = torch.full((b,), 500, dtype=torch.long, device=dev)
    calls = {
        "pc2_forward": lambda: pc2.denoise(x, t, cam, cond),
        "fusion_forward": lambda: merge.predict(x, prior, 500, cam, cond,
                                                "fusion_nstep"),
    }
    out = {}
    for name, call in calls.items():
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with torch.inference_mode():
                eps = call()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if eps.shape != (b, n, 3) or not torch.isfinite(eps).all():
            fail(f"{name} output {tuple(eps.shape)} not finite")
        ms = statistics.median(times[1:]) * 1e3
        launches = check_path(name, kernels.counts(), kernels.path_counts(),
                              ("scatter_sum",), samples=name == "pc2_forward")
        print(f"{name} B={b} N={n} bf16: {ms:.2f} ms (median of "
              f"{len(times) - 1} after warm-up); launches "
              f"{json.dumps(launches)}")
        out[name] = dict(ms=ms, launches=launches)
    out["pc2_backbone"] = eager_and_replayed(pc2.backbone, dev)
    return out


def eager_and_replayed(net, dev, reps=10):
    """PC2's PVCNN2 forward at B 8 and B 64, N 4096, bf16, on seeded
    inputs of its 390 channels, run eagerly (`_forward`) and replayed from
    its CUDA graph, in turns: the wall of `reps` forwards back to back,
    synchronised, a forward, median of 6; the replayed output bit for bit
    the eager one. -> {B: {"eager_ms", "replayed_ms"}}."""
    import torch
    out = {}
    g = torch.Generator().manual_seed(SEED + 4)
    for b in (8, 64):
        x_in = torch.cat([torch.randn(b, 4096, 3, generator=g) * 0.3,
                          torch.randn(b, 4096, 387, generator=g)], -1).to(dev)
        t = torch.full((b,), 500, dtype=torch.long, device=dev)
        with torch.inference_mode():
            runs = {"eager_ms": lambda: net._forward(x_in, t, None),
                    "replayed_ms": lambda: net(x_in, t)}
            net(x_in, t)                    # eager, then captured
            if not torch.equal(net(x_in, t), net._forward(x_in, t, None)):
                fail(f"the B {b} PVCNN2 replay differs from its eager forward")
            walls = {k: [] for k in runs}
            for _ in range(3):
                for k in ("eager_ms", "replayed_ms", "replayed_ms",
                          "eager_ms"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        runs[k]()
                    torch.cuda.synchronize()
                    walls[k].append((time.perf_counter() - t0) / reps * 1e3)
        out[b] = {k: statistics.median(v) for k, v in walls.items()}
        print(f"PC2 PVCNN2 forward B={b} N=4096 bf16: eager "
              f"{out[b]['eager_ms']:.3f} ms, replayed "
              f"{out[b]['replayed_ms']:.3f} ms a forward ({reps} back to "
              f"back, median of 6 in turns); bit for bit equal")
    return out


def sampler_path(name, run, milestones, roll_step, dev):
    """Phases c, e and k: one sampler end to end at full width, B=2,
    N=4096, 50 DDPM steps; returns the launch counts, the wall time and
    the cloud."""
    import torch
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.samplers import NoiseProvider
    from bdm_tpu_torch.tools.standins import camera
    b, n = 2, 4096
    g = torch.Generator().manual_seed(SEED + 3)
    batch = {"image": torch.rand(b, 224, 224, 3, generator=g).to(dev),
             "camera": camera(b, dev)}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = run(batch, n, milestones, roll_step, noise=NoiseProvider(SEED),
              num_inference_steps=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, paths = kernels.counts(), kernels.path_counts()
    print(f"{name} B={b} N={n} bf16, 50 steps, milestones {milestones}, "
          f"roll {roll_step}: {wall:.2f} s wall")
    print("launch counts (kernel, plain on CUDA):", json.dumps(counts),
          "by kernel:", json.dumps(paths), "conv3d weight packs:",
          kernels.tally()["conv3d", "packs"])
    if out.shape != (b, n, 3) or not torch.isfinite(out).all():
        fail(f"{name} output {tuple(out.shape)} not finite")
    # sampling differentiates nothing: the blend's backward kernel rests
    return (check_path(name, counts, paths, ("scatter_sum",), samples=True),
            wall, out)


def single_model_sampling(pc2, pvd, dev):
    """Phase i: `PC2Model.sample` at full width, B=2, N=4096, bf16, with
    DDPM 50 steps, DDIM 50 steps at eta 0.5 keeping the cloud every 10
    steps, and PNDM 50 inference steps (59 forwards); `PVDModel.sample`
    over a 50-step chain, fixedsmall and fixedlarge (PVD's weights).
    -> {path: {"wall_s", "launches"}}."""
    import torch
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.samplers import NoiseProvider, PVDModel
    from bdm_tpu_torch.tools.standins import camera
    b, n = 2, 4096
    g = torch.Generator().manual_seed(SEED + 11)
    batch = {"image": torch.rand(b, 224, 224, 3, generator=g).to(dev),
             "camera": camera(b, dev)}
    runs = {
        "pc2_sample_ddpm": partial(pc2.sample, batch, n, scheduler="ddpm"),
        "pc2_sample_ddim_eta_0.5_every_10": partial(
            pc2.sample, batch, n, scheduler="ddim", eta=0.5,
            return_sample_every_n_steps=10),
        "pc2_sample_pndm": partial(pc2.sample, batch, n, scheduler="pndm")}
    for var in ("fixedsmall", "fixedlarge"):
        short = PVDModel(num_timesteps=50, model_var_type=var,
                         mixed_precision="bf16")
        short.load_state_dict(pvd.state_dict())
        runs[f"pvd_sample_{var}"] = partial(short.sample, (b, n, 3))
    out = {}
    for name, run in runs.items():
        kw = {} if name.startswith("pvd") else {"num_inference_steps": 50}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        cloud = run(noise=NoiseProvider(SEED), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        evo = None
        if isinstance(cloud, tuple):
            cloud, evo = cloud
            if evo.shape != (b, 5, n, 3) or not torch.isfinite(evo).all():
                fail(f"{name}: evolutions {tuple(evo.shape)} not finite")
        if cloud.shape != (b, n, 3) or not torch.isfinite(cloud).all():
            fail(f"{name} output {tuple(cloud.shape)} not finite")
        launches = check_path(name, kernels.counts(), kernels.path_counts(),
                              ("scatter_sum",), samples=True)
        print(f"{name} B={b} N={n} bf16: {wall:.2f} s wall; launches "
              f"{json.dumps(launches)}")
        out[name] = dict(wall_s=wall, launches=launches)
    return out


# Phase j's options, one PC2 each
OPTIONS = {
    "mask_dt": dict(use_mask=True, use_distance_transform=True),
    "global_cls": dict(use_global_features=True),
    "nearest": dict(raster_splat="nearest"),
    "custom_betas": dict(beta_schedule="custom"),
    "pvcnnplusplus": dict(point_cloud_model="pvcnnplusplus"),
    "simple": dict(point_cloud_model="simple"),
}


def option_steps(dev):
    """Phase j: one denoise and DDPM step of PC2 at full width, B=8,
    N=4096, bf16, for each of `OPTIONS` (the mask, a disc, and its
    distance transform from the host in the batch); host clock around the
    second, synchronised. The simple backbone runs no kernel: its path
    must launch none, and it is held for finite output only.
    -> {option: {"ms", "launches"}}."""
    import torch
    from bdm_tpu_torch.conditioning import compute_distance_transform
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig
    from bdm_tpu_torch.tools.standins import camera
    b, n = 8, 4096
    g = torch.Generator().manual_seed(SEED + 12)
    yy, xx = torch.meshgrid(torch.arange(224.0), torch.arange(224.0),
                            indexing="ij")
    mask = ((yy - 112) ** 2 + (xx - 100) ** 2 < 70 ** 2).float()
    mask = mask[None, ..., None].expand(b, 224, 224, 1).contiguous()
    batch = {"image": torch.rand(b, 224, 224, 3, generator=g).to(dev),
             "camera": camera(b, dev), "mask": mask.to(dev),
             "distance_transform": torch.from_numpy(
                 compute_distance_transform(mask.numpy())).to(dev)}
    x = (torch.randn(b, n, 3, generator=g) * 0.3).to(dev)
    z = torch.randn(b, n, 3, generator=g).to(dev)
    t = torch.full((b,), 500, dtype=torch.long, device=dev)
    out = {}
    for name, kw in OPTIONS.items():
        pc2 = PC2Model(ProjectionConfig(mixed_precision="bf16", **kw))
        pc2.reset_parameters(SEED)

        def step():
            cond = pc2.prepare_cond(pc2.batch_conditioning(batch))
            eps = pc2.denoise(x, t, batch["camera"], cond)
            return pc2.schedulers["ddpm"].step(eps, 500, x, z)

        with torch.inference_mode():
            step()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            x_prev = step()
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if x_prev.shape != (b, n, 3) or not torch.isfinite(x_prev).all():
            fail(f"option {name}: output {tuple(x_prev.shape)} not finite")
        unused = (tuple(kernels.KERNELS) if name == "simple"
                  else ("scatter_sum",))
        launches = check_path(f"option {name}", kernels.counts(),
                              kernels.path_counts(), unused,
                              samples=name != "simple")
        note = (" (the simple backbone runs no kernel: held for finite "
                "output only)" if name == "simple" else "")
        print(f"option {name} (in {pc2.in_channels} channels) B={b} N={n} "
              f"bf16, conditioning + denoise + DDPM step: {ms:.2f} ms; "
              f"launches {json.dumps(launches)}{note}")
        out[name] = dict(ms=ms, launches=launches)
        del pc2
        torch.cuda.empty_cache()
    return out


def chamfer(a, b):
    """Per cloud: mean squared distance to the nearest point of the other
    cloud, both ways, summed."""
    import torch
    d2 = torch.cdist(a.float(), b.float()).square()
    return d2.min(2).values.mean(1) + d2.min(1).values.mean(1)


def precontract_ab(pc2, pvd, plain_cloud, tiny_f32_err, dev):
    """Phase k: PC2 with `precontract` (the production weights) against
    without. BDM-Blending as phase c (same batch, weights and noise): the
    two clouds within Chamfer 5e-3, the bound `tests/test_bf16_bound.py`
    holds bf16 BDM-B to against its float32 twin; the algebra is exact
    (phase d's float32 tiny runs agree within 1e-3, eight steps of float32
    sums in another order), so what remains is
    bf16 rounding at other places. Then one denoise step at B=8, N=4096,
    bf16, both ways, in turns (plain, precontract, precontract, plain):
    the precontracted eps no further from the float32 step's (the same
    weights at float32, plain) than twice the plain bf16 eps is, relative
    to the largest entry; the stage-0 conv each way (CUDA
    events, 10 calls back to back behind a matmul): voxelize + conv3d
    390 -> 32 against the x_t taps + the tap scatter at C 864 +
    `tap_shift_sum`; the step's device time (`torch.profiler`, kernel
    sum; and CUDA events around one step); `precontract_cond` once a
    trajectory (CUDA events); the peak memory of a step."""
    import torch
    from bdm_tpu_torch import ops
    from bdm_tpu_torch.samplers import (PC2Model, ProjectionConfig,
                                        bdm_blending)
    from bdm_tpu_torch.tools.profile_step import breakdown
    from bdm_tpu_torch.tools.standins import camera
    pre = PC2Model(ProjectionConfig(mixed_precision="bf16", precontract=True))
    pre.load_state_dict(pc2.state_dict())
    launches, wall, cloud = sampler_path(
        "BDM-B precontract", partial(bdm_blending, pre, pvd),
        [50, 48, 46, 44, 6, 4, 2, 0], 1, dev)
    cd = chamfer(cloud, plain_cloud).max().item()
    paired = (cloud - plain_cloud).abs().max().item()
    print(f"BDM-B bf16 precontract vs not: Chamfer {cd:.3e}, paired "
          f"max|d| {paired:.3e}, cloud scale "
          f"{plain_cloud.abs().max().item():.3f}; float32 tiny "
          f"{tiny_f32_err:.3e}")
    if not cd < 5e-3:
        fail(f"BDM-B with precontract: Chamfer {cd} against without")
    out = dict(bdm_b=dict(wall_s=wall, launches=launches, chamfer=cd,
                          paired_max_abs=paired, tiny_f32_err=tiny_f32_err))

    b, n = 8, 4096
    g = torch.Generator().manual_seed(SEED + 13)
    image = torch.rand(b, 224, 224, 3, generator=g).to(dev)
    cam = camera(b, dev)
    x = (torch.randn(b, n, 3, generator=g) * 0.3).to(dev)
    t = torch.full((b,), 500, dtype=torch.long, device=dev)
    bf16 = torch.bfloat16
    with torch.inference_mode():
        raw = pc2.conditioning_map(image)
        cond = pc2.prepare_cond(raw)
        pcond = pre.precontract_cond(raw)
        out["precontract_cond_ms"] = timed_ms(
            lambda: pre.precontract_cond(raw), reps=3, warmup=1)
        size = {"plain": cond.numel() * cond.element_size(),
                "precontract": sum(v.numel() * v.element_size()
                                   for v in pcond if v is not None)}
        f32 = PC2Model(ProjectionConfig())
        f32.load_state_dict(pc2.state_dict())
        want = f32.denoise(x, t, cam, f32.prepare_cond(raw))
        del f32, raw
        eps = {"plain": pc2.denoise(x, t, cam, cond),
               "precontract": pre.denoise(x, t, cam, pcond)}
        err = {k: ((v - want).abs().max() / want.abs().max()).item()
               for k, v in eps.items()}
        err["precontract_vs_plain"] = (
            (eps["precontract"] - eps["plain"]).abs().max()
            / want.abs().max()).item()
        print(f"denoise B={b} bf16 against float32, max|err| of the "
              f"largest eps: {json.dumps(err)}")
        if not err["precontract"] <= 2 * err["plain"]:
            fail(f"precontracted bf16 denoise is further from float32 than "
                 f"twice the plain bf16 one: {err}")
        # stage 0's first conv each way, on this step's inputs
        pv0 = pc2.backbone.sa_layers[0][0]
        conv0, r = pv0.voxel_layers[0], pv0.resolution
        cout = conv0.weight.shape[0]
        ctx = ops.make_voxel_context(x, r)
        x_in = pc2.x_t_input(x, cam, cond).to(bf16)
        p_in, tap = pre._precontracted_input(x, cam, pcond)
        tap, xt = tap.contiguous(), p_in[..., :3].to(bf16)
        grid = ops.scatter_mean_contributions(tap, ctx, r).reshape(
            (b,) + (r,) * 3 + (27 * cout,))
        vox = ops.avg_voxelize(x_in, ctx, r, bf16)
        parts = {
            "plain": lambda: conv0(ops.avg_voxelize(x_in, ctx, r, bf16)),
            "precontract": lambda: conv0.forward_pre_tap(tap, xt, ctx, r,
                                                         bf16),
            "plain_voxelize": lambda: ops.avg_voxelize(x_in, ctx, r, bf16),
            "plain_conv3d": lambda: conv0(vox),
            "precontract_tap_scatter": lambda: ops.scatter_mean_contributions(
                tap, ctx, r),
            "precontract_tap_shift_sum": lambda: ops.tap_shift_sum(grid,
                                                                   cout)}
        stage0 = {k: [] for k in parts}
        step = {k: [] for k in eps}
        events = {k: [] for k in eps}
        calls = {"plain": lambda: pc2.denoise(x, t, cam, cond),
                 "precontract": lambda: pre.denoise(x, t, cam, pcond)}
        for way in ("plain", "precontract", "precontract", "plain"):
            for k in parts:
                if k.startswith(way):
                    stage0[k].append(timed_ms(parts[k], inner=10))
            prof = breakdown(calls[way])
            step[way].append(prof)
            events[way].append(timed_ms(calls[way]))
        peak = {}
        for way, call in calls.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            call()
            torch.cuda.synchronize()
            peak[way] = dict(peak_gib=torch.cuda.max_memory_allocated()
                             / 2 ** 30,
                             step_gib=(torch.cuda.max_memory_allocated()
                                       - base) / 2 ** 30,
                             cond_gib=size[way] / 2 ** 30)
    out.update(
        stage0_ms={k: v for k, v in stage0.items()},
        step_device_ms={k: [p["device_ms"] for p in v]
                        for k, v in step.items()},
        step_wall_under_profiler_ms={k: [p["wall_ms"] for p in v]
                                     for k, v in step.items()},
        step_kernels_ms={k: v[0]["ms"] for k, v in step.items()},
        step_event_ms=events, memory=peak, eps_rel_err_vs_f32=err)
    print("precontract A/B, B=8 N=4096 bf16:", json.dumps(out))
    del pre
    torch.cuda.empty_cache()
    return out


def reset_counts():
    """Zero the kernel and CUDA graph counters at a path's start."""
    from bdm_tpu_torch.models import graphs
    from bdm_tpu_torch.ops import cuda as kernels
    kernels.reset_counts()
    graphs.reset_counts()


GRAPHS = {}     # path -> its CUDA graph captures and replays


def check_path(name, counts, paths, unused=(), float32=False,
               samples=False, here=True):
    """Every kernel launched on the path but those in `unused`, which
    launched no time; no plain version ran on the card; every launch of
    attention and conv3d took the tensor-core kernel (on a float32 path the
    CUDA-core one: the rule of `kernel_path` names no other shape), as the
    bench checks its path (`bench.check_launches`). A path run in this
    process (`here`; not a spawned rank's counts) notes its graph captures
    and replays in GRAPHS, and a sampling path (`samples`) fails unless
    its PVCNN2 forwards replayed. -> the launches, those two kernels' also
    by kernel ("conv3d_wgmma", ...)."""
    from bdm_tpu_torch.bench import check_launches
    from bdm_tpu_torch.models import graphs
    if here:
        GRAPHS[name] = graphs.counts()
        if samples and not graphs.graph_replays:
            fail(f"the {name} path replayed no forward: {GRAPHS[name]}")
    try:
        return check_launches(counts, paths, set(counts) - set(unused),
                              float32)
    except AssertionError as e:
        fail(f"the {name} path: {e}")


def run_training(name, model, loss_fn, batches, noise, steps):
    """`steps` steps of `train_loop` with the reference optimizer (AdamW
    lr 1e-3, betas (0.95, 0.999), weight decay 1e-6, clip 50) and the EMA;
    -> ((launch counts, those by kernel), losses, median step ms after the
    first step, peak GiB, the state)."""
    import torch
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.train import (create_train_state, make_optimizer,
                                     train_loop)
    state = create_train_state(model, make_optimizer(model), use_ema=True,
                               ema_update_every=2)
    marks, losses = [], []

    def clock(step, state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses.append(float(metrics["loss"]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    marks.append(time.perf_counter())
    train_loop(state, loss_fn, batches, steps, noise, callbacks=[clock],
               log_step_freq=1, print_freq=10 ** 9)
    counts = kernels.counts(), kernels.path_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    ms = statistics.median(step_ms[1:]) if steps > 1 else step_ms[0]
    print(f"{name}: {steps} steps, losses {losses}, step ms {step_ms} "
          f"(median after the first {ms:.2f}), peak memory {peak:.3f} GiB")
    print("launch counts (kernel, plain on CUDA):", json.dumps(counts[0]),
          "by kernel:", json.dumps(counts[1]))
    if state.step != steps or not all(x == x and abs(x) < 1e30
                                      for x in losses):
        fail(f"{name}: losses {losses} after {state.step} steps")
    if all(torch.equal(e, p.detach()) for e, p in zip(
            state.ema.values(), model.parameters()) if p.requires_grad):
        fail(f"{name}: the EMA equals the trained parameters")
    return counts, losses, ms, peak, state


def watch_gates(model):
    """-> {module name: 0-d bool tensor}, refreshed at every forward that
    builds a graph: whether the ReLU of that squeeze-excitation gate was
    dead, that is, no hidden unit was positive for any sample (the
    pre-activation recomputed as `SE.forward` computes it). Behind a dead
    ReLU both matrices of the gate have a gradient of exactly zero."""
    import torch
    import torch.nn.functional as F
    from bdm_tpu_torch.models.layers import SE
    dead = {}

    def note(name, gate, args, out):
        if torch.is_grad_enabled():
            dt = gate.dtype or torch.float32
            with torch.no_grad():
                s = args[0].float().mean(dim=(1, 2, 3)).to(dt)
                dead[name] = (F.linear(s, gate.fc[0].weight.to(dt)) <= 0).all()

    for name, module in model.named_modules():
        if isinstance(module, SE):
            module.register_forward_hook(partial(note, name))
    return dead


def check_gradients_reached(name, model, dead):
    """Every trainable parameter has a finite, non-zero gradient after the
    last step, but for the matrices of a squeeze-excitation gate whose
    ReLU `watch_gates` saw dead in that step; -> how many those are."""
    import torch
    behind_dead = 0
    for k, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if p.grad is None or not torch.isfinite(p.grad).all():
            fail(f"{name}: no finite gradient for {k}")
        if not p.grad.abs().sum() > 0:
            gate = k.rsplit(".fc.", 1)[0]
            if not (gate in dead and bool(dead[gate])):
                fail(f"{name}: zero gradient for {k}")
            behind_dead += 1
    print(f"{name}: every trainable parameter has a non-zero gradient, but "
          f"{behind_dead} matrices of squeeze-excitation gates whose ReLU "
          f"was dead in that step ({sum(bool(d) for d in dead.values())} "
          f"of {len(dead)} gates)")
    return behind_dead


def pc2_training(dev, mixed_precision, steps=4):
    """Phase g: PC2 at production widths, B=8, N=4096, `steps` steps of
    `train_loop` on one repeated batch with one repeated draw of timesteps
    and noise, so the loss of that batch must fall. Float32 takes the
    gather form of the blend (no `interp_mm`); at bf16 compute every kernel
    launches. `scatter_sum` runs once a PVConv a step (the devoxelization's
    backward) and, at bf16, twice more (the backward of the two bf16 FP
    stages)."""
    import itertools

    import torch
    from bdm_tpu_torch.samplers import (PC2Model, ProjectionConfig,
                                        TrainNoise)
    from bdm_tpu_torch.tools.standins import training_batches
    from bdm_tpu_torch.train import pc2_freeze_mask
    name = f"PC2 training {mixed_precision}"
    b, n = 8, 4096
    pc2 = PC2Model(ProjectionConfig(mixed_precision=mixed_precision))
    pc2.reset_parameters(SEED)
    pc2_freeze_mask(pc2)
    dead = watch_gates(pc2)
    vit = {k: v.clone() for k, v in pc2.feature_model.state_dict().items()}
    g = torch.Generator().manual_seed(SEED + 8)
    draw = (torch.randint(0, 1000, (b,), generator=g),
            torch.randn(b, n, 3, generator=g))
    noise = TrainNoise(device=dev, replay=itertools.repeat(draw))
    batches = training_batches(SEED + 5, b, n, dev, repeat=True)
    batch = next(batches)
    if mixed_precision == "no":
        dropout_determinism(pc2, batch, draw, dev)
    with torch.no_grad():
        before = float(pc2.loss(batch, noise))
    counts, losses, ms, peak, state = run_training(
        name, pc2, pc2.loss, batches, noise, steps)
    with torch.no_grad():
        after = float(pc2.loss(batch, noise))
    print(f"{name}: loss of the repeated batch without dropout {before} -> "
          f"{after}")
    if not after < before:
        fail(f"{name}: the loss of the repeated batch did not fall")
    behind_dead = check_gradients_reached(name, pc2, dead)
    for k, v in pc2.feature_model.state_dict().items():
        if not torch.equal(v, vit[k]):
            fail(f"{name}: the frozen feature model moved at {k}")
    f32 = mixed_precision == "no"
    launches = check_path(name, *counts, ("interp_mm",) if f32 else (), f32)
    if launches["scatter_sum"] != (DEVOX_A_FORWARD + 2 * (not f32)) * steps:
        fail(f"{name}: scatter_sum launched {launches['scatter_sum']} times "
             f"in {steps} steps")
    print(f"{name}: launches a step",
          json.dumps({k: v / steps for k, v in launches.items()}))
    return dict(launches=launches, step_ms=ms, peak_gib=peak, losses=losses,
                zero_gradients_behind_dead_gates=behind_dead)


def dropout_determinism(pc2, batch, draw, dev):
    """Three evaluations of the loss in training mode (dropout p = 0.1),
    with the same timesteps and noise and the masks from `TrainNoise`'s
    seed: 1, 1, 2. The first two agree within 1e-6 relative, the third
    differs. The head is made visible for them (under PC2's 1e-6 head the
    masks move the loss by less than a float32 ulp) and restored after."""
    import torch
    from bdm_tpu_torch.samplers import TrainNoise
    head = pc2.backbone.classifier[2].weight
    kept = head.detach().clone()
    pc2.train()
    try:
        with torch.no_grad():
            head.copy_(torch.randn(head.shape, generator=torch.Generator()
                                   .manual_seed(5)).to(dev) * 0.1)
            losses = [float(pc2.loss(batch, TrainNoise(seed, dev,
                                                       replay=[draw])))
                      for seed in (1, 1, 2)]
    finally:
        pc2.eval()
        with torch.no_grad():
            head.copy_(kept)
    print(f"PC2 float32 loss with dropout 0.1, TrainNoise seeds 1, 1, 2: "
          f"{losses}")
    if not abs(losses[0] - losses[1]) <= 1e-6 * abs(losses[0]):
        fail(f"dropout: one seed gave two losses {losses[:2]}")
    if losses[2] == losses[0]:
        fail(f"dropout: seeds 1 and 2 gave the same loss {losses[0]}")


def wide_and_fusion_training(merge, dev):
    """Phase h: PVD at twice the width, B=4, N=2048, float32, two steps
    (the conv shapes noted must hold its Cin 512 -> 512 at R=8, unpadded);
    then one step of the fusion network's loss at production widths, B=2,
    N=4096, bf16, the feature model and both towers frozen."""
    import itertools

    import torch
    from bdm_tpu_torch.samplers import PVDModel, TrainNoise
    from bdm_tpu_torch.tools.standins import training_batches
    from bdm_tpu_torch.train import fusion_freeze_mask
    pvd = PVDModel(width_multiplier=2)
    pvd.reset_parameters(SEED + 1)
    dead = watch_gates(pvd)
    before = {k: set(v) for k, v in SEEN.items()}
    counts, _, ms, peak, _ = run_training(
        "PVD x2 training float32", pvd,
        lambda batch, noise: pvd.loss(batch["points"], noise),
        training_batches(SEED + 9, 4, 2048, dev, image_size=16),
        TrainNoise(SEED, dev), 2)
    print("PVD x2 shapes no earlier path had:", json.dumps(
        {k: sorted(v - before[k]) for k, v in SEEN.items()}))
    if (512, 512, 8) not in {k[:3] for k in SEEN["conv3d"] - before["conv3d"]}:
        fail("PVD x2 never ran its 512 -> 512 conv at R=8")
    if (4096, 128) not in SEEN["attention"]:
        fail("PVD x2 never ran its attention at C=128")
    behind_dead = check_gradients_reached("PVD x2", pvd, dead)
    out = {"pvd_x2": dict(
        launches=check_path("PVD x2", *counts, ("interp_mm",), float32=True),
        step_ms=ms, peak_gib=peak,
        zero_gradients_behind_dead_gates=behind_dead)}
    del pvd

    fusion_freeze_mask(merge)
    frozen = {k: p.detach().clone() for k, p in merge.named_parameters()
              if not p.requires_grad}
    moving = {k: p.detach().clone() for k, p in merge.named_parameters()
              if p.requires_grad}
    counts, _, ms, peak, _ = run_training(
        "fusion training bf16", merge, merge.loss,
        training_batches(SEED + 10, 2, 4096, dev), TrainNoise(SEED + 1, dev),
        1)
    params = dict(merge.named_parameters())
    if not any("pvd_model_sa_layers" in k for k in frozen) or not all(
            torch.equal(params[k], v) for k, v in frozen.items()):
        fail("fusion training moved a frozen tower")
    moved = sum(not torch.equal(params[k], v) for k, v in moving.items())
    print(f"fusion training: {len(frozen)} frozen tensors unchanged, "
          f"{moved} of {len(moving)} trainable tensors moved")
    if moved == 0:
        fail("fusion training moved nothing")
    out["fusion"] = dict(launches=check_path("fusion training", *counts),
                         step_ms=ms, peak_gib=peak)
    return out


# ------------------------------------------------------------ phase l

# Phase l's CLI runs: synthetic data at production widths, B=2, N=4096,
# bf16 (the config's default), 50 DDPM steps; BDM-B with phase c's
# milestones, BDM-M with phase e's
CLI_ARGS = ["dataset=synthetic", "dataset.max_points=4096",
            "dataloader.batch_size=2", "run.num_sample_batches=1",
            "run.num_inference_steps=50", "logging.wandb=false"]
CLI_TRAIN = ["run.print_step_freq=1", "run.log_step_freq=1",
             "run.checkpoint_freq=2", "run.vis_freq=0"]
CLI_BLEND = ["aux_run.milestones=[50,48,46,44,6,4,2,0]", "aux_run.roll_step=1"]
CLI_MERGE = ["aux_run.milestones=[50,46,42,38,12,8,4,0]",
             "aux_run.roll_step=2"]


class PartTimes:
    """Wall time of named functions of a module while a CLI runs (those the
    module has): each is wrapped so its calls are timed between
    `torch.cuda.synchronize()`s; a part called inside another counts in
    both."""

    def __init__(self, module, names):
        self.module, self.names, self.s = module, names, {}

    def __enter__(self):
        import torch
        self.kept = {n: getattr(self.module, n) for n in self.names
                     if hasattr(self.module, n)}
        for name, fn in self.kept.items():
            def timed(*args, _fn=fn, _name=name, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.s[_name] = self.s.get(_name, 0.0) + (
                    time.perf_counter() - t0)
                return out
            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.kept.items():
            setattr(self.module, name, fn)


def cli_run(name, main, argv, parts, plys=0, unused=()):
    """One CLI job on the card through `main(argv)`: its wall, the wall of
    its parts (`parts`: (module, function names)), the kernel launches
    (`check_path`) and, when it samples, `plys` finite pred clouds of
    N=4096 beside as many gt clouds. -> (launches, wall s, parts s)."""
    import torch
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.utils import read_ply
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with PartTimes(*parts) as timer:
        main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, paths = kernels.counts(), kernels.path_counts()
    parts_s = {k: round(v, 4) for k, v in timer.s.items()}
    print(f"{name}: {wall:.2f} s wall; parts {json.dumps(parts_s)}")
    print("launch counts (kernel, plain on CUDA):", json.dumps(counts),
          "by kernel:", json.dumps(paths))
    if plys:
        opt = dict(a.split("=", 1) for a in argv)
        run_dir = Path(opt["run.save_dir"]) / opt["run.name"]
        found = {w: sorted(run_dir.glob(f"*/{w}/*/*.ply"))
                 for w in ("pred", "gt")}
        if [len(v) for v in found.values()] != [plys, plys]:
            fail(f"{name}: {[len(v) for v in found.values()]} pred / gt "
                 f".ply files, expected {plys} each")
        for path in found["pred"]:
            pts = read_ply(str(path))
            if pts.shape != (4096, 3) or not (pts == pts).all() or (
                    abs(pts) == float("inf")).any():
                fail(f"{name}: {path.name} is {pts.shape}, not finite")
    return (check_path(name, counts, paths, unused, samples=plys > 0),
            wall, parts_s)


def cli_paths(dev):
    """Phase l: the three CLIs on the card as a user runs them, in a
    temporary directory: BDM-B sampling; BDM-M fusion training for 2
    steps, then sampling from its `checkpoint-latest.pt`; PC2 training for
    2 steps (EMA every step, one validation loss at step 2), then DDPM
    sampling from that checkpoint's EMA weights. Then the evaluation CLI
    on the BDM-B clouds on the card against `evaluate_dirs(...,
    device="cpu")`, and CD, F1 and EMD timed at the eval CLI's default
    batch, 16 pairs of 4,096 points, with their peak memory."""
    import tempfile

    import bdm_tpu_torch.main as pc2_cli
    import bdm_tpu_torch.main_blending as blend_cli
    import bdm_tpu_torch.main_merging as merge_cli
    parts = ("build_pc2", "build_pvd", "build_fusion", "get_dataset",
             "batch_to_device", "save_batch_outputs")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        common = CLI_ARGS + [f"run.save_dir={tmp}"]
        out["cli_bdm_blending"] = cli_run(
            "CLI BDM-B", blend_cli.main,
            common + CLI_BLEND + ["run.job=sample_bdm_blending",
                                  "run.name=bdm_b"],
            (blend_cli, parts + ("bdm_blending",)), plys=2,
            unused=("scatter_sum",))
        out["cli_bdm_merging_train"] = cli_run(
            "CLI BDM-M training", merge_cli.main,
            common + CLI_TRAIN + ["run.job=training_bdm_merging",
                                  "run.name=bdm_m", "scheduler=fusion",
                                  "run.max_fusion_steps=2"],
            (merge_cli, parts + ("train_loop",)))
        out["cli_bdm_merging_sample"] = cli_run(
            "CLI BDM-M", merge_cli.main,
            common + CLI_MERGE + [
                "run.job=sample_bdm_merging", "run.name=bdm_m",
                f"aux_run.fusion_ckpt={tmp}/bdm_m/checkpoint-latest.pt"],
            (merge_cli, parts + ("bdm_merging",)), plys=2,
            unused=("scatter_sum",))
        out["cli_pc2_train"] = cli_run(
            "CLI PC2 training", pc2_cli.main,
            common + CLI_TRAIN + ["run.job=train", "run.name=pc2",
                                  "run.max_steps=2", "ema.use_ema=true",
                                  "ema.update_every=1", "run.val_freq=2",
                                  "run.limit_val_batches=1"],
            (pc2_cli, parts + ("train_loop",)))
        out["cli_pc2_sample"] = cli_run(
            "CLI PC2 sample", pc2_cli.main,
            common + ["run.job=sample", "run.name=pc2",
                      f"checkpoint.resume={tmp}/pc2/checkpoint-latest.pt",
                      "run.sample_from_ema=true"],
            (pc2_cli, parts), plys=2, unused=("scatter_sum",))
        base = Path(tmp) / "bdm_b" / "sample_bdm_blending"
        agreement = eval_against_cpu(str(base / "pred" / "chair"),
                                     str(base / "gt" / "chair"))
    return out, agreement, eval_timings(dev)


def eval_against_cpu(pred, gt):
    """The eval CLI on the card on the BDM-B clouds, then `evaluate_dirs`
    on the card against the CPU: CD x1000 within rtol 1e-4, F1 within
    1/N. -> the values."""
    from bdm_tpu_torch.evaluation import cli as eval_cli
    eval_cli.main(["--pred_dir", pred, "--gt_dir", gt])
    res = {}
    for metric in ("cd", "f1"):
        (card, nan_card), (cpu, nan_cpu) = (
            eval_cli.evaluate_dirs(pred, gt, metric, device=d)
            for d in (None, "cpu"))
        if nan_card or nan_cpu or len(card) != 2 or len(cpu) != 2:
            fail(f"eval {metric}: {card} {nan_card} on the card, {cpu} "
                 f"{nan_cpu} on the CPU")
        err = max(abs(a - b) for a, b in zip(card, cpu))
        tol = (1e-4 * max(abs(b) for b in cpu) if metric == "cd"
               else 1.0 / 4096)
        print(f"eval {metric} on the BDM-B clouds: card {card}, CPU {cpu}, "
              f"max difference {err:.3e} (limit {tol:.3e})")
        if not err <= tol:
            fail(f"eval {metric}: the card and the CPU differ by {err}")
        res[metric] = dict(card=card, cpu=cpu, max_abs_err=err)
    return res


def eval_timings(dev, b=16, n=4096):
    """CD, F1 and EMD (Sinkhorn, 50 iterations) at the eval CLI's default
    batch: `b` pairs of `n` points made from a seed on the card; median
    device time of 5 calls after 2 (CUDA events) and the peak memory
    above the clouds of one call (each (b, n, n) float32 matrix is
    b * n * n * 4 bytes); CD within rtol 1e-4 and F1 within 1/N of the
    CPU's on the same clouds."""
    import torch
    from bdm_tpu_torch.evaluation import chamfer_distance, emd_sinkhorn, fscore
    g = torch.Generator().manual_seed(SEED + 11)
    pred = (torch.randn(b, n, 3, generator=g) * 0.3).to(dev)
    gt = (torch.randn(b, n, 3, generator=g) * 0.3 + 0.01).to(dev)
    calls = {"cd": lambda: chamfer_distance(pred, gt),
             "f1": lambda: fscore(pred, gt)[0],
             "emd": lambda: emd_sinkhorn(pred, gt, recenter=True)}
    out = {}
    for name, call in calls.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        v = call()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        if v.shape != (b,) or not torch.isfinite(v).all():
            fail(f"eval {name}: {tuple(v.shape)} not finite")
        ms = timed_ms(call)
        out[name] = dict(ms=ms, peak_gib=peak)
        print(f"eval {name} {b} x {n} points: {ms:.3f} ms, peak "
              f"{peak:.3f} GiB above the clouds, mean {float(v.mean()):.5f}")
        if name != "emd":   # CD and F1 also against the CPU on these clouds
            cpu = {"cd": chamfer_distance, "f1": lambda p, q: fscore(p, q)[0]
                   }[name](pred.cpu(), gt.cpu())
            err = float((v.cpu() - cpu).abs().max())
            tol = (1e-4 * float(cpu.abs().max()) if name == "cd"
                   else 1.0 / n)
            print(f"eval {name} {b} x {n}: card against CPU max difference "
                  f"{err:.3e} (limit {tol:.3e})")
            if not err <= tol:
                fail(f"eval {name}: the card and the CPU differ by {err}")
            out[name]["max_abs_err_vs_cpu"] = err
    return out


# ------------------------------------------------------------ phase m

def coloring_batches(seed, b, n, dev, image_size=224):
    """`training_batches` (repeated) with seeded colours in [0, 1]."""
    import torch
    from bdm_tpu_torch.tools.standins import training_batches
    g = torch.Generator().manual_seed(seed + 1)
    colors = torch.rand(b, n, 3, generator=g).to(dev)
    for batch in training_batches(seed, b, n, dev, image_size, repeat=True):
        yield dict(batch, colors=colors)


def coloring_model(cfg, dev, sa=None, fp=None):
    """A colouring model with weights from SEED and a visible head: its
    output projection N(0, 0.3^2), so the colours are not all 0.5."""
    import torch
    from bdm_tpu_torch.models import PointCloudColoringModel
    blocks = {} if sa is None else {"sa_blocks": sa, "fp_blocks": fp}
    model = PointCloudColoringModel(cfg, 1, device=dev, **blocks)
    model.reset_parameters(SEED)
    with torch.no_grad():
        w = model.point_cloud_model.output_projection.weight
        w.copy_(torch.randn(w.shape, generator=torch.Generator()
                            .manual_seed(SEED + 5)) * 0.3)
    return model


def coloring_tiny(dev):
    """Phase m, tiny: the colouring model (identity features at image 16,
    TINY_SA / TINY_FP, embedding 8, a visible head) on the card through
    the kernels against the same model on the CPU through the plain
    versions: `predict` within 1e-4 absolute (colours in [0, 1]), the loss
    at noise_std 0.1 (same noise, eval mode: no dropout) within 1e-4
    relative."""
    import dataclasses

    import torch
    from bdm_tpu_torch.samplers import TrainNoise
    cfg = dataclasses.replace(tiny_config(), predict_shape=False,
                              predict_color=True)
    batch = next(coloring_batches(SEED + 9, 2, 64, "cpu", 16))
    g = torch.Generator().manual_seed(SEED + 10)
    draw = (torch.zeros(2, dtype=torch.long), torch.randn(2, 64, 3,
                                                         generator=g))
    out, losses = [], []
    for d in ("cpu", dev):
        model = coloring_model(cfg, d, TINY_SA, TINY_FP)
        b = {k: v.to(d) for k, v in batch.items()}
        out.append(model.predict(b).cpu())
        noise = TrainNoise(device=d, replay=[draw])
        with torch.no_grad():
            losses.append(float(model.loss(b, noise, 0.1)))
    err = (out[0] - out[1]).abs().max().item()
    print(f"tiny colouring, kernels vs CPU plain: predict max|err| "
          f"{err:.3e}, loss {losses[0]} on the CPU, {losses[1]} on the card")
    if not (torch.isfinite(out[1]).all() and err <= 1e-4
            and abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[0])):
        fail(f"tiny colouring on the card differs from the CPU: predict "
             f"{err}, losses {losses}")
    return err


def coloring_paths(dev):
    """Phase m at full width: the colouring model (ViT-S/16 at 224 px,
    embedding 64, one block), B=8, N=4096. `predict` at
    mixed_precision bf16 and at "no", host clock around a synchronised
    call, median of 3 after a warm-up, peak memory; then two training
    steps through `train_loop` (the ViT frozen). The model is float32
    whatever the configuration: in the warm-up every floating output of
    every module is float32, and the two configurations' colours agree
    within 1e-5, where the same weights rounded to bf16 move them by more
    than ten times that. Only CUDA-core attention and conv launches, no
    `interp_mm` (the float32 gather form of the blend), and `scatter_sum`
    only in training (the devoxelization's backward). -> {path:
    {"launches", ...}}."""
    import torch
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.samplers import ProjectionConfig, TrainNoise
    from bdm_tpu_torch.train import pc2_freeze_mask
    b, n, limit = 8, 4096, 1e-5
    batch = next(coloring_batches(SEED + 12, b, n, dev))
    unused = ("interp_mm", "scatter_sum")
    out, colours = {}, []
    for mp in ("bf16", "no"):
        name = f"coloring_predict_{mp}"
        model = coloring_model(ProjectionConfig(
            predict_shape=False, predict_color=True, mixed_precision=mp), dev)
        not_f32 = set()

        def note(mod, args, res, where):
            res = res if isinstance(res, (tuple, list)) else (res,)
            if any(torch.is_tensor(t) and t.is_floating_point()
                   and t.dtype != torch.float32 for t in res):
                not_f32.add(where)

        hooks = [m.register_forward_hook(partial(note, where=k))
                 for k, m in model.named_modules()]
        times, rgb = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(4):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            rgb.append(model.predict(batch))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                for h in hooks:
                    h.remove()
        if not_f32:
            fail(f"{name}: modules with outputs other than float32: "
                 f"{sorted(not_f32)}")
        if rgb[-1].shape != (b, n, 3) or not (
                torch.isfinite(rgb[-1]).all() and rgb[-1].min() >= 0
                and rgb[-1].max() <= 1 and rgb[-1].std() > 0.1):
            fail(f"{name}: colours {tuple(rgb[-1].shape)} not finite and "
                 f"spread in [0, 1]")
        again = (rgb[-1] - rgb[-2]).abs().max().item()
        colours.append(rgb[-1])
        ms = statistics.median(times[1:]) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = check_path(name, kernels.counts(), kernels.path_counts(),
                              unused, float32=True)
        print(f"{name} B={b} N={n}: {ms:.2f} ms (median of 3 after "
              f"warm-up), peak memory {peak:.3f} GiB; colours std "
              f"{rgb[-1].std().item():.4f}, two calls max|diff| "
              f"{again:.3e}; launches {json.dumps(launches)}")
        out[name] = dict(ms=ms, peak_gib=peak, launches=launches)
        del rgb
    diff = (colours[0] - colours[1]).abs().max().item()
    params = list(model.parameters())
    with torch.no_grad():
        kept = [p.clone() for p in params]
        for p in params:
            p.copy_(p.bfloat16().float())
        moved = (model.predict(batch) - colours[1]).abs().max().item()
        for p, k in zip(params, kept):
            p.copy_(k)
    print(f"colouring predict, bf16 configuration vs float32: max|diff| "
          f"{diff:.3e} (limit {limit}); the weights rounded to bf16 move "
          f"the colours by {moved:.3e}")
    if not diff <= limit:
        fail(f"the colouring model is not float32 under bf16: {diff}")
    if not moved > 10 * limit:
        fail(f"the bf16 check cannot see a bf16 model: rounding moved the "
             f"colours by {moved} only")
    del colours, kept
    pc2_freeze_mask(model)
    counts, losses, ms, peak, _ = run_training(
        "coloring training", model, model.loss,
        coloring_batches(SEED + 13, b, n, dev), TrainNoise(SEED, device=dev),
        2)
    out["coloring_train"] = dict(
        step_ms=ms, peak_gib=peak,
        launches=check_path("coloring training", *counts, ("interp_mm",),
                            float32=True))
    del model
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase n

# phase n's point-sharded denoise: the point counts; its data-parallel
# training: B 8 over two ranks of four rows
SP_POINTS = (4096, 16384)
DP_B, DP_N, DP_STEPS = 8, 4096, 2


def dp_pc2(mixed_precision, dev, sp_group=None):
    """Phase n's PC2 at full width: random weights from SEED, the feature
    model frozen, a visible head (under PC2's 1e-6 head the backbone's
    gradients are ~1e-6 and its outputs ~1e-6: nothing to compare)."""
    import torch
    from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig
    from bdm_tpu_torch.train import pc2_freeze_mask
    pc2 = PC2Model(ProjectionConfig(mixed_precision=mixed_precision),
                   device=dev, sp_group=sp_group)
    pc2.reset_parameters(SEED)
    pc2_freeze_mask(pc2)
    head = pc2.backbone.classifier[2].weight
    with torch.no_grad():
        head.copy_(torch.randn(head.shape, generator=torch.Generator()
                               .manual_seed(5)).to(dev) * 0.1)
    return pc2


def sgd_state(model):
    """SGD (lr 1e-3) with the clip at 50 and the EMA every step: SGD keeps
    a parameter's difference between two runs proportional to its
    gradient's (Adam would turn the rounding noise of a gradient that is
    zero in exact arithmetic into a step of the learning rate's size)."""
    from bdm_tpu_torch.train import create_train_state, make_optimizer
    return create_train_state(model, make_optimizer(model, "SGD", lr=1e-3),
                              use_ema=True, ema_update_every=1)


def trainable(model):
    return {k: p.detach().cpu().clone() for k, p in model.named_parameters()
            if p.requires_grad}


def params_err(got, want):
    """max |got - want| over every tensor, each over 1e-5 of its tensor's
    largest entry plus a floor of 1e-6 of the model's largest -> the worst
    ratio (1: at the tolerance). The floor holds the tensors whose
    gradient is rounding noise (a conv bias ahead of a GroupNorm has none
    in exact arithmetic), which the backward of a gather, adding with
    atomics in an order that changes, makes differ between two runs of one
    process on the card by up to 3e-7 (measured by this phase on an
    NVIDIA H100 80GB HBM3 at 700 W)."""
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    ratios = {k: float((got[k] - w).abs().max())
              / (1e-5 * float(w.abs().max()) + floor)
              for k, w in want.items()}
    worst = max(ratios, key=ratios.get)
    print(f"params_err: worst {worst} {ratios[worst]:.3f}: max|err| "
          f"{float((got[worst] - want[worst]).abs().max()):.3e}, max|p| "
          f"{float(want[worst].abs().max()):.3e}, floor {floor:.3e}; "
          f"{sum(r > 1 for r in ratios.values())} of {len(ratios)} over")
    return ratios[worst]


def grads_err(got, want):
    """Each tensor's worst |got - want| over 1e-5 + 2e-4 |want|, elementwise
    (the JAX test's `assert_allclose`) -> {name: ratio}."""
    return {k: float(((got[k] - w).abs() / (1e-5 + 2e-4 * w.abs())).max())
            for k, w in want.items()}


def _parallel_rank(d):
    """One of phase n's two ranks (spawned, both on the one card, gloo):
    the data-parallel float32 steps and the bf16 step, the sharded
    Chamfer distance, the point-sharded denoise at SP_POINTS with its walls
    and one backward; -> <d>/rank<r>.pt."""
    import os

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bdm_tpu_torch.conditioning import PerspectiveCamera
    from bdm_tpu_torch.evaluation import chamfer_distance_sharded
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.parallel import init_distributed, shard_batch
    from bdm_tpu_torch.parallel.point_sharded import own_rows
    from bdm_tpu_torch.samplers import TrainNoise
    from bdm_tpu_torch.train import make_train_step, save_checkpoint
    dev = init_distributed()
    record_shapes()
    rank, world = dist.get_rank(), dist.get_world_size()
    group = dist.group.WORLD
    inp = torch.load(os.path.join(d, "inputs.pt"), map_location=dev,
                     weights_only=False)
    cam = PerspectiveCamera(**inp["camera"])
    local = shard_batch(dict(inp["batch"], camera=cam), rank, world)
    out = {}

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    def counts():
        return kernels.counts(), kernels.path_counts()

    # 1. data-parallel training, float32 then one bf16 step
    pc2 = dp_pc2("no", dev)
    state = sgd_state(pc2)
    step = make_train_step(pc2.loss, group)
    noise = TrainNoise(SEED + 12, dev)
    sync()
    kernels.reset_counts()
    out["dp_steps"] = []
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        m = step(state, local, noise)
        sync()
        out["dp_steps"].append((
            {k: float(v) for k, v in m.items()}, time.perf_counter() - t0,
            trainable(pc2) if rank == 0 else None))
    out["dp_counts"] = counts()
    save_checkpoint(os.path.join(d, "ckpt"), state)       # rank 0 writes
    del pc2, state
    pc2 = dp_pc2("bf16", dev)
    step = make_train_step(pc2.loss, group)
    sync()
    kernels.reset_counts()
    m = step(sgd_state(pc2), local, TrainNoise(SEED + 12, dev))
    sync()
    out["bf16"] = ({k: float(v) for k, v in m.items()}, counts())
    del pc2
    torch.cuda.empty_cache()

    # 2. the Chamfer distance with pred's points split over the ranks
    out["chamfer"] = chamfer_distance_sharded(
        own_rows(inp["pred"], group), inp["gt"], group).cpu()

    # 3. the point-sharded denoise, float32
    pc2 = dp_pc2("no", dev, sp_group=group)
    cond = pc2.prepare_cond(pc2.conditioning_map(inp["image"]))
    t = inp["t"]
    for n in SP_POINTS:
        x = own_rows(inp[f"x{n}"], group)
        walls = []
        for _ in range(3):
            sync()
            kernels.reset_counts()
            t0 = time.perf_counter()
            with torch.inference_mode():
                eps = pc2.denoise(x, t, cam, cond)
            sync()
            walls.append(time.perf_counter() - t0)
        out[f"sp{n}"] = (eps.cpu(), walls, counts())
    # one backward: this rank's part of the whole mean, gradients summed
    x, tgt = own_rows(inp["x4096"], group), own_rows(inp["tgt"], group)
    sync()
    t0 = time.perf_counter()
    part = torch.sum((pc2.denoise(x, t, cam, cond) - tgt) ** 2) / (
        inp["tgt"].numel())
    part.backward()
    grads = {k: p.grad for k, p in pc2.backbone.named_parameters()}
    for g in grads.values():
        dist.all_reduce(g)
    sync()
    out["sp_backward_s"] = time.perf_counter() - t0
    if rank == 0:
        out["sp_grads"] = {k: g.cpu() for k, g in grads.items()}
    out["seen"] = {k: sorted(v) for k, v in SEEN.items()}
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


def sharded_scatter_sums(res, dev):
    """The scatter-sum at the shapes of the point-sharded grid's partial
    sums (a shard of 2,048 or 8,192 points into R 32, the rows [features |
    1] at PC2's input-level widths 390, 32 and 64): bit for bit the CPU's
    `index_add_`, timed beside it; added to phase a's `ms_by_shape`."""
    import torch
    from bdm_tpu_torch import ops
    from bdm_tpu_torch.ops.cuda import scatter_sum
    g = torch.Generator().manual_seed(SEED + 13)
    b, s = 8, 32 ** 3
    for n in (2048, 8192):
        ids = ops.make_voxel_context(
            (torch.randn(b, n, 3, generator=g) * 0.3).to(dev), 32).ids
        for c in (391, 33, 65):
            rows = torch.randn(b, n, c, generator=g).to(dev)
            sums = scatter_sum.scatter_sum(rows, ids, s)
            if not torch.equal(sums.cpu(), scatter_sum.scatter_sum_plain(
                    rows.cpu(), ids.cpu(), s)):
                fail(f"scatter_sum N={n} S={s} C={c}: not the CPU's "
                     f"index_add_ bit for bit")
            dst = (ids.long() + torch.arange(b, device=dev)[:, None] * s
                   ).reshape(-1)
            flat, acc = rows.reshape(-1, c), torch.empty((b * s, c),
                                                         device=dev)
            res["scatter_sum"]["ms_by_shape"][f"N{n}_S{s}_C{c}"] = dict(
                ms=timed_ms(lambda: scatter_sum.scatter_sum(rows, ids, s),
                            inner=20),
                library_ms=timed_ms(
                    lambda: acc.zero_().index_add_(0, dst, flat), inner=20),
                **bound([rows, ids, sums], rows.numel(), "f32"))


def parallel_paths(res, dev):
    """Phase n: `bdm_tpu_torch.parallel` on the card, two ranks spawned
    over gloo (they share the one card). PC2 at full width, float32:
    two data-parallel SGD steps at B 8 (four rows a rank) against one
    process's two steps on the 8 rows, one bf16 step; the sharded Chamfer
    distance of 16 x 4,096 points against the dense one; the point-sharded
    denoise at B 8, N 4,096 and 16,384, against the unsharded one, with
    its walls beside the unsharded walls, and one backward's gradients;
    then a world-1 NCCL step against the single process's first, the
    checkpoint of the two ranks restored in one process, and the
    dryrun on two ranks on the card. -> (the summary, the launches of
    each path)."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from bdm_tpu_torch.evaluation import chamfer_distance
    from bdm_tpu_torch.parallel import init_distributed, spawn_ranks
    from bdm_tpu_torch.parallel.dryrun import dryrun_multichip
    from bdm_tpu_torch.parallel.mesh import free_port
    from bdm_tpu_torch.samplers import TrainNoise
    from bdm_tpu_torch.tools.standins import camera, training_batches
    from bdm_tpu_torch.train import make_train_step, restore_checkpoint
    t_phase = time.perf_counter()
    sharded_scatter_sums(res, dev)
    g = torch.Generator().manual_seed(SEED + 14)
    batch = next(training_batches(SEED + 11, DP_B, DP_N, "cpu"))
    cam = camera(DP_B, "cpu")
    inputs = {
        "batch": {k: v for k, v in batch.items() if k != "camera"},
        "camera": {k: getattr(cam, k) for k in ("R", "T", "focal_length",
                                                "principal_point")},
        "pred": torch.randn(16, 4096, 3, generator=g) * 0.3,
        "gt": torch.randn(16, 4096, 3, generator=g) * 0.3 + 0.01,
        "image": torch.rand(DP_B, 224, 224, 3, generator=g),
        "t": torch.randint(0, 1000, (DP_B,), generator=g),
        "tgt": torch.randn(DP_B, 4096, 3, generator=g),
        **{f"x{n}": torch.randn(DP_B, n, 3, generator=g) * 0.3
           for n in SP_POINTS}}
    on_dev = {k: v.to(dev) for k, v in inputs.items()
              if torch.is_tensor(v)}
    dbatch = {k: v.to(dev) for k, v in inputs["batch"].items()}
    dbatch["camera"] = camera(DP_B, dev)

    # one process: two SGD steps on the 8 rows, twice (the second run is
    # the yardstick of the card's own spread), then the unsharded denoise
    runs = []
    for _ in range(2):
        pc2 = dp_pc2("no", dev)
        state = sgd_state(pc2)
        step = make_train_step(pc2.loss)
        noise = TrainNoise(SEED + 12, dev)
        runs.append([])
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, dbatch, noise)
            torch.cuda.synchronize()
            runs[-1].append(({k: float(v) for k, v in m.items()},
                             time.perf_counter() - t0, trainable(pc2)))
        del pc2, state
    single = runs[0]
    dp_spread = params_err(runs[1][-1][2], single[-1][2])
    del runs
    pc2 = dp_pc2("no", dev)
    cond = pc2.prepare_cond(pc2.conditioning_map(on_dev["image"]))
    unsharded = {}
    for n in SP_POINTS:
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                eps = pc2.denoise(on_dev[f"x{n}"], on_dev["t"], dbatch[
                    "camera"], cond)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        unsharded[n] = (eps.cpu(), walls)
    # twice: the second is the yardstick of the card's own spread (the
    # backward of a gather adds with atomics, in an order that changes)
    backward = []
    for _ in range(2):
        pc2.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = torch.mean((pc2.denoise(on_dev["x4096"], on_dev["t"],
                                       dbatch["camera"], cond)
                           - on_dev["tgt"]) ** 2)
        loss.backward()
        torch.cuda.synchronize()
        backward.append((time.perf_counter() - t0, {
            k: p.grad.cpu() for k, p in pc2.backbone.named_parameters()}))
    backward_s, want_grads = backward[0]
    # and with the input points moved by about one float32 ulp: how far the
    # gradients move when the forward's values change by rounding alone
    # (a max-pool routes a gradient to one neighbour of a near-tie)
    pc2.zero_grad(set_to_none=True)
    x = on_dev["x4096"]
    x = x + x.abs() * 2.0 ** -23 * torch.randn(
        x.shape, generator=torch.Generator().manual_seed(SEED + 15)).sign(
        ).to(dev)
    torch.mean((pc2.denoise(x, on_dev["t"], dbatch["camera"], cond)
                - on_dev["tgt"]) ** 2).backward()
    nudged = {k: p.grad.cpu() for k, p in pc2.backbone.named_parameters()}
    want_cd = chamfer_distance(on_dev["pred"], on_dev["gt"]).cpu()
    del pc2, cond, on_dev
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        torch.save(inputs, os.path.join(d, "inputs.pt"))
        t0 = time.perf_counter()
        spawn_ranks(_parallel_rank, 2, (d,), timeout=600)
        ranks_s = time.perf_counter() - t0
        outs = [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]
        ckpt = os.path.join(d, "ckpt", "checkpoint-latest.pt")
        payload = torch.load(ckpt, map_location=dev, weights_only=True)
        if any(k.startswith("module.") for k in payload["model"]):
            fail("phase n: the checkpoint of two ranks has module. keys")
        one = dp_pc2("no", dev)
        restored = restore_checkpoint(ckpt, sgd_state(one))
        if restored.step != DP_STEPS or not all(
                torch.equal(v, outs[0]["dp_steps"][-1][2][k])
                for k, v in trainable(one).items()):
            fail("phase n: the checkpoint of two ranks does not restore "
                 "their parameters in one process")
        del one, restored, payload
    for o in outs:
        for k, v in o["seen"].items():
            SEEN[k].update(tuple(x) for x in v)

    # the two ranks against one process
    errs = {"dp_loss": 0.0, "dp_grad_norm": 0.0, "dp_params": 0.0}
    for i, (wm, _, wp) in enumerate(single):
        for o in outs:
            gm = o["dp_steps"][i][0]
            for k in ("loss", "grad_norm"):
                errs[f"dp_{k}"] = max(errs[f"dp_{k}"],
                                      abs(gm[k] - wm[k]) / abs(wm[k]))
        errs["dp_params"] = max(errs["dp_params"],
                                params_err(outs[0]["dp_steps"][i][2], wp))
    errs["single_again_params"] = dp_spread
    print(f"phase n: 2 ranks x {DP_B // 2} rows against 1 x {DP_B}, "
          f"float32 SGD, {DP_STEPS} steps: losses "
          f"{[s[0]['loss'] for s in outs[0]['dp_steps']]} / "
          f"{[s[0]['loss'] for s in single]}, grad norms "
          f"{[s[0]['grad_norm'] for s in outs[0]['dp_steps']]} / "
          f"{[s[0]['grad_norm'] for s in single]}; relative errors "
          f"{json.dumps(errs)}")
    if not (errs["dp_loss"] <= 1e-5 and errs["dp_grad_norm"] <= 1e-4
            and errs["dp_params"] <= 1.0):
        fail(f"phase n: the data-parallel steps are not the one process's: "
             f"{errs}")
    bf16 = outs[0]["bf16"][0]
    if not all(abs(x) < 1e30 and x == x for x in bf16.values()):
        fail(f"phase n: the bf16 data-parallel step gave {bf16}")

    cd = outs[0]["chamfer"]
    cd_err = float(((cd - want_cd).abs() / want_cd.abs()).max())
    print(f"phase n: sharded Chamfer {tuple(inputs['pred'].shape)} over 2 "
          f"ranks, max relative error {cd_err:.3e} against the dense one")
    if not cd_err <= 1e-5 or not torch.equal(outs[1]["chamfer"], cd):
        fail(f"phase n: the sharded Chamfer distance is off by {cd_err}")

    sp = {}
    for n in SP_POINTS:
        got = torch.cat([o[f"sp{n}"][0] for o in outs], dim=1)
        want, walls = unsharded[n]
        err = float((got - want).abs().max())
        # the JAX test's assert_allclose: |got - want| <= 5e-5 + 1e-4 |want|
        of_tol = float(((got - want).abs() / (5e-5 + 1e-4 * want.abs()))
                       .max())
        sp[n] = dict(max_abs_err=err, err_of_tol=of_tol,
                     max_abs_out=float(want.abs().max()),
                     wall_s=statistics.median(outs[0][f"sp{n}"][1][1:]),
                     unsharded_wall_s=statistics.median(walls[1:]))
        print(f"phase n: point-sharded denoise B={DP_B} N={n} float32 over "
              f"2 ranks: max|err| {err:.3e}, {of_tol:.3f} of the tolerance; wall "
              f"{sp[n]['wall_s']:.3f} s, unsharded {sp[n]['unsharded_wall_s']:.3f} s "
              f"(medians of 2 after a warm-up)")
        if not torch.isfinite(got).all() or not of_tol <= 1.0:
            fail(f"phase n: the point-sharded denoise at N={n} is off by "
                 f"{err}")
    # the gradient of a max-pool is not continuous: where two neighbours
    # nearly tie, rounding alone routes it to either. So a tensor passes
    # within the JAX test's tolerance, or within twice the change that an
    # ulp's nudge of the input makes in the unsharded gradient itself.
    gerr = grads_err(outs[0]["sp_grads"], want_grads)
    spread = grads_err(backward[1][1], want_grads)
    nudge = grads_err(nudged, want_grads)
    over = {k: (r, nudge[k]) for k, r in gerr.items()
            if r > max(1.0, 2.0 * nudge[k])}
    beyond = sorted(k for k, r in gerr.items() if r > 1.0)
    worst = max(gerr, key=gerr.get)
    print(f"phase n: point-sharded backward N={SP_POINTS[0]}: worst "
          f"gradient {worst} at {gerr[worst]:.3f} of the JAX tolerance (an "
          f"ulp's nudge of the input moves the unsharded one by "
          f"{nudge[worst]:.3f} there, {max(nudge.values()):.3f} at worst; "
          f"a second unsharded backward {max(spread.values()):.3f}); "
          f"{len(beyond)} of {len(gerr)} tensors beyond the JAX tolerance "
          f"{beyond}; wall "
          f"{outs[0]['sp_backward_s']:.3f} s, unsharded {backward_s:.3f} s")
    if over:
        fail(f"phase n: point-sharded gradients off: {over}")

    launches = {}
    for name, key, unused, f32 in (
            ("dp_f32", "dp_counts", ("interp_mm",), True),
            ("dp_bf16", None, (), False),
            ("sp_4096", "sp4096", ("interp_mm",), True),
            ("sp_16384", "sp16384", ("interp_mm",), True)):
        for r, o in enumerate(outs):
            c = o["bf16"][1] if key is None else (o[key] if key == "dp_counts"
                                                  else o[key][2])
            got = check_path(f"{name} (rank {r})", *c, unused, f32,
                             here=False)
            if r == 0:
                launches[name] = got
    if launches["dp_bf16"]["scatter_sum"] != 2 + DEVOX_A_FORWARD:
        fail(f"phase n: the bf16 step launched scatter_sum "
             f"{launches['dp_bf16']['scatter_sum']} times, not "
             f"{2 + DEVOX_A_FORWARD}")
    print("phase n launches (rank 0):", json.dumps(launches))

    # world 1 over NCCL: the step of one process, through a process group
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    os.environ.update(env)
    try:
        init_distributed()
        backend = dist.get_backend()
        pc2 = dp_pc2("no", dev)
        m = make_train_step(pc2.loss, dist.group.WORLD)(
            sgd_state(pc2), dbatch, TrainNoise(SEED + 12, dev))
        nccl = dict(backend=backend, loss=float(m["loss"]),
                    params_err=params_err(trainable(pc2), single[0][2]))
        del pc2
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k)
    print(f"phase n: world 1 over {nccl['backend']}: loss {nccl['loss']} "
          f"against {single[0][0]['loss']}, parameters at "
          f"{nccl['params_err']:.3f} of the tolerance")
    if backend != "nccl" or not abs(nccl["loss"] - single[0][0]["loss"]) \
            <= 1e-5 * abs(single[0][0]["loss"]) or not nccl["params_err"] <= 1.0:
        fail(f"phase n: the world-1 NCCL step is not one process's: {nccl}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dryrun_multichip(2)
    dryrun_s = time.perf_counter() - t0
    summary = dict(
        dp=dict(errors=errs, step_s=[s[1] for s in outs[0]["dp_steps"]],
                single_step_s=[s[1] for s in single],
                losses=[s[0]["loss"] for s in outs[0]["dp_steps"]],
                bf16=bf16),
        chamfer_max_rel_err=cd_err, sp=sp,
        sp_grad_err_of_tol=gerr[worst], sp_grads_beyond_tol=beyond,
        unsharded_again_grad_err_of_tol=max(spread.values()),
        nudged_grad_err_of_tol=max(nudge.values()),
        sp_backward_s=outs[0]["sp_backward_s"],
        unsharded_backward_s=backward_s, world1=nccl, ranks_s=ranks_s,
        dryrun_s=dryrun_s, phase_s=time.perf_counter() - t_phase)
    print("phase n:", json.dumps(summary))
    return summary, launches


def main() -> int:
    if not (ROOT / "bdm_tpu_torch").is_dir():
        print("chip_smoke: bdm_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the plain versions serve as references: no TF32 in them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bdm_tpu_torch.bench import smi_line
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.samplers import bdm_blending, bdm_merging
    from bdm_tpu_torch.tools.standins import production_models

    card = smi_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")

    res, checked = check_kernels(dev)
    check_gradients(dev)
    tiny_pre_err = tiny_parity(dev)
    tiny_training(dev)
    tiny_coloring_err = coloring_tiny(dev)
    record_shapes()
    pc2, pvd, merge = production_models(SEED)
    fwd = forwards(pc2, merge, dev)
    blend, blend_wall, blend_cloud = sampler_path(
        "BDM-B", partial(bdm_blending, pc2, pvd),
        [50, 48, 46, 44, 6, 4, 2, 0], 1, dev)
    merged, merge_wall, _ = sampler_path(
        "BDM-M", partial(bdm_merging, merge, pc2, pvd),
        [50, 46, 42, 38, 12, 8, 4, 0], 2, dev)
    single = single_model_sampling(pc2, pvd, dev)
    options = option_steps(dev)
    pre_ab = precontract_ab(pc2, pvd, blend_cloud, tiny_pre_err, dev)
    del pc2, pvd
    torch.cuda.empty_cache()
    train = {"pc2_f32": pc2_training(dev, "no"),
             "pc2_bf16": pc2_training(dev, "bf16")}
    torch.cuda.empty_cache()
    train.update(wide_and_fusion_training(merge, dev))
    del merge
    torch.cuda.empty_cache()
    cli, cli_eval, eval_ms = cli_paths(dev)
    coloring = coloring_paths(dev)
    parallel, parallel_launches = parallel_paths(res, dev)
    check_shapes_covered(checked)
    by_path = dict(bdm_blending=blend, bdm_merging=merged,
                   **{k: v["launches"] for k, v in train.items()},
                   **{k: v[0] for k, v in cli.items()})

    backbone = fwd.pop("pc2_backbone")
    by_path.update({k: v["launches"] for k, v in fwd.items()})
    by_path.update({k: v["launches"] for k, v in single.items()})
    by_path.update({f"option_{k}": v["launches"] for k, v in options.items()})
    by_path["bdm_blending_precontract"] = pre_ab["bdm_b"]["launches"]
    by_path.update({k: v["launches"] for k, v in coloring.items()})
    by_path.update(parallel_launches)

    rows = []
    for name, (mod, source, replaces) in kernels.KERNELS.items():
        row = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            # of this slice's main path, the four bf16 training steps of
            # PC2, where every kernel launches; every path's own count
            # follows
            launches=by_path["pc2_bf16"][name],
            launches_by_path={k: v[name] for k, v in by_path.items()},
            **res[name])
        if name in kernels.PATHS:
            row["launches_by_kernel"] = {
                k: {p: v[f"{name}_{p}"] for p in kernels.PATHS[name]}
                for k, v in by_path.items()}
        rows.append(row)
    print(json.dumps({"denoise_step_ms": fwd["pc2_forward"]["ms"],
                      "fusion_forward_ms": fwd["fusion_forward"]["ms"],
                      "pc2_backbone_forward_ms": backbone,
                      "bdm_b_wall_s": blend_wall,
                      "bdm_m_wall_s": merge_wall,
                      "sampling_wall_s": {k: v["wall_s"]
                                          for k, v in single.items()},
                      "option_step_ms": {k: v["ms"]
                                         for k, v in options.items()},
                      "precontract": {k: v for k, v in pre_ab.items()
                                      if k != "bdm_b"},
                      "training": {k: {m: v[m] for m in v
                                       if m not in ("launches", "losses")}
                                   for k, v in train.items()},
                      "cli_wall_s": {k: v[1] for k, v in cli.items()},
                      "cli_parts_s": {k: v[2] for k, v in cli.items()},
                      "eval_on_bdm_b": cli_eval,
                      "eval_16x4096": eval_ms,
                      "coloring": {k: {m: v[m] for m in v if m != "launches"}
                                   for k, v in coloring.items()},
                      "coloring_tiny_max_abs_err": tiny_coloring_err,
                      "parallel": parallel}))
    print(json.dumps({"kernels": rows, "graphs_by_path": GRAPHS}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
