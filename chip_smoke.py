#!/usr/bin/env python3
"""Smoke run of bdm_tpu_torch on one NVIDIA GPU: build the Hopper kernels,
check each against its plain PyTorch version, then run the port's main
path, BDM-Blending sampling, at full model width.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  a. every kernel against its plain version at the main path's shapes,
     float32 and bfloat16; indices exact, floats under a stated tolerance;
     median times of kernel and plain version (CUDA events, after warm-up);
  d. a tiny BDM-Blending run through the kernels against the same run on
     the CPU through the plain versions, same weights and noise;
  b. one PC2 denoise step at B=8, N=4096, bf16, production widths;
  c. BDM-Blending end to end at production widths (PC2 with ViT-S/16 +
     PVD), B=2, N=4096, bf16, 50 DDPM steps with three interior
     milestones; every kernel must have launched and no plain version may
     have run on the card.

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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median device time of fn() over `reps` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ phase a

def check_kernels(dev):
    """-> {name: {"max_abs_err", "ms", "plain_ms"}} at production shapes."""
    import torch
    from bdm_tpu_torch import ops
    from bdm_tpu_torch.ops.cuda import (attention, ball_query, conv3d, fps,
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
    res["fps"] = dict(
        max_abs_err=0.0,
        ms=timed_ms(lambda: fps.furthest_point_sample(pts[4096], 1024)),
        plain_ms=timed_ms(
            lambda: fps.furthest_point_sample_plain(pts[4096], 1024), 3, 1))

    for n, m, r in levels:
        a = ball_query.ball_query(pts[m], pts[n], r, 32)
        if not torch.equal(a, ball_query.ball_query_plain(pts[m], pts[n], r,
                                                          32)):
            fail(f"ball_query differs at N={n}, M={m}, r={r}")
    c0, p0 = pts[1024], pts[4096]
    res["ball_query"] = dict(
        max_abs_err=0.0,
        ms=timed_ms(lambda: ball_query.ball_query(c0, p0, 0.1, 32)),
        plain_ms=timed_ms(lambda: ball_query.ball_query_plain(c0, p0, 0.1,
                                                              32)))

    err = 0.0
    for n, m, _ in levels:
        i, w = three_nn.three_nn(pts[n], pts[m])
        pi, pw = three_nn.three_nn_plain(pts[n], pts[m])
        if not torch.equal(i, pi):
            fail(f"three_nn indices differ at N={n}, M={m}")
        err = max(err, rel_err(w, pw, 1e-6, f"three_nn weights N={n}"))
    res["three_nn"] = dict(
        max_abs_err=err,
        ms=timed_ms(lambda: three_nn.three_nn(p0, c0)),
        plain_ms=timed_ms(lambda: three_nn.three_nn_plain(p0, c0)))

    # voxel sites of PC2 + PVD: (C, R, N); 390 = PC2 stage-0 input
    sites = [(390, 32, 4096), (3, 32, 4096), (32, 32, 4096), (96, 16, 1024),
             (192, 8, 256), (256, 8, 64), (256, 8, 256), (128, 16, 1024),
             (64, 32, 4096)]
    ctxs = {}
    err = 0.0
    for c, r, n in sites:
        ctx = ctxs.setdefault((r, n), ops.make_voxel_context(pts[n], r))
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
            f = randn(b, n, c, dtype=dt)
            args = (f, ctx.order, ctx.ids_sorted, ctx.voxel_lo, r, dt)
            grid = voxelize.scatter_mean(*args)
            err = max(err, rel_err(grid, voxelize.scatter_mean_plain(*args),
                                   tol, f"scatter_mean C={c} R={r} {dt}"))
    f0 = randn(b, 4096, 390, dtype=torch.bfloat16)
    ctx0 = ctxs[(32, 4096)]
    vargs = (f0, ctx0.order, ctx0.ids_sorted, ctx0.voxel_lo, 32,
             torch.bfloat16)
    res["scatter_mean"] = dict(
        max_abs_err=err, ms=timed_ms(lambda: voxelize.scatter_mean(*vargs)),
        plain_ms=timed_ms(lambda: voxelize.scatter_mean_plain(*vargs)))

    # convs of PC2 + PVD: (Cin, Cout, R)
    convs = [(390, 32, 32), (3, 32, 32), (32, 32, 32), (96, 64, 16),
             (64, 64, 16), (192, 128, 8), (128, 128, 8), (256, 256, 8),
             (128, 128, 16), (64, 64, 32)]
    err = 0.0
    for cin, cout, r in convs:
        wt = randn(cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            x = randn(b, r, r, r, cin, dtype=dt)
            err = max(err, rel_err(conv3d.conv3d(x, wt, bias),
                                   conv3d.conv3d_plain(x, wt, bias), tol,
                                   f"conv3d {cin}->{cout} R={r} {dt}"))
    x0 = randn(b, 32, 32, 32, 390, dtype=torch.bfloat16)
    w0 = randn(32, 390, 3, 3, 3, scale=(27 * 390) ** -0.5)
    bias0 = randn(32, scale=0.1)
    res["conv3d"] = dict(
        max_abs_err=err, ms=timed_ms(lambda: conv3d.conv3d(x0, w0, bias0)),
        plain_ms=timed_ms(lambda: conv3d.conv3d_plain(x0, w0, bias0)))

    err = 0.0
    qkv = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        q, k, v = (randn(b, 4096, 64, scale=0.3, dtype=dt) for _ in range(3))
        qkv[dt] = (q, k, v)
        err = max(err, rel_err(attention.attention(q, k, v),
                               attention.attention_plain(q, k, v), tol,
                               f"attention {dt}"))
    qb = qkv[torch.bfloat16]
    res["attention"] = dict(
        max_abs_err=err, ms=timed_ms(lambda: attention.attention(*qb)),
        plain_ms=timed_ms(lambda: attention.attention_plain(*qb)))
    for name, r in res.items():
        print(f"kernel {name}: max_abs_err {r['max_abs_err']:.3e}  "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms")
    return res


# ------------------------------------------------------------ models

def camera(b, dev):
    """An R2N2-like view: focal 2.1875, the cloud 1.75 units ahead."""
    import torch
    from bdm_tpu_torch.conditioning import PerspectiveCamera
    return PerspectiveCamera(
        R=torch.eye(3).expand(b, 3, 3).contiguous(),
        T=torch.tensor([0.0, 0.0, 1.75]).expand(b, 3).contiguous(),
        focal_length=torch.full((b, 2), 2.1875),
        principal_point=torch.zeros(b, 2)).to(dev)


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


def tiny_parity(dev):
    """Phase d: tiny BDM-Blending on the card (kernels) vs on the CPU
    (plain versions); 1e-3 absolute, as the CPU test holds the port to
    the JAX reference."""
    import torch
    from bdm_tpu_torch.samplers import (PC2Model, ProjectionConfig,
                                        PVDModel, bdm_blending)
    sa = (((8, 2, 4), (16, 0.3, 8, (8, 16))),
          ((16, 2, 4), (8, 0.4, 8, (16, 32))),
          (None, (4, 0.8, 8, (32, 64))))
    fp = (((32, 32), (16, 1, 4)), ((16, 16), (16, 1, 4)),
          ((16, 8), (8, 1, 4)))
    cfg = ProjectionConfig(image_size=16, image_feature_model="identity",
                           raster_point_radius=0.3,
                           point_cloud_model_embed_dim=8)
    outs = []
    image = torch.rand(2, 16, 16, 3,
                       generator=torch.Generator().manual_seed(1))
    for d in ("cpu", dev):
        pc2 = PC2Model(cfg, sa, fp)
        pvd = PVDModel(embed_dim=8, sa_blocks=sa, fp_blocks=fp)
        pc2.reset_parameters(SEED)
        pvd.reset_parameters(SEED + 1)
        with torch.no_grad():   # a visible head, the same on both devices
            pc2.backbone.classifier[2].weight.normal_(
                0.0, 0.1, generator=torch.Generator().manual_seed(5))
        pc2.to(d)
        pvd.to(d)
        batch = {"image": image.to(d),
                 "camera": camera(2, d)}
        outs.append(bdm_blending(pc2, pvd, batch, 64, [8, 7, 5, 3, 0], 1,
                                 noise=_CpuNoise(SEED, d),
                                 num_inference_steps=8).cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    print(f"tiny BDM-B, kernels vs CPU plain: max|err| {err:.3e}")
    if not (torch.isfinite(outs[1]).all() and err < 1e-3):
        fail(f"tiny BDM-B on the card differs from the CPU run: {err}")


def production_models(dev):
    import torch
    from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig, PVDModel
    pc2 = PC2Model(ProjectionConfig(mixed_precision="bf16"))
    pvd = PVDModel(mixed_precision="bf16")
    pc2.reset_parameters(SEED)
    pvd.reset_parameters(SEED + 1)
    return pc2.to(dev).eval(), pvd.to(dev).eval()


def denoise_step(pc2, dev):
    """Phase b: one PC2 denoise step, B=8, N=4096, bf16."""
    import torch
    g = torch.Generator().manual_seed(SEED + 2)
    b, n = 8, 4096
    image = torch.rand(b, 224, 224, 3, generator=g).to(dev)
    cond = pc2.prepare_cond(pc2.conditioning_map(image))
    cam = camera(b, dev)
    x = (torch.randn(b, n, 3, generator=g) * 0.3).to(dev)
    t = torch.full((b,), 500, dtype=torch.long, device=dev)
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eps = pc2.denoise(x, t, cam, cond)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if eps.shape != (b, n, 3) or not torch.isfinite(eps).all():
        fail(f"denoise step output {tuple(eps.shape)} not finite")
    ms = statistics.median(times[1:]) * 1e3
    print(f"PC2 denoise step B={b} N={n} bf16: {ms:.2f} ms "
          f"(median of {len(times) - 1} after warm-up)")
    return ms


def main_path(pc2, pvd, dev):
    """Phase c: BDM-Blending at full width; returns the launch counts."""
    import torch
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.samplers import NoiseProvider, bdm_blending
    b, n = 2, 4096
    g = torch.Generator().manual_seed(SEED + 3)
    batch = {"image": torch.rand(b, 224, 224, 3, generator=g).to(dev),
             "camera": camera(b, dev)}
    milestones = [50, 48, 46, 44, 6, 4, 2, 0]
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = bdm_blending(pc2, pvd, batch, n, milestones, roll_step=1,
                       noise=NoiseProvider(SEED, dev),
                       num_inference_steps=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    print(f"BDM-B B={b} N={n} bf16, 50 steps, milestones {milestones}: "
          f"{wall:.2f} s wall")
    print("launch counts (kernel, plain on CUDA):", json.dumps(counts))
    if out.shape != (b, n, 3) or not torch.isfinite(out).all():
        fail(f"BDM-B output {tuple(out.shape)} not finite")
    for name, (launches, plain) in counts.items():
        if launches <= 0:
            fail(f"kernel {name} never launched on the main path")
        if plain != 0:
            fail(f"plain version of {name} ran on the card {plain} times")
    return counts, wall


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
    from bdm_tpu_torch.ops import cuda as kernels

    card = smi_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")

    res = check_kernels(dev)
    tiny_parity(dev)
    pc2, pvd = production_models(dev)
    step_ms = denoise_step(pc2, dev)
    counts, wall = main_path(pc2, pvd, dev)

    rows = []
    for name, (mod, source, replaces) in kernels.KERNELS.items():
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=counts[name][0],
                         max_abs_err=res[name]["max_abs_err"],
                         ms=res[name]["ms"], plain_ms=res[name]["plain_ms"]))
    print(json.dumps({"denoise_step_ms": step_ms, "bdm_b_wall_s": wall}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
