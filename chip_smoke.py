#!/usr/bin/env python3
"""Smoke run of bdm_tpu_torch on one NVIDIA GPU: build the Hopper kernels,
check each against its plain PyTorch version, then run the port's two
sampling paths, BDM-Blending and BDM-Merging, at full model width.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  a. every kernel against its plain version at the paths' shapes, float32
     and bfloat16; indices exact, floats under a stated tolerance; median
     times of kernel, plain version and, where one PyTorch call computes
     the same function, that call (CUDA events, after warm-up); the least
     time the card could take for the same work (`bound_ms`);
  d. tiny BDM-Blending and BDM-Merging runs through the kernels against
     the same runs on the CPU through the plain versions, same weights
     (the fusion zero-convs non-zero) and noise;
  b. one PC2 denoise step and one fusion forward at B=8, N=4096, bf16,
     production widths, with the kernel launches of each;
  c. BDM-Blending end to end at production widths (PC2 with ViT-S/16 +
     PVD), B=2, N=4096, bf16, 50 DDPM steps with three interior
     milestones;
  e. BDM-Merging end to end at production widths (PC2 + PVD + the fusion
     network initialised from them, zero-convs non-zero), B=2, N=4096,
     bf16, 50 DDPM steps, five interior milestones with roll step 2, so
     each runs a one-step roll of both branches and a fusion step.
In c and e every kernel must have launched and no plain version may have
run on the card.

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


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def bound(tensors, flops: float, kind: str) -> dict:
    """The least time the card could take: the bytes of `tensors` (each
    input read once, each output written once) over the memory rate, or
    `flops` over the peak rate of `kind`, whichever is larger."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[kind] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


# ------------------------------------------------------------ phase a

def check_kernels(dev):
    """-> {name: {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
    "library_ms"}} at production shapes, B=8. Operation counts: 8 flops a
    squared distance plus the compares of the scan; 2 a multiply-add."""
    import torch
    import torch.nn.functional as F
    from bdm_tpu_torch import ops
    from bdm_tpu_torch.ops.cuda import (attention, ball_query, conv3d, fps,
                                        interp, three_nn, voxelize)

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
    c0, p0 = pts[1024], pts[4096]
    res["fps"] = dict(
        max_abs_err=0.0,
        ms=timed_ms(lambda: fps.furthest_point_sample(p0, 1024)),
        plain_ms=timed_ms(
            lambda: fps.furthest_point_sample_plain(p0, 1024), 3, 1),
        library_ms=None,
        # each of M - 1 rounds: N distances, a min and an argmax compare
        **bound([p0, idx.new_empty((b, 1024))], b * 1023 * 4096 * 10, "f32"))

    for n, m, r in levels:
        a = ball_query.ball_query(pts[m], pts[n], r, 32)
        if not torch.equal(a, ball_query.ball_query_plain(pts[m], pts[n], r,
                                                          32)):
            fail(f"ball_query differs at N={n}, M={m}, r={r}")
    # the scan of a centre may stop at its 32nd hit: count the pairs this
    # data needs, not all M * N
    hits = (fps.sqdist(c0[:, :, None, :], p0[:, None, :, :])
            < torch.tensor(0.1, device=dev) ** 2).cumsum(-1)
    scanned = torch.where(hits[..., -1] >= 32,
                          (hits < 32).sum(-1) + 1, 4096).sum().item()
    res["ball_query"] = dict(
        max_abs_err=0.0,
        ms=timed_ms(lambda: ball_query.ball_query(c0, p0, 0.1, 32)),
        plain_ms=timed_ms(lambda: ball_query.ball_query_plain(c0, p0, 0.1,
                                                              32)),
        library_ms=None,
        **bound([c0, p0, a.new_empty((b, 1024, 32))], scanned * 9, "f32"))

    err = 0.0
    nn = {}
    for n, m, _ in levels:
        i, w = three_nn.three_nn(pts[n], pts[m])
        pi, pw = three_nn.three_nn_plain(pts[n], pts[m])
        if not torch.equal(i, pi):
            fail(f"three_nn indices differ at N={n}, M={m}")
        err = max(err, rel_err(w, pw, 1e-6, f"three_nn weights N={n}"))
        nn[n] = (i, w)
    res["three_nn"] = dict(
        max_abs_err=err,
        ms=timed_ms(lambda: three_nn.three_nn(p0, c0)),
        plain_ms=timed_ms(lambda: three_nn.three_nn_plain(p0, c0)),
        library_ms=None,
        # a distance and one compare against the third-best a pair (an
        # insertion is rare)
        **bound([p0, c0, *nn[4096]], b * 4096 * 1024 * 9, "f32"))

    # the bf16 blend at the two FP stages that take it: (N, M, C); one
    # bf16 ulp (2^-8) of the largest output
    err = 0.0
    by_shape = {}
    for n, m, c in ((1024, 256, 256), (4096, 1024, 128)):
        i, w = nn[n]
        f = randn(b, m, c, dtype=torch.bfloat16)
        out = interp.interp_mm(i, w, f)
        err = max(err, rel_err(out, interp.interp_mm_plain(i, w, f), 2 ** -8,
                               f"interp_mm N={n} M={m} C={c}"))
        by_shape[f"N{n}_M{m}_C{c}"] = timed_ms(
            lambda: interp.interp_mm(i, w, f), inner=20)
    # one PyTorch call for the same blend: a weighted embedding bag over
    # the flattened (B*M, C) table
    flat = (i.long() + torch.arange(b, device=dev)[:, None, None] * m
            ).reshape(-1, 3)
    wb = w.to(torch.bfloat16).reshape(-1, 3)
    table = f.reshape(b * m, c)
    lib = F.embedding_bag(flat, table, per_sample_weights=wb, mode="sum")
    rel_err(lib.reshape(out.shape), out, 2 ** -7, "embedding_bag yardstick")
    res["interp_mm"] = dict(
        max_abs_err=err,
        ms=by_shape["N4096_M1024_C128"], ms_by_shape=by_shape,
        # unlike the other rows: inputs and the recycled output stay in L2
        timing="20 launches back to back behind a matmul, warm L2",
        plain_ms=timed_ms(lambda: interp.interp_mm_plain(i, w, f)),
        library_ms=timed_ms(lambda: F.embedding_bag(
            flat, table, per_sample_weights=wb, mode="sum"), inner=20),
        # three multiply-adds a channel, not the one-hot product's 2*M
        **bound([i, w, f, out], b * n * c * 6, "f32"))

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
    grid0 = voxelize.scatter_mean(*vargs)
    # one PyTorch call: `index_add_` of the sorted, pre-divided rows into
    # a zeroed float32 grid
    cnt = torch.gather(ctx0.voxel_lo[:, 1:] - ctx0.voxel_lo[:, :-1], 1,
                       ctx0.ids_sorted.long()).float()
    rows = (torch.gather(f0, 1, ctx0.order.long()[..., None].expand_as(f0))
            .float() / cnt[..., None]).reshape(-1, 390)
    dst = (ctx0.ids_sorted.long()
           + torch.arange(b, device=dev)[:, None] * 32 ** 3).reshape(-1)
    acc = torch.empty((b * 32 ** 3, 390), device=dev)
    res["scatter_mean"] = dict(
        max_abs_err=err, ms=timed_ms(lambda: voxelize.scatter_mean(*vargs)),
        plain_ms=timed_ms(lambda: voxelize.scatter_mean_plain(*vargs)),
        library_ms=timed_ms(lambda: acc.zero_().index_add_(0, dst, rows)),
        # a divide and an add a feature
        **bound([f0, ctx0.order, ctx0.voxel_lo, grid0], b * 4096 * 390 * 2,
                "f32"))

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

    def conv_times(cin, cout, r):
        """Kernel, plain and one-call (cuDNN, bf16, channels-last) times
        and the bound of one bf16 conv; the one call must agree."""
        x = randn(b, r, r, r, cin, dtype=torch.bfloat16)
        wt = randn(cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        y = conv3d.conv3d(x, wt, bias)
        xl = x.permute(0, 4, 1, 2, 3)
        wl = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d)
        bl = bias.to(torch.bfloat16)
        rel_err(F.conv3d(xl, wl, bl, padding=1).permute(0, 2, 3, 4, 1), y,
                2e-2, f"F.conv3d bf16 yardstick {cin}->{cout}")
        return dict(
            ms=timed_ms(lambda: conv3d.conv3d(x, wt, bias)),
            plain_ms=timed_ms(lambda: conv3d.conv3d_plain(x, wt, bias)),
            library_ms=timed_ms(lambda: F.conv3d(xl, wl, bl, padding=1)),
            **bound([x, wt, bias, y], 2 * 27 * cin * cout * r ** 3 * b,
                    "bf16"))

    # timed at PC2's wide stage-0 conv (the TPU's conv3d_mm) and at the
    # largest narrow one (conv3d_ms): the last FP stage's 64 -> 64, R 32
    res["conv3d"] = dict(max_abs_err=err, **conv_times(390, 32, 32),
                         narrow_64_64_r32=conv_times(64, 64, 32))

    err = 0.0
    qkv = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        q, k, v = (randn(b, 4096, 64, scale=0.3, dtype=dt) for _ in range(3))
        qkv[dt] = (q, k, v)
        err = max(err, rel_err(attention.attention(q, k, v),
                               attention.attention_plain(q, k, v), tol,
                               f"attention {dt}"))
    qb = qkv[torch.bfloat16]
    ob = attention.attention(*qb)
    # one PyTorch call: fused attention with the scale the layer uses (1)
    qh = [t[:, None] for t in qb]
    rel_err(F.scaled_dot_product_attention(*qh, scale=1.0)[:, 0], ob, 2e-2,
            "scaled_dot_product_attention yardstick")
    res["attention"] = dict(
        max_abs_err=err, ms=timed_ms(lambda: attention.attention(*qb)),
        plain_ms=timed_ms(lambda: attention.attention_plain(*qb)),
        library_ms=timed_ms(
            lambda: F.scaled_dot_product_attention(*qh, scale=1.0)),
        # q k^T and p v: two products of 2 * S * S * C
        **bound([*qb, ob], 4 * 4096 ** 2 * 64 * b, "bf16"))
    for name, r in res.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"kernel {name}: max_abs_err {r['max_abs_err']:.3e}  "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}  bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})")
    print("conv3d 64->64 R=32 bf16:",
          json.dumps(res["conv3d"]["narrow_64_64_r32"]))
    print("interp_mm by shape, ms:",
          json.dumps(res["interp_mm"]["ms_by_shape"]))
    return res


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


def tiny_parity(dev):
    """Phase d: tiny BDM-Blending and BDM-Merging on the card (kernels) vs
    on the CPU (plain versions); 1e-3 absolute, as the CPU tests hold the
    port to the JAX reference."""
    import torch
    from bdm_tpu_torch.samplers import (BDMMergingModel, PC2Model,
                                        ProjectionConfig, PVDModel,
                                        bdm_blending, bdm_merging)
    from bdm_tpu_torch.tools.standins import camera, live_zero_convs
    sa = (((8, 2, 4), (16, 0.3, 8, (8, 16))),
          ((16, 2, 4), (8, 0.4, 8, (16, 32))),
          (None, (4, 0.8, 8, (32, 64))))
    fp = (((32, 32), (16, 1, 4)), ((16, 16), (16, 1, 4)),
          ((16, 8), (8, 1, 4)))
    cfg = ProjectionConfig(image_size=16, image_feature_model="identity",
                           raster_point_radius=0.3,
                           point_cloud_model_embed_dim=8)
    outs = {"BDM-B": [], "BDM-M": []}
    image = torch.rand(2, 16, 16, 3,
                       generator=torch.Generator().manual_seed(1))
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
    for name, (cpu, card) in outs.items():
        err = (cpu - card).abs().max().item()
        print(f"tiny {name}, kernels vs CPU plain: max|err| {err:.3e}")
        if not (torch.isfinite(card).all() and err < 1e-3):
            fail(f"tiny {name} on the card differs from the CPU run: {err}")


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
            kernels.reset_counts()
            t0 = time.perf_counter()
            eps = call()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if eps.shape != (b, n, 3) or not torch.isfinite(eps).all():
            fail(f"{name} output {tuple(eps.shape)} not finite")
        ms = statistics.median(times[1:]) * 1e3
        launches = {k: v[0] for k, v in kernels.counts().items()}
        print(f"{name} B={b} N={n} bf16: {ms:.2f} ms (median of "
              f"{len(times) - 1} after warm-up); launches "
              f"{json.dumps(launches)}")
        out[name] = dict(ms=ms, launches=launches)
    return out


def sampler_path(name, run, milestones, roll_step, dev):
    """Phases c and e: one sampler end to end at full width, B=2, N=4096,
    50 DDPM steps; returns the launch counts and the wall time."""
    import torch
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.samplers import NoiseProvider
    from bdm_tpu_torch.tools.standins import camera
    b, n = 2, 4096
    g = torch.Generator().manual_seed(SEED + 3)
    batch = {"image": torch.rand(b, 224, 224, 3, generator=g).to(dev),
             "camera": camera(b, dev)}
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = run(batch, n, milestones, roll_step, noise=NoiseProvider(SEED),
              num_inference_steps=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    print(f"{name} B={b} N={n} bf16, 50 steps, milestones {milestones}, "
          f"roll {roll_step}: {wall:.2f} s wall")
    print("launch counts (kernel, plain on CUDA):", json.dumps(counts))
    if out.shape != (b, n, 3) or not torch.isfinite(out).all():
        fail(f"{name} output {tuple(out.shape)} not finite")
    for kernel, (launches, plain) in counts.items():
        if launches <= 0:
            fail(f"kernel {kernel} never launched on the {name} path")
        if plain != 0:
            fail(f"plain version of {kernel} ran on the card {plain} times")
    return {k: v[0] for k, v in counts.items()}, wall


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
    from functools import partial

    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.samplers import bdm_blending, bdm_merging
    from bdm_tpu_torch.tools.standins import production_models

    card = smi_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")

    res = check_kernels(dev)
    tiny_parity(dev)
    pc2, pvd, merge = production_models(SEED)
    fwd = forwards(pc2, merge, dev)
    blend, blend_wall = sampler_path(
        "BDM-B", partial(bdm_blending, pc2, pvd),
        [50, 48, 46, 44, 6, 4, 2, 0], 1, dev)
    merged, merge_wall = sampler_path(
        "BDM-M", partial(bdm_merging, merge, pc2, pvd),
        [50, 46, 42, 38, 12, 8, 4, 0], 2, dev)

    rows = []
    for name, (mod, source, replaces) in kernels.KERNELS.items():
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=blend[name],   # BDM-Blending's, as before BDM-Merging
            launches_by_path=dict(
                bdm_blending=blend[name], bdm_merging=merged[name],
                pc2_forward=fwd["pc2_forward"]["launches"][name],
                fusion_forward=fwd["fusion_forward"]["launches"][name]),
            **res[name]))
    print(json.dumps({"denoise_step_ms": fwd["pc2_forward"]["ms"],
                      "fusion_forward_ms": fwd["fusion_forward"]["ms"],
                      "bdm_b_wall_s": blend_wall,
                      "bdm_m_wall_s": merge_wall}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
