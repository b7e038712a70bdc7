"""Benchmark: BDM-Blending (or BDM-Merging) sampling throughput of the port
on one card, the counterpart of the JAX package's `bench.py`.

    python -m bdm_tpu_torch.bench [--sampler merging] [--precision no]
    python -m bdm_tpu_torch.bench --quick --device cpu   # tiny, on the CPU

Prints ONE JSON line to stdout, with bench.py's four keys:
  {"metric": "...", "value": N, "unit": "clouds/sec/chip", "vs_baseline": N}

Measures the whole coupled sampler (PC2 + PVD, and for BDM-Merging the
fusion network, DDPM 1000 steps, milestones [1000, 968, 936, 872, 128, 64,
32, 0], roll 16) at 4096 points and batch 8, with seeded random weights at
the published widths (`tools.standins.production_models`; throughput does
not depend on the weights) and bench.py's synthetic batch
(`tools.standins.synthetic_batch`), bf16 unless `--precision no`. One
warm-up batch, which must be finite, then `--repeats` timed batches, each
on the host clock around a synchronised call with `NoiseProvider(2 + i)`.
The baseline is bench.py's: one cloud in under 2 s a chip, 0.5 clouds/s.
`--quick` runs the tiny models (identity features at image 16,
`TINY_SA` / `TINY_FP`, 64 points, milestones [8, 6, 2, 0], roll 2, 8
steps).

On stderr: every batch's wall with their median, min and max; on the card,
before timing, `kernel_self_check` (each kernel of the path against its
plain version at the path's production shapes, which raises on a
mismatch), and after timing the launches of the timed batches (every kernel
of the path launched, no plain version ran on the card, at bf16 every
attention and conv3d launch took the tensor-core kernel, at float32 the
CUDA-core one: a breach raises); the forwards of each model a batch as
counted by forward hooks, the operations of one forward of each
(`forward_flops`), the achieved rate and its share of the card's peak (MFU,
diagnostics only); the peak device memory and the card's name and power
limit.

The contract: a supervisor runs the bench in a worker subprocess and owns
the one JSON line. It prints it exactly once: on success, on a worker
failure, at `--deadline`, on SIGTERM or SIGINT, and from an `atexit`
backstop; on failure with `value` 0.0 and an "error" key. The
`BDM_BENCH_FAIL` environment variable (assert, oom, segv, hang) injects a
failure into the worker, so the contract is testable without a card.

Deliberate departures from bench.py:
  * `value` is the batch over the MEDIAN wall of the timed batches, not the
    least: the host clock of one port call spreads by +-20 % within one
    process. `--repeats` defaults to 3, not 2.
  * On any failure the process exits non-zero (bench.py exits 0); the
    failure line is printed all the same.
  * No retry at half the batch on running out of memory: a batch of 8
    production clouds needs about 2 GiB of the card's 80, and a halved
    batch is another configuration.
  * None of bench.py's TPU-only parts: no backend probe, no compile-cache
    wipe and retry after a crash, no compile logging.
  * `--device` (default "cuda"): the tests pass "cpu". Without a card and
    without `--device cpu` the worker fails, so the bench never runs on the
    CPU by default.
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

MILESTONES = [1000, 968, 936, 872, 128, 64, 32, 0]
ROLL_STEP = 16
BASELINE_CLOUDS_PER_SEC = 0.5
EXIT_FAILED = 4

# Peak dense rates a second by card name (NVIDIA's data sheet)
H100 = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = {H100: {"bf16": 989e12, "f32": 67e12}}
# XLA's cost analysis of the JAX package's PC2 denoise graph at B 8, N 4096
# (bench.py's `estimate_mfu`): an operation count, printed for reference
XLA_PC2_DENOISE_FLOP_B8 = 7.507e11


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ----------------------------------------------------------- the worker

@contextmanager
def _no_tf32():
    """The plain versions serve as references: no TF32 in them."""
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def kernel_self_check(dev, b: int = 8) -> dict:
    """Hold each kernel of the path against its plain version on the card
    at the path's production shapes (`chip_smoke.py` phase a's shapes and
    tolerances): FPS N 4096 -> 1024, ball query (r 0.1, 32 slots) and
    three-NN on those centres, exact (three-NN's weights within 1e-6 of
    the largest); `interp_mm` N 4096, M 1024, C 128 within one bf16 ulp
    (2^-8) of the largest output; scatter-mean at C 390, R 32 (1e-5
    float32, 8e-3 bf16), conv3d 390 -> 32 at R 32 (1e-4 float32, 1e-2
    bf16) and attention at S 4096, C 64 (1e-4 float32, 1e-2 bf16), each
    relative to the largest plain output. Raises AssertionError on a
    mismatch; -> {check: max|err|}."""
    import torch
    from bdm_tpu_torch import ops
    from bdm_tpu_torch.ops.cuda import (attention, ball_query, conv3d, fps,
                                        interp, three_nn, voxelize)
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    errs = {}

    def hold(what, got, want, tol):
        if tol == 0:
            if not torch.equal(got, want):
                raise AssertionError(f"self-check: {what} differs from its "
                                     f"plain version")
            errs[what] = 0.0
            return
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if not err <= tol * scale:
            raise AssertionError(f"self-check: {what} max|err| {err} > "
                                 f"{tol} * {scale}")
        errs[what] = err

    with _no_tf32():
        pts = randn(b, 4096, 3, scale=0.3)
        idx = fps.furthest_point_sample(pts, 1024)
        hold("fps N4096 M1024", idx,
             fps.furthest_point_sample_plain(pts, 1024), 0)
        centers = ops.gather(pts, idx).contiguous()
        hold("ball_query N4096 M1024", ball_query.ball_query(
            centers, pts, 0.1, 32), ball_query.ball_query_plain(
            centers, pts, 0.1, 32), 0)
        i, w = three_nn.three_nn(pts, centers)
        pi, pw = three_nn.three_nn_plain(pts, centers)
        hold("three_nn indices N4096 M1024", i, pi, 0)
        hold("three_nn weights N4096 M1024", w, pw, 1e-6)
        f = randn(b, 1024, 128, dtype=torch.bfloat16)
        hold("interp_mm N4096 M1024 C128", interp.interp_mm(i, w, f),
             interp.interp_mm_plain(i, w, f), 0)
        ctx = ops.make_voxel_context(pts, 32)
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
            f = randn(b, 4096, 390, dtype=dt)
            args = (f, ctx.order, ctx.ids_sorted, ctx.voxel_lo, 32, dt)
            hold(f"scatter_mean C390 R32 {dt}",
                 voxelize.scatter_mean(*args, ids=ctx.ids),
                 voxelize.scatter_mean_plain(*args), tol)
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            x = randn(b, 32, 32, 32, 390, dtype=dt)
            wt = randn(32, 390, 3, 3, 3, scale=(27 * 390) ** -0.5)
            bias = randn(32, scale=0.1)
            hold(f"conv3d 390->32 R32 {dt}", conv3d.conv3d(x, wt, bias),
                 conv3d.conv3d_plain(x, wt, bias), tol)
            qkv = [randn(b, 4096, 64, scale=0.3, dtype=dt) for _ in range(3)]
            hold(f"attention S4096 C64 {dt}", attention.attention(*qkv),
                 attention.attention_plain(*qkv), tol)
    log("self-check passed: " + json.dumps(errs))
    return errs


def _layer_flops(module, args, out) -> int:
    """The operations of one call of a layer `forward_flops` counts, from
    the shapes of its input (`args[0]`) or output; 0 for the others."""
    import torch.nn as nn
    from bdm_tpu_torch.models.feature_model import _Attn
    from bdm_tpu_torch.models.layers import SE, Attention, Conv1x1
    from bdm_tpu_torch.models.pvcnn import VoxConv
    x = args[0] if args else None
    if isinstance(module, (VoxConv, Conv1x1, nn.Linear)):
        # rows x (Cin x Cout, and 27 taps for the conv)
        return 2 * (x.numel() // x.shape[-1]) * module.weight.numel()
    if isinstance(module, SE):
        b = x.shape[0]
        return 2 * b * sum(module.fc[i].weight.numel() for i in (0, 2))
    if isinstance(module, (Attention, _Attn)):
        b, s, c = x.shape
        return 4 * b * s * s * c
    if isinstance(module, nn.Conv2d):
        return 2 * out.numel() * module.weight[0].numel()
    return 0


def forward_flops(module, call) -> int:
    """The operations (2 a multiply-add) of one `call()` that runs
    `module`, counted by forward hooks on its layers from the shapes each
    sees:
      voxel conv (3x3x3 SAME on the whole grid): 2 B R^3 27 Cin Cout;
      dense and shared-MLP layers (Conv1x1, nn.Linear): 2 rows in out;
      squeeze-excitation: its two bias-free dense layers on (B, C);
      attention, voxel or global (q k^T and p v): 4 B S^2 C, and the
      ViT's: 4 B T^2 D; its patch embedding 2 out Cin p^2.
    Left out: elementwise work, norms, softmax, gathers, the scatter-mean,
    devoxelization, the three-neighbour blend, the geometry kernels'
    distances and, under `precontract`, stage 0's precontracted taps."""
    import torch
    total = [0]

    def note(m, args, out):
        total[0] += _layer_flops(m, args, out)

    hooks = [m.register_forward_hook(note) for m in module.modules()]
    try:
        with torch.inference_mode():
            call()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


class ForwardCounter:
    """Counts the forwards of named modules (a forward hook each)."""

    def __init__(self, **modules):
        self.counts = dict.fromkeys(modules, 0)
        self.hooks = [m.register_forward_hook(
            lambda *_, k=k: self._bump(k)) for k, m in modules.items()]

    def _bump(self, key):
        self.counts[key] += 1

    def reset(self) -> None:
        self.counts = dict.fromkeys(self.counts, 0)

    def close(self) -> None:
        for h in self.hooks:
            h.remove()


def path_kernels(specs, n_points: int, dtype, global_att: bool) -> set:
    """The kernels one forward of a PVCNN2 of `specs` over `n_points`
    points launches on the card, by the dispatch rules of `ops`: FPS and
    ball query at every SA stage, three-NN at every FP stage,
    scatter-mean and conv3d where a stage has PVConvs, attention where a
    site passes `ops.attention.uses_kernel`, `interp_mm` where an FP
    stage's blend passes `ops.interpolate.uses_onehot`, GroupNorm at
    every norm and the gated devoxelization at every PVConv."""
    import torch
    from bdm_tpu_torch.ops.attention import uses_kernel
    from bdm_tpu_torch.ops.interpolate import uses_onehot
    names, levels = {"groupnorm"}, [n_points]
    for stage in specs.sa_stages:
        for conv in stage.convs:
            names |= {"scatter_mean", "conv3d", "devox"}
            if conv.attention and uses_kernel(conv.resolution ** 3,
                                              conv.out_channels):
                names.add("attention")
        names |= {"fps", "ball_query"}
        levels.append(stage.sa.num_centers)
    if global_att and uses_kernel(levels[-1], specs.channels_sa_features):
        names.add("attention")
    for k, stage in enumerate(specs.fp_stages):
        names.add("three_nn")
        if uses_onehot(dtype or torch.float32, levels[-1 - k],
                       levels[-2 - k]):
            names.add("interp_mm")
        if stage.convs:
            names |= {"scatter_mean", "conv3d", "devox"}
    return names


def check_launches(counts: dict, paths: dict, expected: set,
                   float32: bool) -> dict:
    """Every kernel of `expected` launched and no other; no plain version
    ran on the card; every attention and conv3d launch took the
    tensor-core kernel ("tc"), on a float32 path the CUDA-core one
    ("simt"); every blend the vector kernel (the models' widths are
    multiples of 8). Raises AssertionError on a breach; -> the launches,
    those of the kernels with paths also by kernel ("conv3d_tc", ...)."""
    for name, (launches, plain) in counts.items():
        if (launches > 0) != (name in expected):
            raise AssertionError(f"kernel {name} launched {launches} times; "
                                 f"the path's kernels are {sorted(expected)}")
        if plain:
            raise AssertionError(f"the plain version of {name} ran on the "
                                 f"card {plain} times")
    out = {k: v[0] for k, v in counts.items()}
    wrong = {"tc" if float32 else "simt", "scalar"}
    for name, by in paths.items():
        if sum(by.values()) != out[name]:
            raise AssertionError(f"{name}: {by} launches by kernel, "
                                 f"{out[name]} in all")
        if any(by[k] for k in wrong & set(by)):
            raise AssertionError(f"{name} launched {by}: the wrong kernel "
                                 f"for a {'float32' if float32 else 'bf16'} "
                                 f"path")
        out.update({f"{name}_{k}": v for k, v in by.items()})
    return out


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run_once(batch_size: int, points: int, repeats: int, quick: bool,
             precision: str, precontract: bool = False,
             sampler: str = "blending", device: str = "cuda"):
    """One attempt: -> (clouds per second at the median batch, points,
    steps)."""
    import numpy as np
    import torch
    from bdm_tpu_torch.ops import cuda as kernels
    from bdm_tpu_torch.samplers import (NoiseProvider, bdm_blending,
                                        bdm_merging)
    from bdm_tpu_torch.tools.standins import (production_models,
                                              synthetic_batch)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card "
                           "(pass --device cpu to run it on the CPU)")
    if on_card:
        t0 = time.perf_counter()
        kernels.build()
        log(f"kernel build {time.perf_counter() - t0:.1f} s")
        kernel_self_check(dev, batch_size)
    else:
        log("self-check skipped: on the CPU the plain versions are what "
            "runs")
    log(f"models (batch={batch_size}, precision={precision}, "
        f"sampler={sampler}, precontract={precontract}, device={dev})...")
    pc2, pvd, merge = production_models(0, precision, precontract, dev,
                                         quick)
    if quick:
        points, milestones, roll, steps = 64, [8, 6, 2, 0], 2, 8
    else:
        milestones, roll, steps = MILESTONES, ROLL_STEP, 1000
    data = synthetic_batch(batch_size, points, pc2.cfg.image_size,
                           np.random.default_rng(0))
    batch = {"image": data["image"].to(dev),
             "camera": data["camera"].to(dev)}
    kw = dict(num_points=points, milestones=milestones, roll_step=roll,
              num_inference_steps=steps)

    def run(noise):
        if sampler == "merging":
            return bdm_merging(merge, pc2, pvd, batch, noise=noise, **kw)
        return bdm_blending(pc2, pvd, batch, noise=noise, **kw)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # the operations of one forward of each model at this run's shapes
    cond = pc2.prepare_cond(pc2.batch_conditioning(batch))
    x = data["points"].to(dev)
    t = torch.full((batch_size,), 500, dtype=torch.long, device=dev)
    nets = {"pc2": pc2.backbone, "pvd": pvd.model,
            "vit": pc2.feature_model}
    flops = {"pc2": forward_flops(pc2.backbone, lambda: pc2.denoise(
                 x, t, batch["camera"], cond)),
             "pvd": forward_flops(pvd.model, lambda: pvd.model(x, t)),
             "vit": forward_flops(pc2.feature_model,
                                  lambda: pc2.feature_model(batch["image"]))}
    if sampler == "merging":
        nets["fusion"] = merge.fusion
        flops["fusion"] = forward_flops(merge.fusion, lambda: merge.predict(
            x, x, 500, batch["camera"], cond, "fusion_nstep"))
    del cond, x
    counter = ForwardCounter(**nets)

    log("warm-up batch...")
    sync()
    t0 = time.perf_counter()
    out = run(NoiseProvider(1, dev))
    sync()
    log(f"warm-up done in {time.perf_counter() - t0:.3f} s")
    if out.shape != (batch_size, points, 3) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"warm-up output {tuple(out.shape)} is not "
                             f"finite")

    kernels.reset_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    times, forwards = [], []
    for i in range(repeats):
        counter.reset()
        sync()
        t0 = time.perf_counter()
        out = run(NoiseProvider(2 + i, dev))
        sync()
        times.append(time.perf_counter() - t0)
        forwards.append(dict(counter.counts))
        log(f"batch {i}: {times[-1]:.3f} s")
    counter.close()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("timed output is not finite")
    if any(f != forwards[0] for f in forwards):
        raise AssertionError(f"forwards differ between batches: {forwards}")
    med = statistics.median(times)
    log(f"walls {times} s: median {med:.3f}, min {min(times):.3f}, max "
        f"{max(times):.3f}")

    summary = dict(sampler=sampler, batch=batch_size, points=points,
                   steps=steps, precision=precision, precontract=precontract,
                   device=str(dev), walls_s=times, median_s=med,
                   min_s=min(times), max_s=max(times),
                   clouds_per_s=batch_size / med, forwards=forwards[0],
                   gflop_a_forward={k: v / 1e9 for k, v in flops.items()})
    if on_card:
        f32 = pc2.compute_dtype is None
        expected = set()
        for net, specs in ((pc2.backbone, pc2.backbone.specs),
                           (pvd.model, pvd.model.specs)):
            expected |= path_kernels(specs, points, net.dtype,
                                     hasattr(net, "global_att"))
        launches = check_launches(kernels.counts(), kernels.path_counts(),
                                  expected, f32)
        log(f"bench launches: {json.dumps(launches)}")
        summary.update(
            launches=launches,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            card=smi_line())
        log(f"peak device memory of the timed batches "
            f"{summary['peak_memory_gib']:.3f} GiB; card "
            f"{summary['card']}")
    summary.update(mfu_estimate(flops, forwards[0], med, precision, dev,
                                batch_size))
    log(f"bench summary: {json.dumps(summary)}")
    return batch_size / med, points, steps


def mfu_estimate(flops: dict, forwards: dict, seconds: float,
                 precision: str, dev, batch_size: int) -> dict:
    """Diagnostics only: the operations of a batch (each model's forwards
    times its `forward_flops` count) over the median wall, and their share of
    the card's peak for the compute type."""
    import torch
    total = sum(flops[k] * n for k, n in forwards.items())
    achieved = total / seconds
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    peak = PEAK_FLOPS.get(kind, {}).get("f32" if precision == "no"
                                        else "bf16")
    parts = ", ".join(f"{flops[k] / 1e9:.3f} GFLOP a {k} forward x {n}"
                      for k, n in forwards.items())
    line = (f"MFU: {parts}; {total / 1e12:.3f} TFLOP a batch, "
            f"{achieved / 1e12:.3f} TFLOP/s at the median")
    if peak:
        line += (f" against {peak / 1e12:.0f} TFLOP/s ({kind}, "
                 f"{precision}) = {achieved / peak:.3%}")
    else:
        line += f" ({kind}: peak unknown)"
    log(line + f"; for reference, XLA's count of the JAX PC2 denoise graph "
        f"at B 8: {XLA_PC2_DENOISE_FLOP_B8 / 1e9:.1f} GFLOP (an operation "
        f"count, not a speed; this run's PC2 forward at B {batch_size}: "
        f"{flops['pc2'] / 1e9:.1f})")
    return dict(tflop_a_batch=total / 1e12, tflops_achieved=achieved / 1e12,
                mfu=achieved / peak if peak else None)


# ------------------------------------------------ the one-line contract

def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m bdm_tpu_torch.bench",
        description="BDM sampling throughput of the port on one card")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--points", type=int, default=4096)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--precision", default="bf16", choices=["bf16", "no"])
    parser.add_argument("--sampler", default="blending",
                        choices=["blending", "merging"])
    parser.add_argument("--precontract", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument("--deadline", type=float,
                        default=float(os.environ.get("BDM_BENCH_DEADLINE",
                                                     9000.0)),
                        help="wall-clock budget in seconds; the supervisor "
                             "stops the worker and reports 30 s before it")
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    return parser


def result_json(clouds_per_sec: float, points: int, steps: int, batch: int,
                sampler: str = "blending") -> dict:
    name = "BDM-Blending" if sampler == "blending" else "BDM-Merging"
    return {
        "metric": f"{name} sampling throughput ({points} pts, DDPM {steps} "
                  f"steps, batch {batch}, 1 chip)",
        "value": round(clouds_per_sec, 4),
        "unit": "clouds/sec/chip",
        "vs_baseline": round(clouds_per_sec / BASELINE_CLOUDS_PER_SEC, 4),
    }


def _maybe_inject_failure() -> None:
    """Test hook: `BDM_BENCH_FAIL` = assert, oom, segv or hang."""
    mode = os.environ.get("BDM_BENCH_FAIL")
    if not mode:
        return
    if mode == "assert":
        raise AssertionError("injected self-check failure")
    if mode == "oom":
        raise RuntimeError("CUDA out of memory: injected test failure")
    if mode == "hang":
        time.sleep(3600)
    if mode == "segv":
        os.kill(os.getpid(), signal.SIGSEGV)
    raise ValueError(f"unknown BDM_BENCH_FAIL={mode}")


def worker_main(args) -> int:
    """One attempt; the JSON line to stdout on success, else a non-zero
    exit code."""
    try:
        _maybe_inject_failure()
        value, points, steps = run_once(
            args.batch, args.points, args.repeats, args.quick,
            args.precision, args.precontract, args.sampler, args.device)
    except Exception as e:  # noqa: BLE001: the boundary that reports it
        traceback.print_exc()
        log(f"bench worker failed: {type(e).__name__}: {e}")
        return EXIT_FAILED
    print(json.dumps(result_json(value, points, steps, args.batch,
                                 args.sampler)), flush=True)
    return 0


class Supervisor:
    """Owns the one-line contract: a pure-Python poll loop over one
    worker subprocess, so a signal or the deadline is always handled, even
    while the worker is stuck in native code."""

    def __init__(self, args):
        self.args = args
        self.t_start = time.monotonic()
        self.emitted = False
        self.child = None
        self.failure = result_json(0.0, 64 if args.quick else args.points,
                                   8 if args.quick else 1000, args.batch,
                                   args.sampler)
        atexit.register(self.emit, None, "the supervisor exited without a "
                        "result")
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, self._on_signal)

    def remaining(self) -> float:
        return self.args.deadline - (time.monotonic() - self.t_start)

    def emit(self, result, error=None) -> None:
        if self.emitted:
            return
        self.emitted = True
        if result is None:
            result = dict(self.failure, error=error)
        print(json.dumps(result), flush=True)

    def _on_signal(self, signum, frame):
        log(f"supervisor: caught signal {signum}, reporting and exiting")
        if self.child is not None and self.child.poll() is None:
            self.child.terminate()
        self.emit(None, error=f"killed by signal {signum} mid-run")
        os._exit(128 + signum)

    def attempt(self):
        """-> (status, result or None); status is 'ok', 'failed',
        'crashed' or 'deadline'."""
        a = self.args
        cmd = [sys.executable, "-m", "bdm_tpu_torch.bench", "--worker",
               "--batch", str(a.batch), "--points", str(a.points),
               "--repeats", str(a.repeats), "--sampler", a.sampler,
               "--precision", a.precision, "--device", a.device]
        if a.quick:
            cmd.append("--quick")
        if a.precontract:
            cmd.append("--precontract")
        log(f"supervisor: attempt batch={a.batch}, "
            f"{self.remaining():.0f} s of budget left")
        self.child = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=None, text=True,
            cwd=str(Path(__file__).resolve().parents[1]))
        lines = []
        drain = threading.Thread(
            target=lambda: lines.extend(self.child.stdout), daemon=True)
        drain.start()
        while (rc := self.child.poll()) is None:
            if self.remaining() <= 30.0:
                log("supervisor: deadline reached, killing the worker")
                self.child.terminate()
                try:
                    self.child.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    self.child.kill()
                return "deadline", None
            time.sleep(0.5)
        drain.join(timeout=10)
        if rc == 0:
            for line in reversed(lines):
                if line.strip().startswith("{"):
                    try:
                        return "ok", json.loads(line)
                    except json.JSONDecodeError:
                        pass
            log("supervisor: the worker exited 0 but printed no JSON")
            return "failed", None
        return ("crashed" if rc < 0 else "failed"), None

    def run(self) -> int:
        status, result = self.attempt()
        if status == "ok":
            self.emit(result)
            return 0
        error = {"crashed": "worker crashed (killed by a signal; see "
                            "stderr)",
                 "deadline": "deadline reached before a result",
                 "failed": "worker failed (see stderr)"}[status]
        self.emit(None, error=f"{error} at batch {self.args.batch}")
        return 1


def main() -> int:
    args = make_parser().parse_args()
    if args.worker:
        return worker_main(args)
    return Supervisor(args).run()


if __name__ == "__main__":
    sys.exit(main())
