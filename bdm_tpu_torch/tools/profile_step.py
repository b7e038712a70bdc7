"""Where one step's time goes on the card: `torch.profiler` over a few
PC2 denoise steps, fusion forwards and PC2 training steps at production
shape.

    python -m bdm_tpu_torch.tools.profile_step

B=8, N=4096, production widths, random weights from a seed; the forwards
at bf16, the training step (forward, backward, clip, AdamW, EMA) in
float32 and at bf16 compute. For each case it prints one JSON line: the
device time a step of every hand-written kernel, of cuDNN's convolution
kernels (the conv's backward) and of PyTorch's other kernels together
(self device time summed by kernel name), their launches a step, the host
wall a step under the profiler, the busy share (device time / wall), for
a training step the peak memory, and the card's name and power limit. For
each training step one more line breaks its conv3d forwards down by shape:
the launches a step of each (Cin, Cout, R, batch, dtype) and that conv's
kernel time alone (CUDA events, median of 5 after warm-up, fresh random
inputs). A last line times the attention's backward rule alone (CUDA
events).
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bdm_tpu_torch.samplers import PC2Model, ProjectionConfig, TrainNoise
from bdm_tpu_torch.tools.standins import (camera, production_models,
                                          training_batches)
from bdm_tpu_torch.train import (create_train_state, make_optimizer,
                                 make_train_step, pc2_freeze_mask)

# a kernel falls in the first group whose name its own name carries; the
# sources name their kernels after themselves, so the prefixes "scatter_sum"
# and "ball_query" gather every kernel of scatter_sum.cu (count, scan,
# place, run) and of ball_query.cu
KERNELS = ("conv3d_wgmma_kernel", "conv3d_simt_kernel",
           "conv3d_simt_halo_kernel", "attention_tc_kernel",
           "attention_simt_kernel", "fps_kernel",
           "scatter_mean_kernel", "scatter_sum", "ball_query",
           "three_nn_kernel", "interp_kernel")
# cuDNN's convolution kernels by the words their names carry
CUDNN = ("cudnn", "wgrad", "dgrad", "xmma", "convolve", "implicit_gemm")
STEPS = 3


def breakdown(call) -> dict:
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    groups = {k: [0.0, 0] for k in (*KERNELS, "cudnn_conv", "pytorch")}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        # kernel rows only: an operator's row repeats its kernels' time
        if evt.device_type != DeviceType.CUDA or us <= 0:
            continue
        name = next((k for k in KERNELS if k in evt.key), None) or (
            "cudnn_conv" if any(w in evt.key.lower() for w in CUDNN)
            else "pytorch")
        groups[name][0] += us / 1e3 / STEPS
        groups[name][1] += evt.count / STEPS
    device_ms = sum(ms for ms, _ in groups.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return {"device_ms": device_ms, "wall_ms": wall_ms,
            "busy_share": device_ms / wall_ms,
            "ms": {k: v[0] for k, v in groups.items()},
            "launches": {k: v[1] for k, v in groups.items()}}


def train_step_call(mixed_precision: str, b: int, n: int):
    """-> a call that takes one PC2 training step (a new seeded batch each
    time) with the reference optimizer and the EMA."""
    pc2 = PC2Model(ProjectionConfig(mixed_precision=mixed_precision))
    pc2.reset_parameters(0)
    state = create_train_state(pc2, make_optimizer(pc2_freeze_mask(pc2)),
                               use_ema=True)
    step = make_train_step(pc2.loss)
    batches = training_batches(5, b, n, "cuda")
    noise = TrainNoise(0, "cuda")
    return lambda: step(state, next(batches), noise)


def conv3d_by_shape(call) -> list:
    """The conv3d forwards of one `call()` by shape: launches, the kernel
    time of one launch at that shape and their product."""
    from bdm_tpu_torch.ops.cuda import conv3d
    seen = collections.Counter()
    inner = conv3d._forward

    def noting(x, weight, bias):
        seen[(x.shape[-1], weight.shape[0], x.shape[1], x.shape[0],
              x.dtype)] += 1
        return inner(x, weight, bias)

    conv3d._forward = noting
    try:
        call()
        torch.cuda.synchronize()
    finally:
        conv3d._forward = inner
    g = torch.Generator().manual_seed(4)
    rows = []
    for (cin, cout, r, b, dtype), launches in sorted(
            seen.items(), key=lambda kv: -kv[0][0] * kv[0][1] * kv[0][2] ** 3):
        x = torch.randn(b, r, r, r, cin, generator=g).to("cuda", dtype)
        w = (torch.randn(cout, cin, 3, 3, 3, generator=g)
             * (27 * cin) ** -0.5).cuda()
        bias = torch.randn(cout, generator=g).cuda()
        times = []
        for _ in range(7):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            conv3d.conv3d(x, w, bias)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times[2:])
        rows.append({"cin": cin, "cout": cout, "r": r, "batch": b,
                     "dtype": str(dtype).replace("torch.", ""),
                     "launches": launches, "ms": ms,
                     "total_ms": ms * launches})
    return rows


def attention_backward_ms(dtype) -> float:
    """The attention's backward rule alone at the path's shape (B=8,
    S=4096, C=64), median of 5 after warm-up."""
    from bdm_tpu_torch.ops.cuda import attention
    g = torch.Generator().manual_seed(3)
    q, k, v = ((torch.randn(8, 4096, 64, generator=g) * 0.3).to(
        "cuda", dtype).requires_grad_() for _ in range(3))
    cot = torch.randn(8, 4096, 64, generator=g).to("cuda", dtype)
    times = []
    for _ in range(7):
        out = attention.attention(q, k, v)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out.backward(cot)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times[2:])[2]


def forward_calls(b: int = 8, n: int = 4096) -> dict:
    """PC2's denoise and the fusion model's prediction at production
    widths (bf16, random weights from seed 0), B `b`, N `n`: name -> a
    call of one forward."""
    pc2, _, merge = production_models(0)
    g = torch.Generator().manual_seed(2)
    image = torch.rand(b, 224, 224, 3, generator=g).cuda()
    cond = pc2.prepare_cond(pc2.conditioning_map(image))
    cam = camera(b, "cuda")
    x = (torch.randn(b, n, 3, generator=g) * 0.3).cuda()
    prior = (torch.randn(b, n, 3, generator=g) * 0.3).cuda()
    t = torch.full((b,), 500, dtype=torch.long, device="cuda")
    return {
        "pc2_forward": torch.inference_mode()(
            lambda: pc2.denoise(x, t, cam, cond)),
        "fusion_forward": torch.inference_mode()(
            lambda: merge.predict(x, prior, 500, cam, cond, "fusion_nstep")),
    }


def gaps_before(call, kernel: str, steps: int = STEPS) -> dict:
    """Under the profiler, `steps` `call()`s after two of warm-up: for every
    launch of the device kernel whose name holds `kernel`, the device
    event that started last before it on the card, and the gap from that
    event's end to its start (us; 0 or less where the two overlapped).
    -> launches a call, the events before it by name, the gaps' least,
    median and largest, and how many were 0 or less."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            call()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not dev:
        raise RuntimeError("the profiler recorded no device time")
    gaps, before = [], collections.Counter()
    for prev, evt in zip(dev, dev[1:]):
        if kernel in evt.name:
            gaps.append(evt.time_range.start - prev.time_range.end)
            before[prev.name[:60]] += 1
    if not gaps:
        raise RuntimeError(f"no launch of {kernel} in the trace")
    return {"kernel": kernel, "launches": len(gaps) / steps,
            "before": dict(before), "gap_us_min": min(gaps),
            "gap_us_median": statistics.median(gaps),
            "gap_us_max": max(gaps),
            "overlapped": sum(gap <= 0 for gap in gaps)}


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    b, n = 8, 4096
    calls = forward_calls(b, n)
    for name, call in calls.items():
        print(json.dumps({"forward": name, "batch": b, "points": n,
                          **breakdown(call), "card": card}), flush=True)
    del calls
    for mp in ("no", "bf16"):
        torch.cuda.empty_cache()
        call = train_step_call(mp, b, n)
        torch.cuda.reset_peak_memory_stats()
        out = breakdown(call)
        print(json.dumps({
            "train_step": f"pc2_{mp}", "batch": b, "points": n, **out,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "card": card}), flush=True)
        print(json.dumps({"train_step": f"pc2_{mp}",
                          "conv3d_forward_by_shape": conv3d_by_shape(call),
                          "card": card}), flush=True)
        del call
    print(json.dumps({"attention_backward_ms": {
        "float32": attention_backward_ms(torch.float32),
        "bfloat16": attention_backward_ms(torch.bfloat16)},
        "card": card}), flush=True)


if __name__ == "__main__":
    main()
