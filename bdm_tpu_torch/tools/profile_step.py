"""Where one forward's time goes on the card: `torch.profiler` over a few
PC2 denoise steps and fusion forwards at production shape.

    python -m bdm_tpu_torch.tools.profile_step

B=8, N=4096, bf16, production widths, random weights from a seed. For each
of the two forwards it prints one JSON line: the device time a step of
every hand-written kernel and of PyTorch's own kernels together (self
device time summed by kernel name), their launches a step, the host wall
a step under the profiler, the busy share (device time / wall) and the
card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bdm_tpu_torch.tools.standins import camera, production_models

KERNELS = ("conv3d_kernel", "attention_kernel", "fps_kernel",
           "scatter_mean_kernel", "ball_query_kernel", "three_nn_kernel",
           "interp_kernel")
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
    groups = {k: [0.0, 0] for k in (*KERNELS, "pytorch")}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        # kernel rows only: an operator's row repeats its kernels' time
        if evt.device_type != DeviceType.CUDA or us <= 0:
            continue
        name = next((k for k in KERNELS if k in evt.key), "pytorch")
        groups[name][0] += us / 1e3 / STEPS
        groups[name][1] += evt.count / STEPS
    device_ms = sum(ms for ms, _ in groups.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return {"device_ms": device_ms, "wall_ms": wall_ms,
            "busy_share": device_ms / wall_ms,
            "ms": {k: v[0] for k, v in groups.items()},
            "launches": {k: v[1] for k, v in groups.items()}}


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    pc2, _, merge = production_models(0)
    b, n = 8, 4096
    g = torch.Generator().manual_seed(2)
    image = torch.rand(b, 224, 224, 3, generator=g).cuda()
    cond = pc2.prepare_cond(pc2.conditioning_map(image))
    cam = camera(b, "cuda")
    x = (torch.randn(b, n, 3, generator=g) * 0.3).cuda()
    prior = (torch.randn(b, n, 3, generator=g) * 0.3).cuda()
    t = torch.full((b,), 500, dtype=torch.long, device="cuda")
    calls = {
        "pc2_forward": lambda: pc2.denoise(x, t, cam, cond),
        "fusion_forward": lambda: merge.predict(x, prior, 500, cam, cond,
                                                "fusion_nstep"),
    }
    for name, call in calls.items():
        print(json.dumps({"forward": name, "batch": b, "points": n,
                          **breakdown(call), "card": card}), flush=True)


if __name__ == "__main__":
    main()
