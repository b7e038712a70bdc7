"""One production-shape sampling run of the port on the card, timed.

    python -m bdm_tpu_torch.tools.production_sample

BDM-Blending and BDM-Merging each run once at the shape `bench.py` uses for the JAX
package: batch 8, 4096 points, bf16, DDPM with 1000 steps, milestones
[1000, 968, 936, 872, 128, 64, 32, 0], roll step 16, PC2 (ViT-S/16) + PVD
(+ the fusion network initialised from them, zero-convs seeded non-zero,
for BDM-Merging). Weights are random from a seed; throughput does not depend
on them. Prints, for each run, one JSON line with the wall time (host
clock around a synchronised run), clouds per second, peak device memory,
every kernel's launches (those of attention and conv3d also by kernel,
tensor-core against CUDA-core) and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from bdm_tpu_torch.ops import cuda as kernels
from bdm_tpu_torch.samplers import NoiseProvider, bdm_blending, bdm_merging
from bdm_tpu_torch.tools.standins import camera, production_models

MILESTONES = [1000, 968, 936, 872, 128, 64, 32, 0]
ROLL_STEP = 16
BATCH, POINTS, SEED = 8, 4096, 0


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    pc2, pvd, merge = production_models(SEED)
    b = BATCH
    g = torch.Generator().manual_seed(SEED + 4)
    batch = {"image": torch.rand(b, 224, 224, 3, generator=g).cuda(),
             "camera": camera(b, "cuda")}
    kernels.build()
    runs = {"blending": lambda **kw: bdm_blending(pc2, pvd, **kw),
            "merging": lambda **kw: bdm_merging(merge, pc2, pvd, **kw)}
    for name in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = runs[name](batch=batch, num_points=POINTS,
                         milestones=MILESTONES, roll_step=ROLL_STEP,
                         noise=NoiseProvider(SEED))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.counts()
        print(json.dumps({
            "sampler": name, "batch": b, "points": POINTS,
            "wall_s": wall, "clouds_per_s": b / wall,
            "finite": bool(torch.isfinite(out).all()),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: v[0] for k, v in counts.items()},
            "launches_by_kernel": kernels.path_counts(),
            "plain_on_card": sum(v[1] for v in counts.values()),
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
