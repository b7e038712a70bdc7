"""Where the BDM-Blending CLI's time goes beside the sampler, on the card.

    python -m bdm_tpu_torch.tools.cli_breakdown [--rounds 2]

In one process, at `chip_smoke.py` phase l's settings (synthetic data,
production widths, B 2, N 4096, bf16, 50 DDPM steps, phase c's
milestones): `bdm_tpu_torch.main_blending.main` as a user runs it, with the
loader's prefetch thread (`dataloader.num_workers=6`, the default) and
without it (0), in turns with a direct `bdm_blending` call on models built
once by the same builders and one batch of the same loader. Each run's
sampler call is timed between `torch.cuda.synchronize()`s, with the
Python garbage collector's pauses inside it and the conv weight packs it
made. The first run of the process is a CLI run, as a user's is. Prints one
JSON line with the card's name and power limit. Run it from the
repository's root: it imports `chip_smoke`.
"""

from __future__ import annotations

import argparse
import gc
import json
import tempfile
import time

import torch

import bdm_tpu_torch.main_blending as blend_cli
from bdm_tpu_torch.bench import smi_line
from bdm_tpu_torch.cli import build_pc2, build_pvd, resolve_milestones
from bdm_tpu_torch.config import parse_cli
from bdm_tpu_torch.data import batch_to_device, get_dataset
from bdm_tpu_torch.ops import cuda as kernels
from bdm_tpu_torch.samplers import NoiseProvider, bdm_blending
from chip_smoke import CLI_ARGS, CLI_BLEND, PartTimes   # run from the root


class GcPauses:
    """Seconds the garbage collector ran while the block ran."""

    def __enter__(self):
        self.s, self.t0 = 0.0, None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.t0 is not None:
            self.s += time.perf_counter() - self.t0
            self.t0 = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    card = smi_line()
    kernels.build()
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="cli_breakdown_")
    argv = CLI_ARGS + CLI_BLEND + [
        "run.job=sample_bdm_blending", "run.name=bdm_b",
        f"run.save_dir={tmp}"]
    cfg = parse_cli(argv)

    def cli(workers):
        with PartTimes(blend_cli, ("bdm_blending",)) as parts:
            blend_cli.main(argv + [f"dataloader.num_workers={workers}"])
        return parts.s["bdm_blending"]

    models = batch = None

    def direct():
        nonlocal models, batch
        if models is None:
            models = build_pc2(cfg), build_pvd(cfg)
            batch = batch_to_device(next(iter(get_dataset(cfg)[1])), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bdm_blending(*models, batch, num_points=cfg.dataset.max_points,
                     milestones=resolve_milestones(cfg),
                     roll_step=cfg.aux_run.roll_step,
                     noise=NoiseProvider(cfg.run.seed, dev),
                     num_inference_steps=cfg.run.num_inference_steps)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    runs = {"cli_prefetch": lambda: cli(6), "cli_no_prefetch": lambda: cli(0),
            "direct": direct}
    order = ["cli_prefetch", "direct"] + [
        name for _ in range(args.rounds) for name in
        ("direct", "cli_prefetch", "cli_no_prefetch", "cli_no_prefetch",
         "cli_prefetch", "direct")]
    rows = []
    for name in order:
        packs = kernels.tally()["conv3d", "packs"]
        with GcPauses() as pauses:
            sampler_s = runs[name]()
        rows.append(dict(run=name, sampler_s=sampler_s, gc_s=pauses.s,
                         conv3d_packs=kernels.tally()["conv3d", "packs"]
                         - packs))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"card": card, "runs": rows}))


if __name__ == "__main__":
    main()
