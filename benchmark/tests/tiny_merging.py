"""A tiny cell of the merging driver for the CPU tests: `bdm-merging`'s
structure at `tiny.py`'s toy widths, a short trajectory."""

from __future__ import annotations

import copy
import json

from benchmark import manifest
from benchmark.tests import tiny


def cell(precision: str = "no", **traffic) -> manifest.Cell:
    """A `manifest.Cell` of the repository's `bdm-merging.json` at tiny
    widths: PC2 and PVD as `tiny.cell("sample")` has them, the fusion
    network of PC2's blocks and channels."""
    with open(manifest.ROOT / "benchmark" / "configs"
              / "bdm-merging.json") as f:
        cfg = json.load(f)
    cfg["precision"] = precision
    cfg["pc2"] = copy.deepcopy(tiny.PC2)
    cfg["pvd"] = copy.deepcopy(tiny.PVD)
    cfg["fusion"].update(
        extra_feature_channels=3 + tiny.PC2["vit"]["embed_dim"],
        embed_dim=tiny.PC2["embed_dim"], sa_blocks=copy.deepcopy(tiny.SA),
        fp_blocks=copy.deepcopy(tiny.FP))
    mix = {"kind": "sample", "batch": 2, "points": 64, "image_size": 16,
           "camera": tiny.CAMERA, "num_inference_steps": 1000,
           "roll_step": 16,
           "slices": [[1000, 968, 936, 872, 856], [856, 816, 769]]}
    mix.update(traffic)
    workload = {"name": "tiny-merging", "config": "bdm-merging",
                "traffic": "tiny", "chips": 1}
    return manifest.Cell(manifest.ROOT, {"end_to_end": [], "per_layer": []},
                         workload, {"name": "bdm-merging"}, cfg, mix)
