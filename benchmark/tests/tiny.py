"""A tiny cell of each driver for the CPU tests: the production
configuration's structure at toy widths, a short trajectory."""

from __future__ import annotations

import copy
import json

from benchmark import manifest

SA = [[[8, 2, 4], [16, 0.3, 8, [8, 16]]],
      [[16, 2, 4], [8, 0.4, 8, [16, 32]]],
      [None, [4, 0.8, 8, [32, 64]]]]
FP = [[[32, 32], [16, 1, 4]], [[16, 16], [16, 1, 4]], [[16, 8], [8, 1, 4]]]
PC2 = {"image_size": 16, "image_feature_model": "tiny",
       "vit": {"patch_size": 8, "embed_dim": 24, "depth": 1, "num_heads": 2},
       "embed_dim": 16, "dropout": 0.1, "raster_point_radius": 0.3,
       "beta_start": 1e-05, "beta_end": 0.008, "sa_blocks": SA,
       "fp_blocks": FP}
PVD = {"embed_dim": 16, "use_att": True, "dropout": 0.1,
       "beta_start": 0.0001, "beta_end": 0.02,
       "model_var_type": "fixedsmall", "sa_blocks": SA, "fp_blocks": FP}
CAMERA = {"distance": 1.5, "focal_length": 2.1875}


def cell(kind: str, precision: str = "no", **traffic) -> manifest.Cell:
    """A `manifest.Cell` of the repository's configuration file for the
    kind ("sample": `bdm-blending`, "train": `pc2`) at tiny widths."""
    name = "bdm-blending" if kind == "sample" else "pc2"
    with open(manifest.ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["precision"] = precision
    cfg["pc2"] = copy.deepcopy(PC2)
    if kind == "sample":
        cfg["pvd"] = copy.deepcopy(PVD)
        mix = {"kind": "sample", "batch": 2, "points": 64, "image_size": 16,
               "camera": CAMERA, "num_inference_steps": 1000,
               "roll_step": 16,
               "slices": [[1000, 968, 936, 872, 856], [856, 816, 769]]}
    else:
        mix = {"kind": "train", "batch": 2, "points": 64, "image_size": 16,
               "camera": dict(CAMERA, distance=1.75), "radius": 0.5}
    mix.update(traffic)
    workload = {"name": f"tiny-{kind}", "config": name, "traffic": "tiny",
                "chips": 1}
    return manifest.Cell(manifest.ROOT, {"end_to_end": [], "per_layer": []},
                         workload, {"name": name}, cfg, mix)
