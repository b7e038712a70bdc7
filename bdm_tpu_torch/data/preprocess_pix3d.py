"""Pix3D preprocessing: build the `pix3d_processed/` tree
(`bdm_tpu/data/preprocess_pix3d.py`, copied).

Rebuild of `experiments/data/Pix3D/preprocess_pix3d.py`: for every entry,
(1) crop the image to the squared bbox and resize, (2) sample `num_points`
points uniformly by area from the mesh surface, write both to a sibling
`pix3d_processed/` directory so `Pix3DDataset(processed=True)` can load
them. Mesh sampling is numpy (area-weighted triangle sampling) — no
pytorch3d/trimesh needed.

Usage: python -m bdm_tpu_torch.data.preprocess_pix3d --root /path/to/pix3d
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_obj_mesh(path: str):
    """Parse vertices and triangle faces from an OBJ file (fan-triangulates
    polygons; ignores materials/normals)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, dtype=np.float64),
            np.asarray(faces, dtype=np.int64))


def sample_points_from_mesh(verts: np.ndarray, faces: np.ndarray,
                            num_points: int, rng: np.random.Generator
                            ) -> np.ndarray:
    """Uniform-by-area surface sampling (the semantics of pytorch3d's
    `sample_points_from_meshes` used by the reference)."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / areas.sum()
    tri = rng.choice(len(faces), size=num_points, p=probs)
    u, v = rng.random(num_points), rng.random(num_points)
    flip = (u + v) > 1.0
    u[flip], v[flip] = 1.0 - u[flip], 1.0 - v[flip]
    return (v0[tri] + u[:, None] * (v1[tri] - v0[tri])
            + v[:, None] * (v2[tri] - v0[tri]))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True, help="pix3d root dir")
    parser.add_argument("--pc_dict", default="pix3d.json")
    parser.add_argument("--num_points", type=int, default=4096)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--category", default=None,
                        help="restrict to one category")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    from PIL import Image

    out_root = args.root.rstrip("/").replace("pix3d", "pix3d_processed")
    rng = np.random.default_rng(args.seed)
    with open(os.path.join(args.root, args.pc_dict)) as f:
        entries = json.load(f)
    if args.category:
        entries = [e for e in entries if e["category"] == args.category]

    done_models = set()
    for e in entries:
        # image: square bbox crop + resize
        x0, y0, x1, y1 = e["bbox"]
        cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        half = max(y1 - y0, x1 - x0) / 2.0
        img = Image.open(os.path.join(args.root, e["img"]))
        img = img.crop((cx - half, cy - half, cx + half, cy + half)).resize(
            (args.image_size, args.image_size))
        if img.mode != "RGB":
            img = img.convert("RGB")
        img_out = os.path.join(out_root, e["img"])
        os.makedirs(os.path.dirname(img_out), exist_ok=True)
        img.save(img_out)

        # mesh -> sampled points, saved once per model as .obj vertices
        if e["model"] not in done_models:
            done_models.add(e["model"])
            verts, faces = load_obj_mesh(os.path.join(args.root, e["model"]))
            pts = sample_points_from_mesh(verts, faces, args.num_points, rng)
            model_out = os.path.join(out_root, e["model"])
            os.makedirs(os.path.dirname(model_out), exist_ok=True)
            with open(model_out, "w") as f:
                f.writelines(f"v {p[0]} {p[1]} {p[2]}\n" for p in pts)
    print(f"Wrote processed Pix3D tree to {out_root}")


if __name__ == "__main__":
    main()
