"""Pix3D dataset (lazy, per-item; `bdm_tpu/data/pix3d.py`, on the port's
cameras).

Rebuild of `experiments/dataset/pix3d.py`:
  * per-category 80/20 train/test split in json order (`pix3d.py:52-63`)
  * per-shape normalization: mean over points, ONE scalar std over all
    coordinates (`:91-93`)
  * v2->v1 axis remap (x, y, z) <- (-z, y, x) (`:96-103` — note the sign
    differs from the R2N2 remap)
  * OpenCV -> PyTorch3D camera with bbox-crop-adjusted intrinsics and
    screen-space (in_ndc=False) convention (`:106-159`)
  * `processed=True` reads pre-cropped images / pre-sampled point clouds
    from a sibling `pix3d_processed/` tree (see
    `bdm_tpu_torch/data/preprocess_pix3d.py`).

No trimesh/pytorch3d dependency: OBJ/PLY/NPY vertices are parsed directly.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from bdm_tpu_torch.conditioning.cameras import camera_from_screen

V2_TO_V1 = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], dtype=np.float64)
OPENCV_TO_PYTORCH3D = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]],
                               dtype=np.float64)


def load_points(path: str) -> np.ndarray:
    """Load vertices from .npy / .obj / .ply (ascii)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float64)
    if path.endswith(".obj"):
        pts = []
        with open(path) as f:
            for line in f:
                if line.startswith("v "):
                    pts.append([float(x) for x in line.split()[1:4]])
        return np.asarray(pts, dtype=np.float64)
    if path.endswith(".ply"):
        return _load_ply_vertices(path)
    raise ValueError(f"Unsupported point file: {path}")


def _load_ply_vertices(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header
                 if h.startswith("element vertex"))
        fmt = next(h.split()[1] for h in header if h.startswith("format"))
        props = [h.split()[-1] for h in header
                 if h.startswith("property") and "list" not in h]
        if fmt == "ascii":
            rows = [f.readline().split()[:3] for _ in range(n)]
            return np.asarray(rows, dtype=np.float64)
        dtype = np.dtype([(p, "<f4") for p in props]) if fmt == \
            "binary_little_endian" else np.dtype([(p, ">f4") for p in props])
        data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        return np.stack([data["x"], data["y"], data["z"]],
                        axis=1).astype(np.float64)


class Pix3DDataset:
    def __init__(self, root_dir: str, pc_dict: str = "pix3d.json",
                 category: str = "chair", split: str = "train",
                 max_points: int = 4096, image_size: int = 224,
                 subset_ratio: float = 1.0, processed: bool = True,
                 seed: int = 0):
        assert split in ("train", "test"), split
        with open(os.path.join(root_dir, pc_dict)) as f:
            entries = json.load(f)
        cat = [x for x in entries if x["category"] == category]
        if split == "train":
            cat = cat[: int(len(cat) * 0.8)]
            if subset_ratio != 1.0:
                cat = cat[: int(len(cat) * subset_ratio)]
        else:
            cat = cat[int(len(cat) * 0.8):]
        self.data = cat
        self.root_dir = root_dir
        self.processed_root_dir = root_dir.replace("pix3d", "pix3d_processed")
        self.processed = processed
        self.max_points = max_points
        self.image_size = image_size
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int):
        sample = self.data[idx]

        if self.processed:
            model_path = os.path.join(self.processed_root_dir,
                                      sample["model"])
            pts = load_points(model_path)
        else:
            model_path = os.path.join(self.root_dir, sample["model"])
            pts = load_points(model_path)
            if pts.shape[0] > self.max_points:
                sel = self.rng.choice(pts.shape[0], self.max_points,
                                      replace=False)
                pts = pts[sel]

        # per-shape normalization: scalar std over the flattened cloud
        m = pts.mean(axis=0)
        s = float(pts.reshape(-1).std())
        pts_norm = (pts - m) / s
        pts_v1 = (V2_TO_V1 @ pts_norm.T).T.astype(np.float32)

        r = np.asarray(sample["rot_mat"], dtype=np.float64)
        t = np.asarray(sample["trans_mat"], dtype=np.float64)
        r_norm = r * s
        t_norm = t + m @ r.T
        r_v1 = (r_norm @ OPENCV_TO_PYTORCH3D).T

        # bbox -> square crop -> resized intrinsics (`pix3d.py:122-150`)
        w, h = sample["img_size"]
        x0, y0, x1, y1 = sample["bbox"]
        cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        half_w = max(y1 - y0, x1 - x0) / 2.0
        x0c, y0c = cx - half_w, cy - half_w
        f = sample["focal_length"] * w / 32.0  # 32mm sensor width
        scale = self.image_size / (2.0 * half_w)
        fx = scale * f
        fy = scale * f
        tx = scale * (w / 2.0 - x0c)
        ty = scale * (h / 2.0 - y0c)
        camera = camera_from_screen(
            r_v1, t_norm, (fx, fy), (tx, ty), self.image_size)

        if self.processed:
            img_path = os.path.join(self.processed_root_dir, sample["img"])
            image = _load_pix3d_image(img_path, self.image_size, crop=None)
        else:
            img_path = os.path.join(self.root_dir, sample["img"])
            image = _load_pix3d_image(
                img_path, self.image_size,
                crop=(x0c, y0c, cx + half_w, cy + half_w))

        return {
            "points": pts_v1,
            "image": image,
            "camera": camera,
            "image_path": img_path,
            "sequence_point_cloud_path": model_path,
            "sequence_name": (sample["model"].split("/")[-2] + "_"
                              + os.path.basename(sample["img"]).split(".")[0]),
            "sequence_category": sample["category"],
        }


def _load_pix3d_image(path: str, image_size: int,
                      crop: Optional[tuple]) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    if crop is not None:
        img = img.crop(crop).resize((image_size, image_size))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return (np.asarray(img, dtype=np.float32) / 255.0)[..., :3]
