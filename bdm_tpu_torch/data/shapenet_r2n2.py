"""ShapeNet-R2N2 dataset (`bdm_tpu/data/shapenet_r2n2.py`, on the port's
cameras).

Rebuild of `experiments/dataset/shapenet_r2n2.py` with the semantics that
matter for parity with released checkpoints:
  * 15k-point `.npy` clouds with the v2->v1 axis remap
    (x, y, z) <- (-z2, y2, -x2) (`shapenet_r2n2.py:56-62`)
  * R2N2 rendering PNGs resized to `image_size` with bilinear filtering
  * cameras from `rendering_metadata.txt` (azim/elev/dist,
    MAX_CAMERA_DISTANCE=1.75 — `:374-380`)
  * deterministic shuffle with seed 38383 (`:444-446`)
  * DATASET-GLOBAL normalization (one mean/std over every point of the
    split — `:457-478`) folded into the cameras (`build_camera_from_R2N2`)
  * one random `max_points`-subsample per cloud AT INIT (`:480-485`)
  * subset_ratio / start_ratio slicing of object ids (`:401-405`)

Samples are dicts of NumPy arrays and a camera of CPU tensors
({'points', 'image', 'camera', ...}).
"""

from __future__ import annotations

import json
import os
import random
import numpy as np

from bdm_tpu_torch.conditioning.cameras import (
    camera_from_r2n2,
    compute_camera_calibration,
    compute_extrinsic_matrix,
    MAX_CAMERA_DISTANCE,
)

R2N2_CATEGORIES = {
    "airplane": "02691156", "bench": "02828884", "cabinet": "02933112",
    "car": "02958343", "chair": "03001627", "display": "03211117",
    "lamp": "03636649", "loudspeaker": "03691459", "rifle": "04090263",
    "sofa": "04256520", "table": "04379243", "telephone": "04401088",
    "watercraft": "04530566",
}

SHUFFLE_SEED = 38383


def transform_v2_to_v1(points: np.ndarray) -> np.ndarray:
    """ShapeNet v2 -> v1 axis remap (`shapenet_r2n2.py:56-62`)."""
    out = np.empty_like(points)
    out[:, 0] = -points[:, 2]
    out[:, 1] = points[:, 1]
    out[:, 2] = -points[:, 0]
    return out.astype(np.float32)


def _load_image(path: str, image_size: int) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    bands = img.split()
    img = Image.merge("RGB", bands[:3]).resize(
        (image_size, image_size), Image.BILINEAR)
    return (np.asarray(img, dtype=np.float32) / 255.0)[..., :3]


class ShapeNetR2N2Dataset:
    def __init__(self, root_dir: str, r2n2_dir: str,
                 pc_dict: str = "pc_dict_v2.json",
                 split_file: str = "R2N2_split.json",
                 views_rel_path: str = "ShapeNetRendering",
                 which_view: str = "00", category: str = "chair",
                 split: str = "train", max_points: int = 4096,
                 image_size: int = 224, subset_ratio: float = 1.0,
                 start_ratio: float = 0.0,
                 normalize_per_shape: bool = False,
                 build_workers: int = 0):
        assert split in ("train", "test"), split
        self.split = split
        self.max_points = max_points
        self.image_size = image_size

        cate_id = R2N2_CATEGORIES[category]
        with open(os.path.join(r2n2_dir, split_file)) as f:
            split_dict = json.load(f)
        with open(os.path.join(r2n2_dir, pc_dict)) as f:
            pc_subdir = json.load(f)

        object_ids = list(split_dict[split][cate_id].keys())
        # subset_ratio is the END ratio, start_ratio the start — the
        # reference slices [: int(len*subset)] when start==0
        # (`shapenet_r2n2.py:242-243,402`) and
        # [int(len*start) : int(len*subset)] otherwise (`:248`)
        lo = int(len(object_ids) * start_ratio)
        hi = int(len(object_ids) * subset_ratio)
        object_ids = object_ids[:hi] if lo == 0 else object_ids[lo:hi]

        records = []  # (img_path, pc_path, Rs, Ts)
        for object_id in object_ids:
            if object_id not in pc_subdir[split][cate_id]:
                continue
            subdir = pc_subdir[split][cate_id][object_id]
            pc_path = os.path.join(root_dir, cate_id, subdir,
                                   object_id + ".npy")
            rendering = os.path.join(r2n2_dir, views_rel_path, cate_id,
                                     object_id, "rendering")
            with open(os.path.join(rendering, "rendering_metadata.txt")) as f:
                meta = f.readlines()
            azim, elev, _yaw, dist_ratio, _fov = (
                float(v) for v in meta[int(which_view)].strip().split(" "))
            rt = compute_extrinsic_matrix(
                azim, elev, dist_ratio * MAX_CAMERA_DISTANCE)
            rs, ts = compute_camera_calibration(rt)
            img_path = os.path.join(rendering, which_view + ".png")
            records.append((img_path, pc_path, rs, ts))

        # eager load (the reference holds the whole split in RAM); point
        # files go through the native threaded reader when available
        from bdm_tpu_torch.native import read_points

        def _load_one(rec):
            img_path, pc_path, _, _ = rec
            pc = read_points(pc_path)
            assert pc.shape[0] == 15000, pc_path
            return transform_v2_to_v1(pc), _load_image(img_path, image_size)

        if build_workers and len(records) > 1:
            # parallel eager build (the reference's build_data_parallel,
            # `shapenet_r2n2.py:220-331`); threads suffice — the work is
            # file IO + PNG decode, both GIL-releasing
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=build_workers) as ex:
                loaded = list(ex.map(_load_one, records))
        else:
            loaded = [_load_one(r) for r in records]
        clouds = [c for c, _ in loaded]
        images = [im for _, im in loaded]

        # deterministic shuffle, seed 38383
        order = list(range(len(records)))
        random.Random(SHUFFLE_SEED).shuffle(order)
        records = [records[i] for i in order]
        clouds = [clouds[i] for i in order]
        images = [images[i] for i in order]

        all_points = np.stack(clouds) if clouds else np.zeros((0, 0, 3))
        if normalize_per_shape:
            mean = all_points.mean(axis=1, keepdims=True)  # (B, 1, 3)
            std = all_points.reshape(len(clouds), -1).std(
                axis=1).reshape(-1, 1, 1)
        else:
            mean = all_points.reshape(-1, 3).mean(axis=0).reshape(1, 1, 3)
            std = all_points.reshape(-1).std().reshape(1, 1, 1)
        all_points = (all_points - mean) / std
        self.points_mean, self.points_std = mean, std

        self.samples = []
        rng = np.random  # the reference uses global np.random for the
        # one-time subsample (`shapenet_r2n2.py:484`)
        for i, (img_path, pc_path, rs, ts) in enumerate(records):
            sel = rng.choice(all_points.shape[1], max_points)
            m = mean[i, 0] if normalize_per_shape else mean[0, 0]
            s = float(std[i, 0, 0]) if normalize_per_shape else float(
                std[0, 0, 0])
            camera = camera_from_r2n2(rs.astype(np.float32),
                                      ts.astype(np.float32), m, s)
            self.samples.append({
                "points": all_points[i, sel].astype(np.float32),
                "image": images[i],
                "camera": camera,
                "image_path": img_path,
                "sequence_point_cloud_path": pc_path,
                "sequence_name": (img_path.split("/")[-3] + "_"
                                  + os.path.basename(img_path).split(".")[0]),
                "sequence_category": category,
            })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        return self.samples[idx]
