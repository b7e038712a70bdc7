"""Data layer: ShapeNet-R2N2 and Pix3D loaders + synthetic data
(`bdm_tpu/data/`, the same samples on the port's cameras).

Rebuilds `experiments/dataset/` (SURVEY.md sections 2.6): eager R2N2 loading
with dataset-global normalization and folded cameras, lazy Pix3D, and
fixed-shape batches of CPU tensors (cameras are batched tensors, not
lists of objects); `batch_to_device` moves a batch's model part to the
run's device.
"""

from bdm_tpu_torch.data.loader import (DataLoader, batch_to_device, collate,
                                       model_batch)
from bdm_tpu_torch.data.pix3d import Pix3DDataset
from bdm_tpu_torch.data.shapenet_r2n2 import ShapeNetR2N2Dataset
from bdm_tpu_torch.data.synthetic import SyntheticDataset


def get_dataset(cfg):
    """Factory mirroring `dataset/__init__.py:6-16`: returns
    (loader_train, loader_val, loader_vis)."""
    d = cfg.dataset
    common = dict(image_size=d.image_size, max_points=d.max_points)
    if d.type == "shapenet_r2n2":
        make = lambda split, subset, start: ShapeNetR2N2Dataset(  # noqa: E731
            root_dir=d.root, r2n2_dir=d.r2n2_dir, pc_dict=d.pc_dict,
            split_file=d.split_file, views_rel_path=d.views_rel_path,
            which_view=d.which_view_from24, category=d.category, split=split,
            subset_ratio=subset, start_ratio=start,
            build_workers=cfg.dataloader.num_workers, **common)
        train = None
        if "sample" not in cfg.run.job:
            train = make("train", d.subset_ratio, d.start_ratio)
        val = make("test", 1.0, 0.0)
    elif d.type == "pix3d":
        make = lambda split: Pix3DDataset(  # noqa: E731
            root_dir=d.root, pc_dict=d.pc_dict, category=d.category,
            split=split, processed=d.processed, **common)
        train = None if "sample" in cfg.run.job else make("train")
        val = make("test")
    elif d.type == "synthetic":
        train = SyntheticDataset(num_samples=64, **common)
        val = SyntheticDataset(num_samples=16, seed=1, **common)
    else:
        raise NotImplementedError(d.type)

    bs, nw = cfg.dataloader.batch_size, cfg.dataloader.num_workers
    loader_train = None if train is None else DataLoader(
        train, batch_size=bs, shuffle=True, drop_last=True, num_workers=nw)
    loader_val = DataLoader(val, batch_size=bs, shuffle=False,
                            drop_last=False, num_workers=nw)
    return loader_train, loader_val, loader_val


__all__ = [
    "DataLoader",
    "batch_to_device",
    "collate",
    "model_batch",
    "SyntheticDataset",
    "ShapeNetR2N2Dataset",
    "Pix3DDataset",
    "get_dataset",
]
