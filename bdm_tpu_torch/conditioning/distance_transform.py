"""Mask distance transform for conditioning, a NumPy copy of
`bdm_tpu/conditioning/distance_transform.py`.

Reference: `model/model_utils.py:13-21` — the L2 distance transform of the
inverted mask, divided by image_size / 2, clipped to [0, 1]. It is image
preprocessing, constant per sample: it runs on the host in the data path
and ships with the batch as "distance_transform".
"""

from __future__ import annotations

import numpy as np


def compute_distance_transform(mask: np.ndarray) -> np.ndarray:
    """mask (B, H, W) or (B, H, W, 1), binary or float (foreground > 0.5)
    -> (B, H, W, 1) float32 distances at the reference's scale."""
    mask = np.asarray(mask)
    if mask.ndim == 4:
        mask = mask[..., 0]
    if mask.dtype != np.uint8:
        mask = (mask > 0.5).astype(np.uint8)
    image_size = mask.shape[-1]
    out = np.stack([_edt_l2(1 - m) for m in mask])
    out = np.clip(out / (image_size / 2.0), 0.0, 1.0)
    return out[..., None].astype(np.float32)


def _edt_l2(img: np.ndarray) -> np.ndarray:
    """L2 distance of each nonzero pixel to the nearest zero pixel (cv2's
    3x3-mask transform where cv2 is installed, else scipy's exact one)."""
    try:
        import cv2
        return cv2.distanceTransform(img.astype(np.uint8), cv2.DIST_L2,
                                     cv2.DIST_MASK_3)
    except ImportError:
        from scipy import ndimage
        return ndimage.distance_transform_edt(img).astype(np.float32)
