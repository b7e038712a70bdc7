"""Batch loader: shuffling, collation into tensors, background prefetch
(`bdm_tpu/data/loader.py`).

Replaces torch DataLoader + `custom_collate` (`shapenet_r2n2.py:601-612`).
Arrays stack into CPU tensors and cameras field by field into one batched
camera, not into Python lists. Batches stay on the host until
`batch_to_device` moves their model part to the run's device.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Sequence

import numpy as np
import torch

from bdm_tpu_torch.conditioning.cameras import (PerspectiveCamera,
                                                stack_cameras)


def _as_tensor(v) -> torch.Tensor:
    """float64 arrays become float32, as the JAX package's arrays do."""
    t = torch.as_tensor(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v
    return t.float() if t.dtype == torch.float64 else t


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of sample dicts into one batch dict of tensors."""
    out: Dict[str, Any] = {}
    for key in samples[0].keys():
        v0 = samples[0][key]
        if v0 is None:
            out[key] = None
        elif isinstance(v0, PerspectiveCamera):
            out[key] = stack_cameras([s[key] for s in samples])
        elif isinstance(v0, (np.ndarray, torch.Tensor)):
            out[key] = torch.stack([_as_tensor(s[key]) for s in samples])
        elif isinstance(v0, (int, float)):
            out[key] = _as_tensor([s[key] for s in samples])
        else:  # strings/metadata stay as lists
            out[key] = [s[key] for s in samples]
    return out


MODEL_BATCH_KEYS = ("points", "colors", "image", "mask",
                    "distance_transform", "camera")


def model_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Strip metadata (paths, names): only the model's inputs remain."""
    return {k: batch[k] for k in MODEL_BATCH_KEYS
            if k in batch and batch[k] is not None}


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The model part of a collated batch (`model_batch`) on `device`:
    tensors float32 (cameras too), as the models take them."""
    return {k: v.to(device) if isinstance(v, PerspectiveCamera)
            else v.to(device, torch.float32)
            for k, v in model_batch(batch).items()}


class DataLoader:
    """Minimal epoch-based loader with optional background prefetching."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_workers: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch if num_workers > 0 else 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        end = (len(idx) // self.batch_size * self.batch_size
               if self.drop_last else len(idx))
        for i in range(0, end, self.batch_size):
            yield idx[i:i + self.batch_size]

    def _make_batch(self, indices) -> Dict[str, Any]:
        return collate([self.dataset[int(i)] for i in indices])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.prefetch <= 0:
            for indices in self._batch_indices():
                yield self._make_batch(indices)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for indices in self._batch_indices():
                    q.put(self._make_batch(indices))
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item

    def infinite(self) -> Iterator[Dict[str, Any]]:
        """Endless epochs (the reference trains with a `while True` epoch
        loop, `main.py:183`)."""
        while True:
            yield from self
