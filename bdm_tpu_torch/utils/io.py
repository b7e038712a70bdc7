"""Point-cloud file IO (`bdm_tpu/utils/io.py`, copied; replaces the
reference's pytorch3d/open3d usage in
`main.py:510-599` and `evaluation_cd.py`)."""

from __future__ import annotations

import os

import numpy as np


def write_ply(path: str, points: np.ndarray) -> None:
    """Write an (N, 3) float cloud as binary little-endian PLY."""
    points = np.asarray(points, dtype=np.float32)
    assert points.ndim == 2 and points.shape[1] == 3, points.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(points)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(points.astype("<f4").tobytes())


def read_ply(path: str) -> np.ndarray:
    """Read vertices from an ascii or binary little/big-endian PLY."""
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
            return np.asarray(rows, dtype=np.float32)
        end = "<" if fmt == "binary_little_endian" else ">"
        dtype = np.dtype([(p, f"{end}f4") for p in props])
        data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        return np.stack([data["x"], data["y"], data["z"]],
                        axis=1).astype(np.float32)
