"""Visualization + metadata dumps (`bdm_tpu/utils/vis.py`, copied).

Rebuild of the reference's vis surface (`diffusion_utils.py:185-359`,
`pvd/utils/visualize.py`): point-cloud renders as images (matplotlib
replaces the PyTorch3D renderer), diffusion-evolution grids, and JSON
metadata dumps alongside samples. W&B logging is optional and gated.
matplotlib and wandb are imported inside the functions that use them.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def render_point_cloud(points: np.ndarray, path: str, color: str = "#3070b3",
                       point_size: float = 0.6, elev: float = 20,
                       azim: float = 30) -> None:
    """Save a single cloud as a PNG scatter."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    points = np.asarray(points)
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(points[:, 0], points[:, 2], points[:, 1], s=point_size,
               c=color, linewidths=0)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    lim = float(np.abs(points).max()) or 1.0
    for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        setter(-lim, lim)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def render_evolution(clouds: Sequence[np.ndarray], path: str,
                     max_frames: int = 8) -> None:
    """A horizontal strip showing the reverse-diffusion evolution
    (the reference's `sample_save_evolutions` output)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    clouds = list(clouds)
    if len(clouds) > max_frames:
        idx = np.linspace(0, len(clouds) - 1, max_frames).astype(int)
        clouds = [clouds[i] for i in idx]
    fig = plt.figure(figsize=(3 * len(clouds), 3))
    for i, pc in enumerate(clouds):
        pc = np.asarray(pc)
        ax = fig.add_subplot(1, len(clouds), i + 1, projection="3d")
        ax.scatter(pc[:, 0], pc[:, 2], pc[:, 1], s=0.4, linewidths=0)
        ax.set_axis_off()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def dump_metadata(path: str, **metadata) -> None:
    """JSON metadata next to samples (`main.py:594-599`-style dumps)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(metadata, f, indent=2, default=str)


class WandbLogger:
    """Optional W&B logging (the reference logs scalars + artifacts,
    `main.py:47-66,239-252`). No-op when wandb is unavailable or off."""

    def __init__(self, enabled: bool, project: str, name: str,
                 config: Optional[dict] = None):
        self.run = None
        if not enabled:
            return
        try:
            import wandb
            self.run = wandb.init(project=project, name=name, config=config)
        except Exception as e:  # offline/unavailable
            print(f"wandb disabled ({e})")

    def log(self, metrics: dict, step: Optional[int] = None):
        if self.run is not None:
            self.run.log(metrics, step=step)

    def log_point_clouds(self, clouds: dict, step: Optional[int] = None):
        """Interactive 3D point-cloud panels — the reference's
        `visualize()` logs `wandb.Object3D` per sample alongside the
        rendered images (`main.py:387-448`). `clouds` maps panel name to
        an (N, 3) or (N, 6) [xyz+rgb] array."""
        if self.run is None:
            return
        import wandb
        self.run.log(
            {k: wandb.Object3D(np.asarray(v, dtype=np.float32))
             for k, v in clouds.items()}, step=step)

    def finish(self):
        if self.run is not None:
            self.run.finish()
