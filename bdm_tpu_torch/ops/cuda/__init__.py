"""Hand-written Hopper kernels, one wrapper module per TPU kernel module of
`bdm_tpu/ops/pallas/`.

Every wrapper sends a CPU tensor to its plain PyTorch version and launches
its CUDA kernel for a CUDA tensor (or raises). Each module counts its
kernel launches (`launches`) and the calls of its plain version on CUDA
tensors (`plain_cuda_calls`), so a run can show which path it took. A
module whose source holds several kernels names them in `PATHS` and counts
the launches of each (`launches_<path>`): attention and conv3d "tc"
(tensor cores) and "simt" (CUDA cores), the blend "vec" (16-byte
channel groups) and "scalar" (one channel).
"""

from __future__ import annotations

from bdm_tpu_torch.ops.cuda import (attention, ball_query, conv3d, fps,
                                    groupnorm, interp, scatter_sum, three_nn,
                                    voxelize)
from bdm_tpu_torch.ops.cuda._lib import build

_PALLAS = "bdm_tpu/ops/pallas/"

# name -> (wrapper module, source, TPU kernels it replaces)
KERNELS = {
    "fps": (fps, "bdm_tpu_torch/csrc/fps.cu",
            "bdm_tpu/ops/pallas/fps.py:61"),
    "ball_query": (ball_query, "bdm_tpu_torch/csrc/ball_query.cu",
                   "bdm_tpu/ops/pallas/ball_query.py:67"),
    "three_nn": (three_nn, "bdm_tpu_torch/csrc/three_nn.cu",
                 "bdm_tpu/ops/pallas/three_nn.py:60"),
    "interp_mm": (interp, "bdm_tpu_torch/csrc/interp.cu",
                  "bdm_tpu/ops/pallas/interp_mm.py:49"),
    # :201 sorted, D-padded bf16; :290 sorted, unpadded float32
    "scatter_mean": (voxelize, "bdm_tpu_torch/csrc/voxelize.cu",
                     f"{_PALLAS}voxelize.py:201, {_PALLAS}voxelize.py:290"),
    "scatter_sum": (scatter_sum, "bdm_tpu_torch/csrc/scatter_sum.cu",
                    "bdm_tpu/ops/pallas/voxelize.py:38"),
    # :69 per-slab, :199 whole grid, :350 multi-slice (roll and pad taps),
    # :520 matmul-first (prepadded, and unpadded through :582)
    "conv3d": (conv3d, "bdm_tpu_torch/csrc/conv3d.cu",
               f"{_PALLAS}conv3d.py:69, {_PALLAS}conv3d.py:199, "
               f"{_PALLAS}conv3d.py:350, {_PALLAS}conv3d.py:520, "
               f"{_PALLAS}conv3d.py:582"),
    "attention": (attention, "bdm_tpu_torch/csrc/attention.cu",
                  "bdm_tpu/ops/pallas/attention.py:43"),
    "groupnorm": (groupnorm, "bdm_tpu_torch/csrc/groupnorm.cu",
                  "none: bdm_tpu/models/layers.py's GroupNorm is flax "
                  "nn.GroupNorm (jnp), not Pallas"),
}


def reset_counts() -> None:
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
        mod.plain_cuda_calls = 0
        for path in getattr(mod, "PATHS", ()):
            setattr(mod, f"launches_{path}", 0)
    conv3d.packs = 0


def counts() -> dict:
    """name -> (kernel launches, plain-version calls on CUDA tensors)."""
    return {name: (mod.launches, mod.plain_cuda_calls)
            for name, (mod, _, _) in KERNELS.items()}


def path_counts() -> dict:
    """name -> {path: launches of that kernel}, for the modules with
    `PATHS` (attention and conv3d: "tc", "simt"; interp_mm: "vec",
    "scalar")."""
    return {name: {path: getattr(mod, f"launches_{path}")
                   for path in mod.PATHS}
            for name, (mod, _, _) in KERNELS.items()
            if hasattr(mod, "PATHS")}


__all__ = ["KERNELS", "build", "counts", "path_counts", "reset_counts"]
