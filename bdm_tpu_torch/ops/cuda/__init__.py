"""Hand-written Hopper kernels, one wrapper module per TPU kernel module of
`bdm_tpu/ops/pallas/`.

Every wrapper sends a CPU tensor to its plain PyTorch version and launches
its CUDA kernel for a CUDA tensor (or raises). Each module counts its
kernel launches (`launches`) and the calls of its plain version on CUDA
tensors (`plain_cuda_calls`), so a run can show which path it took.
"""

from __future__ import annotations

from bdm_tpu_torch.ops.cuda import (attention, ball_query, conv3d, fps,
                                    interp, three_nn, voxelize)
from bdm_tpu_torch.ops.cuda._lib import build

# name -> (wrapper module, source, TPU kernel it replaces)
KERNELS = {
    "fps": (fps, "bdm_tpu_torch/csrc/fps.cu",
            "bdm_tpu/ops/pallas/fps.py:61"),
    "ball_query": (ball_query, "bdm_tpu_torch/csrc/ball_query.cu",
                   "bdm_tpu/ops/pallas/ball_query.py:67"),
    "three_nn": (three_nn, "bdm_tpu_torch/csrc/three_nn.cu",
                 "bdm_tpu/ops/pallas/three_nn.py:60"),
    "interp_mm": (interp, "bdm_tpu_torch/csrc/interp.cu",
                  "bdm_tpu/ops/pallas/interp_mm.py:49"),
    "scatter_mean": (voxelize, "bdm_tpu_torch/csrc/voxelize.cu",
                     "bdm_tpu/ops/pallas/voxelize.py:201"),
    "conv3d": (conv3d, "bdm_tpu_torch/csrc/conv3d.cu",
               "bdm_tpu/ops/pallas/conv3d.py:350"),   # and :520 (mm)
    "attention": (attention, "bdm_tpu_torch/csrc/attention.cu",
                  "bdm_tpu/ops/pallas/attention.py:43"),
}


def reset_counts() -> None:
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
        mod.plain_cuda_calls = 0


def counts() -> dict:
    """name -> (kernel launches, plain-version calls on CUDA tensors)."""
    return {name: (mod.launches, mod.plain_cuda_calls)
            for name, (mod, _, _) in KERNELS.items()}


__all__ = ["KERNELS", "build", "counts", "reset_counts"]
