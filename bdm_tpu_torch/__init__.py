"""bdm_tpu_torch: BDM on PyTorch and CUDA for NVIDIA Hopper (H100).

The second package beside `bdm_tpu` (the JAX reference, which stays
unchanged). Same layout: `ops/` (point ops; the TPU kernels of the ported
paths as hand-written CUDA kernels in `ops/cuda/`, sources in `csrc/`),
`models/`, `diffusion/`, `conditioning/`, `samplers/`, `train/`, `utils/`,
`config/`, `data/`, `evaluation/`, `native/`, and the command lines
`main`, `main_blending` and `main_merging` (`cli.py`).

Activations are channel-last (B, N, C) at every public function, as in
`bdm_tpu`; modules keep the reference checkpoints' state_dict keys. This
package imports torch and never jax.

Entry points (`PC2Model`, `PVDModel`, `BDMMergingModel`, `NoiseProvider`)
live on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

__version__ = "0.3.0"


def default_device() -> "torch.device":
    """The card. Raises without one: running on the CPU is the caller's
    explicit choice (`device="cpu"`), never a silent carry-on."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bdm_tpu_torch runs on an NVIDIA GPU and found no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> "torch.device":
    """`None` -> `default_device()`, anything else -> torch.device."""
    import torch
    return default_device() if device is None else torch.device(device)
