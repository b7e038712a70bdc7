"""bdm_tpu_torch: BDM on PyTorch and CUDA for NVIDIA Hopper (H100).

The second package beside `bdm_tpu` (the JAX reference, which stays
unchanged). Same layout: `ops/` (point ops; the six TPU kernels of the main
path as hand-written CUDA kernels in `ops/cuda/`, sources in `csrc/`),
`models/`, `diffusion/`, `conditioning/`, `samplers/`, `utils/`.

Activations are channel-last (B, N, C) at every public function, as in
`bdm_tpu`; modules keep the reference checkpoints' state_dict keys. This
package imports torch and never jax.
"""

__version__ = "0.1.0"
