"""Utilities: PLY IO (`io`), JAX parameter trees -> port state_dicts
(`convert_jax`), renders and logging (`vis`)."""

from bdm_tpu_torch.utils.io import read_ply, write_ply

__all__ = ["read_ply", "write_ply"]
