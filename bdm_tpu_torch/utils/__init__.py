"""Utilities: JAX parameter trees -> port state_dicts (`convert_jax`)."""
