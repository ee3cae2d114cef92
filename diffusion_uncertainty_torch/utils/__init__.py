"""Utilities of the port (JAX counterpart: ``diffusion_uncertainty_tpu/utils/``)."""

from .rng import NoiseSource, TorchNoise  # noqa: F401
