"""Utilities of the port (JAX counterpart: ``diffusion_uncertainty_tpu/utils/``)."""

from .device import resolve_device  # noqa: F401
from .rng import NoiseSource, TorchNoise  # noqa: F401
