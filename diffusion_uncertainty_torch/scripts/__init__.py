"""Command-line entry points of the port (JAX counterpart:
``diffusion_uncertainty_tpu/scripts/``)."""
