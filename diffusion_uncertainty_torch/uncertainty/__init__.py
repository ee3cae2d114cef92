"""Pixel-wise uncertainty estimators of the port (JAX counterpart:
``diffusion_uncertainty_tpu/uncertainty/``)."""

from .estimators import ESTIMATORS, EstimatorConfig, ensemble_forward, make_estimator  # noqa: F401
