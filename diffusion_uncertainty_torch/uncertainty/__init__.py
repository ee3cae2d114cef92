"""Pixel-wise uncertainty estimators of the port (JAX counterpart:
``diffusion_uncertainty_tpu/uncertainty/``)."""

from .estimators import ESTIMATORS, EstimatorConfig, ensemble_forward, make_estimator  # noqa: F401
from .guidance import Guidance, make_percentile_guidance, quantile_mask  # noqa: F401
