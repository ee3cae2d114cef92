"""Pixel-wise uncertainty estimators of the port (JAX counterpart:
``diffusion_uncertainty_tpu/uncertainty/``)."""

from .estimators import ESTIMATORS, EstimatorConfig, ensemble_forward, make_estimator  # noqa: F401
from .guidance import Guidance, make_percentile_guidance, quantile_mask  # noqa: F401


def resolve_scheduler_transform(cfg: EstimatorConfig):
    """(estimator, guidance) for a reference ``--scheduler-type`` name (JAX
    ``uncertainty/__init__.py:6-27``): exactly one of the pair is not None.

    ``uncertainty_grad`` is a guidance in the JAX package (it updates the
    trajectory and records the ensemble variance as the map); that guidance
    is not ported yet, so the name raises instead of falling back to an
    estimator.
    """
    if cfg.name == "uncertainty_grad":
        raise NotImplementedError(
            "scheduler type 'uncertainty_grad' is not ported yet: ROADMAP.md queue 1, item 23 (the remaining guidance makers)"
        )
    return make_estimator(cfg), None
