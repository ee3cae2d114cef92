"""Pixel-wise uncertainty estimators and uncertainty-guided sampling
transforms of the port (JAX counterpart: ``diffusion_uncertainty_tpu/uncertainty/``)."""

from ..diffusion.ddim import DiffusionConfig
from .estimators import ESTIMATORS, EstimatorConfig, ensemble_forward, make_estimator, make_flip_grad_estimator  # noqa: F401
from .guidance import GUIDANCE_FACTORIES, Guidance, make_percentile_guidance, make_uncertainty_grad_guidance, quantile_mask  # noqa: F401


def resolve_scheduler_transform(cfg: EstimatorConfig, timesteps=None, dcfg=None):
    """(estimator, guidance) for a reference ``--scheduler-type`` name (JAX
    ``uncertainty/__init__.py:6-27``): exactly one of the pair is not None.

    ``uncertainty_grad`` is a guidance (it updates the trajectory, ε += ∂u/∂ε
    · ᾱ_t, and records the ensemble variance as the map), so it resolves to
    ``guidance.make_uncertainty_grad_guidance`` with ``dcfg`` (default
    ``DiffusionConfig()``); every other name to ``make_estimator(cfg,
    timesteps)``.
    """
    if cfg.name == "uncertainty_grad":
        guidance = make_uncertainty_grad_guidance(
            M=cfg.M, dcfg=dcfg if dcfg is not None else DiffusionConfig(), ensemble_chunk=cfg.ensemble_chunk
        )
        return None, guidance
    return make_estimator(cfg, timesteps=timesteps), None
