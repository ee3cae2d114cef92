"""DDPM ancestral update x_t -> x_{t-1}.

JAX counterpart: ``diffusion_uncertainty_tpu/diffusion/ddpm.py``
(``DDPMStep``, ``posterior_log_variance``, ``ddpm_step``, :21-107). All math
is float32 whatever the activation type; ``prev_sample`` is cast back to the
sample's type. The variance families are diffusers' ``fixed_small``,
``fixed_small_log``, ``fixed_large``, ``learned`` and ``learned_range``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .ddim import DiffusionConfig, _dynamic_threshold, predict_x0_eps
from .schedule import NoiseSchedule

__all__ = ["DDPMStep", "ddpm_step", "posterior_log_variance"]


class DDPMStep(NamedTuple):
    prev_sample: torch.Tensor
    pred_original_sample: torch.Tensor
    pred_epsilon: torch.Tensor


def posterior_log_variance(
    schedule: NoiseSchedule,
    timestep,
    prev_timestep,
    variance_type: str,
    predicted_variance: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """log sigma_t^2 of p(x_{t-1} | x_t) for each variance family."""
    ab_t = schedule.alpha_bar(timestep)
    ab_prev = schedule.alpha_bar(prev_timestep)
    current_beta_t = 1.0 - ab_t / ab_prev
    variance = torch.clamp((1.0 - ab_prev) / (1.0 - ab_t) * current_beta_t, min=1e-20)

    if variance_type in ("fixed_small", "fixed_small_log"):
        return torch.log(variance)
    if variance_type == "fixed_large":
        return torch.log(torch.clamp(current_beta_t, min=1e-20))
    if variance_type in ("learned", "learned_range"):
        if predicted_variance is None:
            raise ValueError(f"{variance_type} needs the model's variance channels")
        if variance_type == "learned":
            return predicted_variance
        # learned_range: interpolate in log space between the posterior variance and beta_t
        min_log = torch.log(variance)
        max_log = torch.log(torch.clamp(current_beta_t, min=1e-20))
        frac = (predicted_variance + 1.0) / 2.0
        return frac * max_log + (1.0 - frac) * min_log
    raise ValueError(f"unknown variance_type: {variance_type!r}")


def ddpm_step(
    schedule: NoiseSchedule,
    sample: torch.Tensor,
    model_output: torch.Tensor,
    timestep,
    prev_timestep,
    cfg: DiffusionConfig,
    noise: Optional[torch.Tensor] = None,
    variance_type: str = "fixed_small",
    predicted_variance: Optional[torch.Tensor] = None,
) -> DDPMStep:
    """One ancestral update (DDPM eq. 7 posterior mean, plus std · noise).

    ``noise`` is needed wherever ``prev_timestep`` can be >= 0; it is masked
    off where ``prev_timestep`` < 0 (the chain's end adds no noise).
    """
    sample_f = sample.float()
    ab_t = schedule.alpha_bar(timestep)
    ab_prev = schedule.alpha_bar(prev_timestep)
    beta_prod_t = 1.0 - ab_t
    beta_prod_t_prev = 1.0 - ab_prev
    current_alpha_t = ab_t / ab_prev
    current_beta_t = 1.0 - current_alpha_t

    x0, eps = predict_x0_eps(sample_f, model_output, ab_t, cfg.prediction_type)
    if cfg.thresholding:
        x0 = _dynamic_threshold(x0, cfg.dynamic_thresholding_ratio, cfg.sample_max_value)
    elif cfg.clip_sample:
        x0 = x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)

    x0_coeff = torch.sqrt(ab_prev) * current_beta_t / beta_prod_t
    xt_coeff = torch.sqrt(current_alpha_t) * beta_prod_t_prev / beta_prod_t
    prev_mean = x0_coeff * x0 + xt_coeff * sample_f

    if noise is not None:
        log_var = posterior_log_variance(schedule, timestep, prev_timestep, variance_type, predicted_variance)
        if variance_type == "fixed_small_log":
            std = torch.exp(0.5 * log_var)
        else:
            std = torch.sqrt(torch.exp(log_var))
        add = 1.0 if int(prev_timestep) >= 0 else 0.0  # no noise below t=0
        prev_mean = prev_mean + add * std * noise.float()

    return DDPMStep(prev_sample=prev_mean.to(sample.dtype), pred_original_sample=x0, pred_epsilon=eps)
