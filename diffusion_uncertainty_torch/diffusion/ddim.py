"""DDIM update rule.

JAX counterpart: ``diffusion_uncertainty_tpu/diffusion/ddim.py``. All math is
float32 whatever the activation type; ``prev_sample`` is cast back to the
sample's type. Timesteps are ints (or integer tensors) indexing the schedule.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .schedule import NoiseSchedule

__all__ = ["DiffusionConfig", "DDIMStep", "predict_x0_eps", "ddim_variance", "ddim_step"]


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Sampler knobs: prediction type, x0 clipping, dynamic thresholding,
    eta, spacing."""

    prediction_type: str = "epsilon"  # epsilon | sample | v_prediction
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    eta: float = 0.0
    use_clipped_model_output: bool = False
    timestep_spacing: str = "leading"
    steps_offset: int = 0


class DDIMStep(NamedTuple):
    prev_sample: torch.Tensor
    pred_original_sample: torch.Tensor
    pred_epsilon: torch.Tensor


def predict_x0_eps(sample, model_output, alpha_prod_t, prediction_type: str = "epsilon"):
    """The network output as (pred_x0, pred_epsilon), float32."""
    sample = sample.float()
    model_output = model_output.float()
    sqrt_ab = torch.sqrt(alpha_prod_t)
    sqrt_1mab = torch.sqrt(1.0 - alpha_prod_t)
    if prediction_type == "epsilon":
        x0 = (sample - sqrt_1mab * model_output) / sqrt_ab
        eps = model_output
    elif prediction_type == "sample":
        x0 = model_output
        eps = (sample - sqrt_ab * x0) / sqrt_1mab
    elif prediction_type == "v_prediction":
        x0 = sqrt_ab * sample - sqrt_1mab * model_output
        eps = sqrt_ab * model_output + sqrt_1mab * sample
    else:
        raise ValueError(f"unknown prediction_type: {prediction_type!r}")
    return x0, eps


def _dynamic_threshold(x0: torch.Tensor, ratio: float, max_value: float) -> torch.Tensor:
    """Imagen dynamic thresholding: clamp each image to [-s, s] at the
    ``ratio`` abs-quantile, then divide by s."""
    batch = x0.shape[0]
    s = torch.quantile(x0.reshape(batch, -1).abs(), ratio, dim=1)
    s = s.clamp(1.0, max_value).reshape((batch,) + (1,) * (x0.ndim - 1))
    return torch.maximum(torch.minimum(x0, s), -s) / s


def ddim_variance(alpha_prod_t, alpha_prod_t_prev):
    """sigma_t^2 of DDIM eq. 16."""
    beta_prod_t = 1.0 - alpha_prod_t
    beta_prod_t_prev = 1.0 - alpha_prod_t_prev
    return (beta_prod_t_prev / beta_prod_t) * (1.0 - alpha_prod_t / alpha_prod_t_prev)


def ddim_step(
    schedule: NoiseSchedule,
    sample: torch.Tensor,
    model_output: torch.Tensor,
    timestep,
    prev_timestep,
    cfg: DiffusionConfig,
    noise: Optional[torch.Tensor] = None,
) -> DDIMStep:
    """One DDIM update x_t -> x_{t-1}; ``prev_timestep`` < 0 resolves to
    ``final_alpha_cumprod``. With ``cfg.eta > 0`` the caller passes ``noise``."""
    ab_t = schedule.alpha_bar(timestep)
    ab_prev = schedule.alpha_bar(prev_timestep)

    x0, eps = predict_x0_eps(sample, model_output, ab_t, cfg.prediction_type)

    if cfg.thresholding:
        x0 = _dynamic_threshold(x0, cfg.dynamic_thresholding_ratio, cfg.sample_max_value)
    elif cfg.clip_sample:
        x0 = x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)

    std_dev_t = cfg.eta * torch.sqrt(ddim_variance(ab_t, ab_prev))

    if cfg.use_clipped_model_output:
        eps = (sample.float() - torch.sqrt(ab_t) * x0) / torch.sqrt(1.0 - ab_t)

    direction = torch.sqrt(torch.clamp(1.0 - ab_prev - std_dev_t**2, min=0.0)) * eps
    prev_sample = torch.sqrt(ab_prev) * x0 + direction

    if cfg.eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires variance noise")
        prev_sample = prev_sample + std_dev_t * noise.float()

    return DDIMStep(prev_sample=prev_sample.to(sample.dtype), pred_original_sample=x0, pred_epsilon=eps)
