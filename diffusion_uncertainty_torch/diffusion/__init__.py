"""Diffusion math of the port: schedules, the DDIM and DDPM steps, the DDIM,
DDPM and DPM-Solver++ samplers (JAX counterpart:
``diffusion_uncertainty_tpu/diffusion/``; KDPM2 is imported from
``diffusion.kdpm2``, as there)."""

from .ddim import DDIMStep, DiffusionConfig, ddim_step, ddim_variance, predict_x0_eps  # noqa: F401
from .ddpm import DDPMStep, ddpm_step, posterior_log_variance  # noqa: F401
from .dpm_solver import DPMSolverConfig, sample_dpm_solver  # noqa: F401
from .sampler import SampleResult, SamplerConfig, StepState, sample_ddim, sample_ddpm, to_uint8  # noqa: F401
from .schedule import (  # noqa: F401
    NoiseSchedule,
    betas_for_alpha_bar,
    cosine_schedule,
    make_betas,
    make_schedule,
    spaced_timesteps,
    uncertainty_window,
)
