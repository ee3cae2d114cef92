"""Diffusion math of the port: schedules, the DDIM step, the DDIM and
DPM-Solver++ samplers (JAX counterpart: ``diffusion_uncertainty_tpu/diffusion/``)."""

from .ddim import DDIMStep, DiffusionConfig, ddim_step, ddim_variance, predict_x0_eps  # noqa: F401
from .dpm_solver import DPMSolverConfig, sample_dpm_solver  # noqa: F401
from .sampler import SampleResult, SamplerConfig, StepState, sample_ddim, to_uint8  # noqa: F401
from .schedule import (  # noqa: F401
    NoiseSchedule,
    betas_for_alpha_bar,
    cosine_schedule,
    make_betas,
    make_schedule,
    spaced_timesteps,
    uncertainty_window,
)
