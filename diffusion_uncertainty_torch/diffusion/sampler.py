"""Reverse-diffusion DDIM and DDPM sampling with a static uncertainty window.

JAX counterpart: ``diffusion_uncertainty_tpu/diffusion/sampler.py``
(``sample_ddim``; ``sample_ddpm``, :195-261). The three ``lax.scan``
segments (pre-window / window / post-window) become one Python loop over the
steps; the window's maps are written into tensors on the sample's device, so
the loop never reads back to the host.

Model function contract:
    model_fn(x, t, noise_or_None) -> epsilon-like output (same shape as x)
``t`` is the train-timestep value as a Python int. The third argument is a
noise source for stochastic models (MC dropout, activation noise) or None.
The trajectory forward always receives None, so it is deterministic; only
the estimator's or the guidance's forwards may receive the noise source
(``mc_dropout`` hands it to ``estimator_model_fn``, the JAX CLI's
``select_apply_fn`` split).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.rng import NoiseSource
from .ddim import DiffusionConfig, ddim_step
from .ddpm import ddpm_step
from .schedule import NoiseSchedule, spaced_timesteps, uncertainty_window

ModelFn = Callable[[torch.Tensor, int, Optional[NoiseSource]], torch.Tensor]

__all__ = ["StepState", "SamplerConfig", "SampleResult", "sample_ddim", "sample_ddpm", "to_uint8"]


class StepState(NamedTuple):
    """What an estimator may read about the current step (float32 except
    ``sample`` and ``prev_sample``, which keep the sample's type)."""

    sample: torch.Tensor  # x_t as fed to the model
    pred_x0: torch.Tensor  # clipped predicted x_0
    pred_epsilon: torch.Tensor
    prev_sample: torch.Tensor  # x_{t-1} from the plain DDIM update
    timestep: int
    prev_timestep: int  # t - T//n, may be < 0


# estimator(model_fn, schedule, state, noise) -> pixel-wise uncertainty map
EstimatorFn = Callable[[ModelFn, NoiseSchedule, StepState, NoiseSource], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_inference_steps: int = 50
    num_train_timesteps: int = 1000
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    # uncertainty window [after_step, after_step + num_steps_uc); 0 disables it
    after_step: int = 0
    num_steps_uc: int = 0
    # begin the reverse chain at this step index (x_T is x at timesteps[start_step])
    start_step: int = 0


class SampleResult(NamedTuple):
    sample: torch.Tensor  # final x_0-space sample, [B, ...]
    uncertainty: Optional[torch.Tensor]  # [num_steps_uc, B, ...] float32 or None
    pred_epsilon: Optional[torch.Tensor]  # [num_steps_uc, B, ...] float32 or None
    window_timesteps: Optional[np.ndarray]  # [num_steps_uc] int32 (host)
    intermediates: Optional[torch.Tensor] = None  # [steps, B, ...] per-step x_{t-1}


def _recompute_prev(schedule: NoiseSchedule, state: StepState, new_eps: torch.Tensor, cfg: DiffusionConfig,
                    x0: Optional[torch.Tensor] = None):
    """x_{t-1} re-derived after a guidance transform replaced pred_epsilon.
    A given ``x0`` is kept, and only the direction term takes ``new_eps``
    (the scheduler-internal variants keep the original model output's x0)."""
    ab_t = schedule.alpha_bar(state.timestep)
    ab_prev = schedule.alpha_bar(state.prev_timestep)
    if x0 is None:
        x0 = (state.sample.float() - torch.sqrt(1.0 - ab_t) * new_eps) / torch.sqrt(ab_t)
        if cfg.clip_sample:
            x0 = x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)
    std_dev_t = cfg.eta * torch.sqrt((1.0 - ab_prev) / (1.0 - ab_t) * (1.0 - ab_t / ab_prev))
    direction = torch.sqrt(torch.clamp(1.0 - ab_prev - std_dev_t**2, min=0.0)) * new_eps
    return (torch.sqrt(ab_prev) * x0 + direction).to(state.sample.dtype)


@torch.no_grad()
def sample_ddim(
    model_fn: ModelFn,
    schedule: NoiseSchedule,
    x_T: torch.Tensor,
    noise: NoiseSource,
    cfg: SamplerConfig,
    estimator: Optional[EstimatorFn] = None,
    guidance=None,
    collect_intermediates: bool = False,
    estimator_model_fn: Optional[ModelFn] = None,
) -> SampleResult:
    """Run the reverse chain from ``x_T`` on ``x_T``'s device (the schedule's
    tables must be on the same device).

    ``noise`` supplies every Gaussian draw (see ``utils.rng`` for the order).
    ``estimator_model_fn``: the model the estimator or the guidance calls
    when it differs from the trajectory model. ``guidance``
    (``uncertainty.guidance.Guidance``): inside the window it replaces the
    estimator and sets x_{t-1} itself; the window's maps are its uncertainty
    maps. The loop runs without autograd; a gradient guidance turns it back
    on for its own forwards.
    """
    dcfg = cfg.diffusion
    ts = spaced_timesteps(cfg.num_train_timesteps, cfg.num_inference_steps, dcfg.timestep_spacing, dcfg.steps_offset)
    prev_ts = ts - cfg.num_train_timesteps // cfg.num_inference_steps

    def base_step(x, t, t_prev):
        model_output = model_fn(x, t, None)
        eta_noise = noise.normal(x.shape, torch.float32, x.device) if dcfg.eta > 0.0 else None
        return ddim_step(schedule, x, model_output, t, t_prev, dcfg, noise=eta_noise)

    s0 = cfg.start_step
    windowed = (estimator is not None or guidance is not None) and cfg.num_steps_uc > 0
    w0 = w1 = s0
    if windowed:
        w0, w1 = uncertainty_window(cfg.after_step, cfg.num_steps_uc, cfg.num_inference_steps)
        w0 = max(w0, s0)
        w1 = max(w1, w0)
    n_win = w1 - w0
    map_shape = (n_win,) + tuple(x_T.shape)
    uncertainty = torch.empty(map_shape, dtype=torch.float32, device=x_T.device) if windowed else None
    pred_eps = torch.empty_like(uncertainty) if windowed else None
    inters = []
    est_fn = estimator_model_fn if estimator_model_fn is not None else model_fn
    aux = guidance.init(x_T) if guidance is not None else None

    x = x_T
    for i in range(s0, cfg.num_inference_steps):
        t, t_prev = int(ts[i]), int(prev_ts[i])
        step = base_step(x, t, t_prev)
        x_next = step.prev_sample
        if w0 <= i < w1:
            state = StepState(
                sample=x,
                pred_x0=step.pred_original_sample,
                pred_epsilon=step.pred_epsilon,
                prev_sample=step.prev_sample,
                timestep=t,
                prev_timestep=t_prev,
            )
            if guidance is not None:
                x_next, u, aux = guidance.apply(est_fn, schedule, state, noise, aux)
            else:
                u = estimator(est_fn, schedule, state, noise)
            uncertainty[i - w0] = u
            pred_eps[i - w0] = step.pred_epsilon
        x = x_next
        if collect_intermediates:
            inters.append(x)

    intermediates = torch.stack(inters) if collect_intermediates else None
    if not windowed:
        return SampleResult(x, None, None, None, intermediates)
    return SampleResult(x, uncertainty, pred_eps, ts[w0:w1], intermediates)


@torch.no_grad()
def sample_ddpm(
    model_fn: ModelFn,
    schedule: NoiseSchedule,
    x_T: torch.Tensor,
    noise: NoiseSource,
    cfg: SamplerConfig,
    variance_type: str = "fixed_small",
    estimator: Optional[EstimatorFn] = None,
    estimator_model_fn: Optional[ModelFn] = None,
) -> SampleResult:
    """The ancestral (stochastic) DDPM chain from ``x_T``, on its device.

    Every step draws one float32 normal of x's shape for the ancestral noise
    (the last step too, where it is masked off), then, inside the window,
    the estimator's draws. ``learned`` / ``learned_range``: ``model_fn``
    returns the model's raw output, whose channels past ``x.shape[-1]`` are
    the variance the step consumes. The chain starts at step 0 whatever
    ``cfg.start_step`` says, as JAX's does; ``pred_epsilon`` is not kept.
    """
    dcfg = cfg.diffusion
    ts = spaced_timesteps(cfg.num_train_timesteps, cfg.num_inference_steps, dcfg.timestep_spacing, dcfg.steps_offset)
    prev_ts = ts - cfg.num_train_timesteps // cfg.num_inference_steps
    learned = variance_type in ("learned", "learned_range")
    windowed = estimator is not None and cfg.num_steps_uc > 0
    w0 = w1 = 0
    if windowed:
        w0, w1 = uncertainty_window(cfg.after_step, cfg.num_steps_uc, cfg.num_inference_steps)
    uncertainty = torch.empty((w1 - w0,) + tuple(x_T.shape), dtype=torch.float32, device=x_T.device) if windowed else None
    est_fn = estimator_model_fn if estimator_model_fn is not None else model_fn

    x = x_T
    for i in range(cfg.num_inference_steps):
        t, t_prev = int(ts[i]), int(prev_ts[i])
        out = model_fn(x, t, None)
        pred_var = None
        if learned:
            out, pred_var = out[..., : x.shape[-1]], out[..., x.shape[-1] :]
        step_noise = noise.normal(x.shape, torch.float32, x.device)
        step = ddpm_step(schedule, x, out, t, t_prev, dcfg, noise=step_noise, variance_type=variance_type,
                         predicted_variance=pred_var)
        if w0 <= i < w1:
            state = StepState(x, step.pred_original_sample, step.pred_epsilon, step.prev_sample, t, t_prev)
            uncertainty[i - w0] = estimator(est_fn, schedule, state, noise)
        x = step.prev_sample

    if not windowed:
        return SampleResult(x, None, None, None)
    return SampleResult(x, uncertainty, None, ts[w0:w1])


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] floats -> uint8 images (truncating cast)."""
    x = torch.clamp(x.float() / 2.0 + 0.5, 0.0, 1.0)
    return (x * 255.0).to(torch.uint8)
