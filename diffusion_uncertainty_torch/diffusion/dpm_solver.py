"""DPM-Solver++ multistep sampler with the uncertainty window.

JAX counterpart: ``diffusion_uncertainty_tpu/diffusion/dpm_solver.py``
(``DPMSolverConfig``, ``_karras_sigmas``, ``_sigma_to_t``,
``_dpm_spaced_timesteps``, ``_tables``, ``sample_dpm_solver``): diffusers
``DPMSolverMultistepScheduler`` defaults (dpmsolver++, solver order 2,
midpoint, ``lower_order_final``, ``final_sigmas_type='zero'``, optional
Karras sigmas), the reference's ``dpm_2_uncertainty_centered``.

The per-step tables (timesteps, σ, α, λ and the order of each step) are host
numpy float64, as in JAX; the step coefficients are formed from their
float32 values in float32, as the JAX scan reads them. The ``lax.scan``
becomes one Python loop over the steps, and each step computes only the
update of its order from the host table (JAX selects it among all three
with ``jnp.where``; the selected value is the same). The window's StepState
keeps JAX's clean conventions: ``pred_x0`` is the converted (data) output,
``pred_epsilon`` the raw model output, and ``prev_timestep`` the next
timestep of the real grid (the last one extrapolated one stride past the
end). Noise: the trajectory forwards draw none; each window step hands the
noise source to the estimator or the guidance (``uncertainty_centered``
draws one [M, *shape] tensor a step).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.rng import NoiseSource
from .ddim import _dynamic_threshold
from .sampler import EstimatorFn, ModelFn, SampleResult, StepState
from .schedule import NoiseSchedule, uncertainty_window

__all__ = ["DPMSolverConfig", "sample_dpm_solver"]


@dataclasses.dataclass(frozen=True)
class DPMSolverConfig:
    num_inference_steps: int = 50
    num_train_timesteps: int = 1000
    solver_order: int = 2
    prediction_type: str = "epsilon"  # epsilon | sample | v_prediction
    timestep_spacing: str = "linspace"  # diffusers DPM default
    steps_offset: int = 0
    use_karras_sigmas: bool = False
    lower_order_final: bool = True
    final_sigmas_type: str = "zero"  # zero | sigma_min
    thresholding: bool = False
    sample_max_value: float = 1.0
    # uncertainty window [after_step, after_step + num_steps_uc), as SamplerConfig's
    after_step: int = 0
    num_steps_uc: int = 0


def _karras_sigmas(sigma_min: float, sigma_max: float, n: int, rho: float = 7.0) -> np.ndarray:
    ramp = np.linspace(0, 1, n)
    min_inv = sigma_min ** (1 / rho)
    max_inv = sigma_max ** (1 / rho)
    return (max_inv + ramp * (min_inv - max_inv)) ** rho


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    """diffusers' piecewise-linear inversion of log-sigma back to train t."""
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma[:, None] - log_sigmas[None, :]
    low_idx = np.clip((dists >= 0).cumsum(axis=1).argmax(axis=1), 0, log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    return (1 - w) * low_idx + w * high_idx


def _dpm_spaced_timesteps(num_train_timesteps: int, n: int, spacing: str, steps_offset: int) -> np.ndarray:
    """The DPM spacings: linspace and leading take n+1 points and drop the
    last (t=0), so the chain's last model call sits one stride above zero
    and the terminal σ (``final_sigmas_type``) is where it lands."""
    if spacing == "linspace":
        ts = np.linspace(0, num_train_timesteps - 1, n + 1).round()[::-1][:-1]
    elif spacing == "leading":
        ratio = num_train_timesteps // (n + 1)
        ts = (np.arange(0, n + 1) * ratio).round()[::-1][:-1] + steps_offset
    elif spacing == "trailing":
        ratio = num_train_timesteps / n
        ts = np.arange(num_train_timesteps, 0, -ratio).round() - 1
    else:
        raise ValueError(f"unknown timestep spacing: {spacing!r}")
    return ts.astype(np.int64)


def _tables(schedule: NoiseSchedule, cfg: DPMSolverConfig):
    """(timesteps [n] int32, σ, α_t, σ_t, λ_t [n+1] float64 with the terminal
    σ, order [n] int32): warm-up steps i run at order min(solver_order, i+1);
    with ``lower_order_final`` and n < 15 the tail ramps down as min(order,
    n-i), otherwise a zero final σ makes the last step order 1."""
    ab = np.asarray(schedule.alphas_cumprod.cpu(), np.float64)
    all_sigmas = np.sqrt((1 - ab) / ab)
    log_sigmas = np.log(all_sigmas)
    if cfg.use_karras_sigmas:
        sigmas = _karras_sigmas(float(all_sigmas.min()), float(all_sigmas.max()), cfg.num_inference_steps)
        ts = np.round(_sigma_to_t(sigmas, log_sigmas)).astype(np.int64)
    else:
        ts = _dpm_spaced_timesteps(
            cfg.num_train_timesteps, cfg.num_inference_steps, cfg.timestep_spacing, cfg.steps_offset
        ).astype(np.float64)
        sigmas = np.interp(ts, np.arange(len(all_sigmas)), all_sigmas)

    final_sigma = 0.0 if cfg.final_sigmas_type == "zero" else float(np.sqrt((1 - ab[0]) / ab[0]))
    sigmas = np.concatenate([sigmas, [final_sigma]])
    alpha_t = 1.0 / np.sqrt(1.0 + sigmas**2)
    sigma_t = sigmas * alpha_t
    lambda_t = np.log(np.maximum(alpha_t, 1e-30)) - np.log(np.maximum(sigma_t, 1e-30))

    n = cfg.num_inference_steps
    order = np.minimum(cfg.solver_order, np.arange(1, n + 1))
    if cfg.lower_order_final and n < 15:
        order = np.minimum(order, np.arange(n, 0, -1))
    elif cfg.final_sigmas_type == "zero" and n >= 1:
        order[-1] = 1
    return ts.astype(np.int32), sigmas, alpha_t, sigma_t, lambda_t, order.astype(np.int32)


@torch.no_grad()
def sample_dpm_solver(
    model_fn: ModelFn,
    schedule: NoiseSchedule,
    x_T: torch.Tensor,
    noise: NoiseSource,
    cfg: DPMSolverConfig,
    estimator: Optional[EstimatorFn] = None,
    guidance=None,
    estimator_model_fn: Optional[ModelFn] = None,
) -> SampleResult:
    """The full reverse chain from ``x_T`` under DPM-Solver++ (orders 1-3,
    diffusers ``multistep_dpm_solver_{first,second,third}_order_update``),
    on ``x_T``'s device. Arguments as ``sample_ddim``'s."""
    ts, _, alpha_t, sigma_t, lambda_t, order = _tables(schedule, cfg)
    n = cfg.num_inference_steps
    # the float32 tables of the JAX scan; coefficients are float32 products of them
    al, sg, lm = (np.asarray(a, np.float32) for a in (alpha_t, sigma_t, lambda_t))
    one, half = np.float32(1.0), np.float32(0.5)
    last_prev = max(2 * int(ts[-1]) - int(ts[-2]), 0) if n > 1 else 0
    prev_ts = np.concatenate([ts[1:], [last_prev]]).astype(np.int32)

    def convert_to_x0(x, out, i):
        """dpmsolver++ data prediction (diffusers ``convert_model_output``)."""
        a, s = float(al[i]), float(sg[i])
        x, out = x.float(), out.float()
        if cfg.prediction_type == "epsilon":
            x0 = (x - s * out) / a
        elif cfg.prediction_type == "sample":
            x0 = out
        elif cfg.prediction_type == "v_prediction":
            x0 = a * x - s * out
        else:
            raise ValueError(cfg.prediction_type)
        if cfg.thresholding:
            x0 = _dynamic_threshold(x0, 0.995, cfg.sample_max_value)
        return x0

    def solver_update(x, x0, x0_prev, x0_prev2, i):
        """The dpmsolver++ update of step i's order."""
        x = x.float()
        a_next = al[i + 1]
        h = lm[i + 1] - lm[i]
        em1 = np.exp(-h) - one
        hs = one if h == 0 else h
        base = float(sg[i + 1] / sg[i]) * x - float(a_next * em1) * x0
        o = int(order[i])
        if o == 1:
            return base
        h0 = lm[i] - lm[max(i - 1, 0)]
        r0 = h0 / hs
        d1_0 = (x0 - x0_prev) / float(one if r0 == 0 else r0)
        if o == 2:  # midpoint: D1 from the previous converted output
            return base - float(half * a_next * em1) * d1_0
        h1 = lm[max(i - 1, 0)] - lm[max(i - 2, 0)]
        r1 = h1 / hs
        d1_1 = (x0_prev - x0_prev2) / float(one if r1 == 0 else r1)
        rsum = one if r0 + r1 == 0 else r0 + r1
        d1 = d1_0 + float(r0 / rsum) * (d1_0 - d1_1)
        d2 = (d1_0 - d1_1) / float(rsum)
        return base + float(a_next * (em1 / hs + one)) * d1 - float(a_next * ((em1 + h) / (hs * hs) - half)) * d2

    windowed = (estimator is not None or guidance is not None) and cfg.num_steps_uc > 0
    w0 = w1 = 0
    if windowed:
        w0, w1 = uncertainty_window(cfg.after_step, cfg.num_steps_uc, n)
    map_shape = (w1 - w0,) + tuple(x_T.shape)
    uncertainty = torch.empty(map_shape, dtype=torch.float32, device=x_T.device) if windowed else None
    pred_eps = torch.empty_like(uncertainty) if windowed else None
    est_fn = estimator_model_fn if estimator_model_fn is not None else model_fn
    aux = guidance.init(x_T) if guidance is not None else None

    x = x_T
    x0_prev = x0_prev2 = torch.zeros(x_T.shape, dtype=torch.float32, device=x_T.device)
    for i in range(n):
        t = int(ts[i])
        out = model_fn(x, t, None)
        x0 = convert_to_x0(x, out, i)
        x_next = solver_update(x, x0, x0_prev, x0_prev2, i).to(x.dtype)
        if w0 <= i < w1:
            state = StepState(
                sample=x, pred_x0=x0, pred_epsilon=out.float(), prev_sample=x_next, timestep=t,
                prev_timestep=int(prev_ts[i]),
            )
            if guidance is not None:
                x_next, u, aux = guidance.apply(est_fn, schedule, state, noise, aux)
            else:
                u = estimator(est_fn, schedule, state, noise)
            uncertainty[i - w0] = u
            pred_eps[i - w0] = state.pred_epsilon
        x, x0_prev, x0_prev2 = x_next, x0, x0_prev

    if not windowed:
        return SampleResult(x, None, None, None)
    return SampleResult(x, uncertainty, pred_eps, ts[w0:w1])
