"""KDPM2 (Karras DPM-Solver-2, discrete): the second plain baseline that
``measure_times`` times the uncertainty samplers against.

JAX counterpart: ``diffusion_uncertainty_tpu/diffusion/kdpm2.py``
(``KDPM2Config``, ``_tables``, ``sample_kdpm2``, :28-111). The σ tables are
host-side float64 numpy from the schedule's float32 ᾱ, as there; the chain
is a Python loop with a float32 carry. Each step makes two model calls, one
at σ_i for the Euler slope and one at the log-space midpoint σ_mid for the
correction. The last step is Euler: its midpoint call is still made and its
result discarded, as JAX's scan body does, so the chain makes 2n calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .sampler import ModelFn, SampleResult
from .schedule import NoiseSchedule, spaced_timesteps

__all__ = ["KDPM2Config", "sample_kdpm2"]


@dataclasses.dataclass(frozen=True)
class KDPM2Config:
    num_inference_steps: int = 50
    num_train_timesteps: int = 1000
    timestep_spacing: str = "linspace"
    prediction_type: str = "epsilon"


def _tables(schedule: NoiseSchedule, cfg: KDPM2Config):
    """(timesteps, σ with a terminal 0, midpoint σ, midpoint t as a float),
    float64 from the schedule's float32 ᾱ."""
    ab = schedule.alphas_cumprod.detach().cpu().numpy().astype(np.float64)
    all_sigmas = np.sqrt((1 - ab) / ab)
    log_sigmas = np.log(all_sigmas)
    ts = spaced_timesteps(cfg.num_train_timesteps, cfg.num_inference_steps, cfg.timestep_spacing)
    sigmas = np.interp(ts.astype(np.float64), np.arange(len(all_sigmas)), all_sigmas)
    sigmas = np.concatenate([sigmas, [0.0]])  # terminal

    # midpoint σ in log space (diffusers sigmas_interpol)
    with np.errstate(divide="ignore"):
        log_s = np.log(np.maximum(sigmas, 1e-20))
    sig_mid = np.exp(0.5 * (log_s[:-1] + log_s[1:]))
    sig_mid[-1] = 0.0  # the last midpoint is unused (the final step is Euler)

    def sigma_to_t(sig):
        log_sigma = np.log(np.maximum(sig, 1e-10))
        dists = log_sigma[:, None] - log_sigmas[None, :]
        low = np.clip((dists >= 0).cumsum(axis=1).argmax(axis=1), 0, len(log_sigmas) - 2)
        high = low + 1
        w = np.clip((log_sigmas[low] - log_sigma) / (log_sigmas[low] - log_sigmas[high]), 0, 1)
        return (1 - w) * low + w * high

    t_mid = sigma_to_t(sig_mid)
    return ts, sigmas, sig_mid, t_mid


@torch.no_grad()
def sample_kdpm2(
    model_fn: ModelFn,
    schedule: NoiseSchedule,
    x_T: torch.Tensor,  # unit Gaussian; scaled here by σ_max
    noise,
    cfg: KDPM2Config,
) -> SampleResult:
    """The deterministic KDPM2 chain from ``x_T`` on its device. ``noise`` is
    the sampler's noise source, which this chain draws nothing from (the
    model calls receive None, as every trajectory forward)."""
    ts, sigmas_h, sig_mid_h, t_mid_h = _tables(schedule, cfg)
    n = cfg.num_inference_steps
    # float32 scalars, as the JAX chain's tables
    sigmas, sig_mid = sigmas_h.astype(np.float32), sig_mid_h.astype(np.float32)
    t_mid = np.round(t_mid_h).astype(np.int32)
    one = np.float32(1.0)

    def to_x0(x_hat, out, sigma):
        # Karras σ-space: x_hat = x0 + σ·ε; the model sees x_hat / sqrt(1 + σ²)
        if cfg.prediction_type == "epsilon":
            return x_hat - float(sigma) * out.float()
        if cfg.prediction_type == "sample":
            return out.float()
        raise ValueError(cfg.prediction_type)

    x = x_T.float() * float(sigmas[0])
    for i in range(n):
        sigma, sigma_next, sm = sigmas[i], sigmas[i + 1], sig_mid[i]
        scale = one / np.sqrt(sigma * sigma + one)
        out1 = model_fn((x * float(scale)).to(x.dtype), int(ts[i]), None)
        d1 = (x - to_x0(x, out1, sigma)) / float(sigma)

        x_mid = x + d1 * float(sm - sigma)
        scale_m = one / np.sqrt(sm * sm + one)
        out2 = model_fn((x_mid * float(scale_m)).to(x.dtype), int(t_mid[i]), None)
        if i == n - 1:  # Euler; the midpoint call's output is discarded
            x = x + d1 * float(sigma_next - sigma)
        else:
            d2 = (x_mid - to_x0(x_mid, out2, sm)) / float(max(sm, np.float32(1e-10)))
            x = x + d2 * float(sigma_next - sigma)
    return SampleResult(x.to(x_T.dtype), None, None, None)
