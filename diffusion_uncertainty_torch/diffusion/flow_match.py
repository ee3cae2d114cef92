"""Flow-matching Euler sampler with uncertainty-guided steps (SD3 / Flux).

JAX counterpart: ``diffusion_uncertainty_tpu/diffusion/flow_match.py``
(``FlowMatchConfig``, ``FlowMatchResult``, ``_sigmas``, ``_quantile_mask``,
``_ensemble_vs``, ``_guided_velocity``, ``sample_flow_match``,
``sample_flow_match_stepwise``, :43-248).

With σ ∈ (1..0] and x_σ = (1−σ)·x0 + σ·ε, the model predicts the velocity
v = ε − x0 and the Euler step is x_{σ'} = x_σ + (σ' − σ)·v. In the window the
velocity is guided by an ensemble of M forwards on re-noised inputs
x̂_m = x + √(1−σ)·(n_m − v̂): the posterior branch reweights v pixel by pixel
over the M+1 predictions where the ensemble variance is above its
per-image quantile; the gradient branch adds lr·∂/∂v(Σ_px mean_b Var_M)
there, differentiated through the M forwards (each rematerialised on the
backward, ``torch.utils.checkpoint``).

Noise: the caller's x_T, then one float32 [M, *x.shape] draw from the noise
source at each window step, in step order: the order of JAX's draws, so a
test can replay them. ``sample_flow_match`` runs the M members as one folded
batch of M·B (JAX's ``vmap``); ``sample_flow_match_stepwise`` one member at a
time (JAX's host loop); both give the same result. ``velocity_fn(x, t)``
takes x [n, ...] for any n that is a multiple of the sample's batch and the
train-timestep value t = σ·T (a Python float); it runs under
``torch.no_grad`` except in the gradient branch's ensemble.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..uncertainty.guidance import quantile_mask
from .schedule import uncertainty_window

__all__ = ["FlowMatchConfig", "FlowMatchResult", "sample_flow_match", "sample_flow_match_stepwise"]


@dataclasses.dataclass(frozen=True)
class FlowMatchConfig:
    num_inference_steps: int = 28
    num_train_timesteps: int = 1000
    shift: float = 3.0  # SD3 constant timestep shift
    # Flux dynamic shifting (diffusers scheduler config defaults)
    use_dynamic_shifting: bool = False
    image_seq_len: int = 0  # packed token count; required when dynamic
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096
    base_shift: float = 0.5
    max_shift: float = 1.15
    # uncertainty window
    after_step: int = 0
    num_steps_uc: int = 0
    M: int = 5
    percentile: float = 0.9
    use_posterior: bool = True
    lr: float = 1.0


class FlowMatchResult(NamedTuple):
    sample: torch.Tensor
    uncertainty: Optional[torch.Tensor]  # [steps in window, B, ...] float32
    sigmas: Optional[np.ndarray]


def _sigmas(cfg: FlowMatchConfig) -> np.ndarray:
    """Shifted sigma schedule, s from 1 to 1/n plus a terminal 0, float32.

    Constant shift: σ = shift·s/(1+(shift−1)·s). Dynamic (Flux): μ from the
    packed sequence length (diffusers ``calculate_shift``), then σ =
    e^μ/(e^μ + 1/s − 1)."""
    s = np.linspace(1.0, 1.0 / cfg.num_inference_steps, cfg.num_inference_steps)
    if cfg.use_dynamic_shifting:
        if cfg.image_seq_len <= 0:
            raise ValueError("use_dynamic_shifting requires image_seq_len > 0")
        m = (cfg.max_shift - cfg.base_shift) / (cfg.max_image_seq_len - cfg.base_image_seq_len)
        mu = cfg.image_seq_len * m + (cfg.base_shift - m * cfg.base_image_seq_len)
        sig = math.exp(mu) / (math.exp(mu) + (1.0 / s - 1.0))
    else:
        sig = cfg.shift * s / (1.0 + (cfg.shift - 1.0) * s)
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def _quantile_mask(u: torch.Tensor, percentile: float) -> torch.Tensor:
    """1 where u is above its per-image quantile (linear interpolation)."""
    return quantile_mask(u, percentile, "higher")


def _ensemble_vs(velocity_fn, xf, v, sigma, t, noises, dtype, sequential: bool, remat: bool = False):
    """[M, B, ...] float32 velocities of the M forwards on x̂_m = x + √(1−σ)·(n_m − v̂)
    (the reference's ε-space re-noise with σ in the ᾱ slot, simplified; the
    gradient flows through v̂). ``sequential`` runs the members one at a
    time, else as one batch of M·B; ``remat`` recomputes each forward on the
    backward."""

    def fwd(xh):
        return velocity_fn(xh.to(dtype), t)

    run = (lambda xh: checkpoint(fwd, xh, use_reentrant=False)) if remat else fwd
    root = torch.sqrt(torch.clamp(1.0 - sigma, min=0.0))
    x_hats = xf[None] + root * (noises - v[None])
    m = noises.shape[0]
    if sequential:
        vs = torch.stack([run(x_hats[i]) for i in range(m)])
    else:
        vs = run(x_hats.reshape((-1,) + tuple(xf.shape[1:]))).reshape(x_hats.shape)
    return vs.float()


def _guided_velocity(velocity_fn, x, v, sigma, t, cfg: FlowMatchConfig, noise, sequential: bool):
    """The window's update of the velocity; returns (v_new, u) in float32.

    posterior: v' = v off the mask, the precision-weighted mean of the
    stacked (M re-noised + original) predictions on it.
    gradient: v' = v + lr·(∂/∂v Σ_px mean_b Var_M)·mask, the variance over
    the M re-noised members only."""
    xf = x.float()
    noises = noise.normal((cfg.M,) + tuple(v.shape), torch.float32, x.device)
    dtype = x.dtype
    if cfg.use_posterior:
        vs = _ensemble_vs(velocity_fn, xf, v, sigma, t, noises, dtype, sequential)
        stacked = torch.cat([vs, v[None]])
        u = torch.var(stacked, dim=0, correction=1)
        inv_var = 1.0 / (u + 1e-20)
        post_prec = 1.0 / (cfg.M * inv_var + 1.0 / torch.clamp(sigma, min=1e-6))
        post_v = post_prec * (inv_var * torch.sum(stacked, dim=0))
        mask = _quantile_mask(u, cfg.percentile)
        return v * (1.0 - mask) + post_v * mask, u
    with torch.enable_grad():
        vv = v.detach().requires_grad_(True)
        vs = _ensemble_vs(velocity_fn, xf, vv, sigma, t, noises, dtype, sequential, remat=True)
        uu = torch.var(vs, dim=0, correction=1)
        (grad,) = torch.autograd.grad(torch.sum(torch.mean(uu, dim=0)), vv)
    u = uu.detach()
    mask = _quantile_mask(u, cfg.percentile)
    return v + cfg.lr * grad * mask, u


def _sample(velocity_fn, x_T, noise, cfg: FlowMatchConfig, sequential: bool) -> FlowMatchResult:
    sig_host = _sigmas(cfg)
    sigmas = torch.from_numpy(sig_host).to(x_T.device)
    n = cfg.num_inference_steps
    T = np.float32(cfg.num_train_timesteps)
    w0 = w1 = 0
    if cfg.num_steps_uc > 0:
        w0, w1 = uncertainty_window(cfg.after_step, cfg.num_steps_uc, n)
    x = x_T
    u_list = []
    with torch.no_grad():
        for i in range(n):
            sigma = sigmas[i]
            t = float(sig_host[i] * T)
            v = velocity_fn(x, t).float()
            if w0 <= i < w1:
                v, u = _guided_velocity(velocity_fn, x, v, sigma, t, cfg, noise, sequential)
                u_list.append(u)
            x = (x.float() + (sigmas[i + 1] - sigma) * v).to(x_T.dtype)
    if not u_list:
        return FlowMatchResult(x, None, sig_host)
    return FlowMatchResult(x, torch.stack(u_list), sig_host[w0:w1])


def sample_flow_match(
    velocity_fn: Callable, x_T: torch.Tensor, noise, cfg: FlowMatchConfig
) -> FlowMatchResult:
    """Euler flow matching from ``x_T`` with the uncertainty window of
    ``cfg``; the ensemble as one folded batch of M·B."""
    return _sample(velocity_fn, x_T, noise, cfg, sequential=False)


def sample_flow_match_stepwise(
    velocity_fn: Callable, x_T: torch.Tensor, noise, cfg: FlowMatchConfig
) -> FlowMatchResult:
    """``sample_flow_match`` with the ensemble's members run one at a time
    (the activations of one member's forward alive at once, where the folded
    batch would not fit); the same draws and update math."""
    return _sample(velocity_fn, x_T, noise, cfg, sequential=True)
