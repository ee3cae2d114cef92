"""Variational-bound NLL (bits per dimension) of learned-variance models.

JAX counterpart: ``diffusion_uncertainty_tpu/metrics/nll.py`` (:27-139), the
improved-diffusion ``calc_bpd_loop``: for every train timestep t, noise x0
to x_t, run the model, and add KL(q(x_{t-1}|x_t,x0) ‖ p_θ(x_{t-1}|x_t)) in
bits, the discretized decoder log-likelihood at t=0, and the prior KL at T.

JAX's ``lax.scan`` over t = T-1 … 0 is a Python loop here; the per-term
bits are written into tensors on the device, so the loop never reads back
to the host. Each step draws its noise from the caller's ``NoiseSource``
(``utils.rng``): one float32 tensor of x0's shape a step, t = T-1 first (the
draws JAX makes with ``jax.random.split(k, 3)`` a step, which a test can
replay).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..diffusion.schedule import NoiseSchedule
from ..utils.rng import NoiseSource

__all__ = ["normal_kl", "discretized_gaussian_log_likelihood", "calc_bpd_loop", "BPDResult"]


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal gaussians (nats, elementwise)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2) + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """Log-likelihood of images discretized to 255 bins under a gaussian
    (the standard DDPM decoder; x in [-1, 1])."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = _approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


class BPDResult(NamedTuple):
    total_bpd: torch.Tensor  # [B]
    prior_bpd: torch.Tensor  # [B]
    vb_terms: torch.Tensor  # [T, B] bits per term, t = T-1 first
    mse: torch.Tensor  # [T, B]


def _mean_flat(x):
    return x.reshape(x.shape[0], -1).mean(dim=1)


@torch.no_grad()
def calc_bpd_loop(
    model_fn6: Callable,  # (x_t, t, None) -> [B,H,W,6] (eps ‖ raw variance), or [B,H,W,3] for fixed variance
    schedule: NoiseSchedule,
    x0: torch.Tensor,  # [B,H,W,3] in [-1, 1], on the schedule's device
    noise: NoiseSource,
    variance_type: str = "learned_range",
    clip_x0: bool = True,
) -> BPDResult:
    T = schedule.num_train_timesteps
    ab = schedule.alphas_cumprod  # [T] float32
    ab_prev = torch.cat([torch.ones(1, dtype=torch.float32, device=ab.device), ab[:-1]])
    betas = schedule.betas
    posterior_var = betas * (1.0 - ab_prev) / (1.0 - ab)
    # improved-diffusion clips the t=0 posterior variance
    posterior_logvar_clipped = torch.log(torch.cat([posterior_var[1:2], posterior_var[1:]]))
    x0_coeff = torch.sqrt(ab_prev) * betas / (1.0 - ab)
    xt_coeff = torch.sqrt(1.0 - betas) * (1.0 - ab_prev) / (1.0 - ab)
    max_logs = torch.log(torch.clamp(betas, min=1e-20))

    x0f = x0.float()
    ln2 = math.log(2.0)
    vb_terms = torch.empty((T, x0.shape[0]), dtype=torch.float32, device=x0.device)
    mse = torch.empty_like(vb_terms)

    for i, t in enumerate(range(T - 1, -1, -1)):
        eps_draw = noise.normal(x0f.shape, torch.float32, x0f.device)
        x_t = torch.sqrt(ab[t]) * x0f + torch.sqrt(1.0 - ab[t]) * eps_draw

        out = model_fn6(x_t, t, None).float()
        eps, var_raw = out[..., :3], out[..., 3:]

        pred_x0 = (x_t - torch.sqrt(1.0 - ab[t]) * eps) / torch.sqrt(ab[t])
        if clip_x0:
            pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
        model_mean = x0_coeff[t] * pred_x0 + xt_coeff[t] * x_t

        min_log = posterior_logvar_clipped[t]
        if variance_type == "learned_range":
            frac = (var_raw + 1.0) / 2.0
            model_logvar = frac * max_logs[t] + (1.0 - frac) * min_log
        elif variance_type == "learned":
            model_logvar = var_raw
        else:  # fixed posterior variance (3-channel models have no variance channels)
            model_logvar = min_log.expand(x_t.shape)

        if t == 0:
            decoder_nll = -discretized_gaussian_log_likelihood(x0f, model_mean, 0.5 * model_logvar)
            vb_terms[i] = _mean_flat(decoder_nll) / ln2
        else:
            true_mean = x0_coeff[t] * x0f + xt_coeff[t] * x_t
            true_logvar = posterior_logvar_clipped[t].expand(model_logvar.shape)
            vb_terms[i] = _mean_flat(normal_kl(true_mean, true_logvar, model_mean, model_logvar)) / ln2
        mse[i] = _mean_flat((eps - eps_draw) ** 2)

    # prior KL(q(x_T|x_0) || N(0, I)) in bits
    qT_mean = torch.sqrt(ab[T - 1]) * x0f
    qT_logvar = torch.log(1.0 - ab[T - 1]).expand(x0f.shape)
    prior = _mean_flat(normal_kl(qT_mean, qT_logvar, torch.zeros_like(qT_mean), torch.zeros_like(qT_logvar))) / ln2

    total = vb_terms.sum(dim=0) + prior
    return BPDResult(total_bpd=total, prior_bpd=prior, vb_terms=vb_terms, mse=mse)
