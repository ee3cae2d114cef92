"""Uncertainty-guided sampling transforms (percentile guidance).

JAX counterpart: ``diffusion_uncertainty_tpu/uncertainty/guidance.py``
(``Guidance``, ``quantile_mask``, ``_recompute_prev``, ``_renoised_scores``,
``_variance_scalar``, ``_posterior_score``, ``make_percentile_guidance``,
:48-210). A guidance owns its window step: it estimates the pixel-wise
uncertainty with its own ensemble forwards, masks the most uncertain pixels
of each image (per-image quantile), replaces pred_epsilon there and
recomputes x_{t-1}. Both branches of the reference's
``get_uncertainty_guided_score_with_percentile`` are here: the posterior
reweighting and the gradient step ``eps += lr · ∂u/∂eps · mask``, whose
gradient is ``torch.autograd.grad`` through the model (the kernels' autograd
wrappers in ``ops``). The JAX module's deviations from the reference (the
posterior sums over the ensemble axis; ᾱ at the timestep value) hold here
too. The other guidance makers (threshold, mask, MC-dropout, model-gradient,
second-order, score-model) are not ported yet.

Guidance contract (see ``diffusion.sampler.sample_ddim``):
    init(x_T) -> aux;  apply(model_fn, schedule, state, noise, aux)
    -> (x_{t-1}, u [B, ...] float32, aux)
Draws: one [M, *shape] float32 tensor from ``noise`` per window step.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..diffusion.ddim import DiffusionConfig
from ..diffusion.sampler import StepState, _recompute_prev
from .estimators import EstimatorConfig, _ensemble_noised_scores

__all__ = ["Guidance", "quantile_mask", "make_percentile_guidance"]


class Guidance(NamedTuple):
    """init(x_T) -> aux; apply(model_fn, schedule, state, noise, aux) ->
    (next_sample, uncertainty_map, aux)."""

    init: Callable[[torch.Tensor], Any]
    apply: Callable[..., tuple]


def _no_aux_init(x_T):
    return None


def quantile_mask(u: torch.Tensor, percentile: float, mode: str = "higher") -> torch.Tensor:
    """Per-image quantile threshold map, float32 (linear interpolation, as
    ``jnp.quantile``)."""
    b = u.shape[0]
    q = torch.quantile(u.reshape(b, -1).float(), percentile, dim=1)
    q = q.reshape((b,) + (1,) * (u.ndim - 1))
    m = u > q if mode == "higher" else u < q
    return m.float()


def _renoised_scores(model_fn, schedule, state: StepState, noise, M: int, chunk: int) -> torch.Tensor:
    """M forwards on re-noised pred_x0 (one [M, *shape] draw)."""
    return _ensemble_noised_scores(model_fn, schedule, state, noise, EstimatorConfig(M=M, ensemble_chunk=chunk))


def _variance_scalar(model_fn, schedule, state: StepState, noise, M: int, chunk: int):
    """The differentiable ``e -> (scalar, u)`` of the gradient guidance:
    Var_m (ddof=1) over M re-noised forwards around the x0 re-derived
    (unclipped) from ``e``, scalarised as the batch mean of the per-pixel
    variances summed over pixels. Each call draws the ensemble noise anew."""

    def at(e: torch.Tensor):
        ab_t = schedule.alpha_bar(state.timestep)
        x0 = (state.sample.float() - torch.sqrt(1.0 - ab_t) * e) / torch.sqrt(ab_t)
        st = state._replace(pred_epsilon=e, pred_x0=x0)
        scores = _renoised_scores(model_fn, schedule, st, noise, M, chunk)
        uu = torch.var(scores.float(), dim=0, correction=1)
        return torch.sum(torch.mean(uu, dim=0)), uu

    return at


def _posterior_score(scores_with_eps: torch.Tensor, eps: torch.Tensor, ab_t, M: int):
    """(u, score): u = Var (ddof=1) over the stacked M re-noised scores and
    the original eps; precision-weighted posterior score
    1/(M/u + 1/ᾱ_t) · (1/u) · Σ_m scores_m (1e-20 floor on u)."""
    u = torch.var(scores_with_eps, dim=0, correction=1)
    inv_var = 1.0 / (u + 1e-20)
    post_precision = 1.0 / (M * inv_var + 1.0 / ab_t)
    post_score = post_precision * (inv_var * torch.sum(scores_with_eps, dim=0))
    return u, post_score


def make_percentile_guidance(
    M: int = 5,
    percentile: float = 0.9,
    use_posterior: bool = True,
    lr: float = 1.0,
    dcfg: DiffusionConfig = DiffusionConfig(),
    ensemble_chunk: int = 0,
) -> Guidance:
    """Percentile-mask guidance: per-image quantile mask over the ensemble
    variance; posterior reweighting (``use_posterior``) or
    eps += lr · ∂u/∂eps · mask."""

    def apply(model_fn, schedule, state: StepState, noise, aux):
        ab_t = schedule.alpha_bar(state.timestep)
        eps = state.pred_epsilon.float()
        if use_posterior:
            scores = _renoised_scores(model_fn, schedule, state, noise, M, ensemble_chunk)
            stacked = torch.cat([scores.float(), eps[None]], dim=0)
            u, post_score = _posterior_score(stacked, eps, ab_t, M)
            mask = quantile_mask(u, percentile)
            new_eps = eps * (1.0 - mask) + mask * post_score
        else:
            scalar_u = _variance_scalar(model_fn, schedule, state, noise, M, ensemble_chunk)
            with torch.enable_grad():
                e = eps.detach().requires_grad_(True)
                scalar, u = scalar_u(e)
                (grad,) = torch.autograd.grad(scalar, e)
            u = u.detach()
            mask = quantile_mask(u, percentile)
            new_eps = eps + lr * grad * mask
        return _recompute_prev(schedule, state, new_eps, dcfg), u, aux

    return Guidance(_no_aux_init, apply)
