"""Uncertainty-guided sampling transforms.

JAX counterpart: ``diffusion_uncertainty_tpu/uncertainty/guidance.py``, the
whole module: ``Guidance``, ``quantile_mask``, ``threshold_mask``,
``_validate_threshold_table``, ``_renoised_scores``,
``_pipeline_renoised_scores``, ``_variance_scalar``, ``_posterior_score``,
the makers (percentile, threshold, mask, MC-dropout gradient, model
gradient, ``uncertainty_grad``, second-order, score-model gradient) and
``GUIDANCE_FACTORIES`` with JAX's keys. A guidance owns its window step: it
estimates the pixel-wise uncertainty with its own ensemble forwards, changes
pred_epsilon where the map says, and recomputes x_{t-1}
(``diffusion.sampler._recompute_prev``; the scheduler-internal variants keep
the original x̂0). The gradient guidances turn autograd on around their own
scalar (the sampler runs under ``torch.no_grad``) and take
``torch.autograd.grad`` to ε or x through the model, whose kernels' autograd
wrappers in ``ops`` carry the gradient. The JAX module's deviations from the
reference (the posterior sums over the ensemble axis; ᾱ at the timestep
value) hold here too, with its compat knobs to undo them.

Guidance contract (see ``diffusion.sampler.sample_ddim``):
    init(x_T) -> aux;  apply(model_fn, schedule, state, noise, aux)
    -> (x_{t-1}, u [B, ...] float32, aux)
Draws, per window step, following JAX's key splits: the ensemble's re-noise
[M, *shape] float32 first (unless injected), then the model's draws; the
second-order guidance then draws its sign noise [*shape] (unless injected);
the mask guidance draws as its estimator; the MC-dropout gradient draws
only the model's dropout masks.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ..diffusion.ddim import DiffusionConfig
from ..diffusion.sampler import StepState, _recompute_prev
from .estimators import EstimatorConfig, _ensemble_noised_scores, ensemble_forward, make_estimator

__all__ = [
    "Guidance",
    "quantile_mask",
    "threshold_mask",
    "make_percentile_guidance",
    "make_threshold_guidance",
    "make_mask_guidance",
    "make_mc_dropout_gradient_guidance",
    "make_model_gradient_guidance",
    "make_uncertainty_grad_guidance",
    "make_second_order_guidance",
    "make_score_model_gradient_guidance",
    "GUIDANCE_FACTORIES",
]


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


def threshold_mask(u: torch.Tensor, threshold: torch.Tensor, mode: str = "higher") -> torch.Tensor:
    """Pixel-wise threshold map, float32; ``threshold`` broadcasts over the
    batch."""
    t = threshold[None] if threshold.ndim == u.ndim - 1 else threshold
    m = u > t if mode == "higher" else u < t
    return m.float()


def _validate_threshold_table(thr, step_index_offset: int, num_window_steps) -> None:
    """A per-step table is read at the global step ``step_index_offset +
    window counter``; a table too short for the window raises here (the
    reference asserts the table covers every inference step)."""
    needed = step_index_offset + (num_window_steps if num_window_steps else 1)
    if thr.shape[0] < needed:
        raise ValueError(
            f"per-step threshold table has {thr.shape[0]} rows but the guidance window reads global steps "
            f"[{step_index_offset}, {needed - 1}]: the table must cover every inference step of the producing run "
            f"(see scripts/compute_threshold_pixel_wise.py)"
        )


def _table(thr) -> torch.Tensor:
    """A per-step table (thresholds, or injected draws) on the host, float32;
    each step moves the row it reads to the device."""
    return torch.as_tensor(np.asarray(thr, np.float32))


def _as_threshold(threshold, step_index_offset: int, num_window_steps):
    """(per_step, threshold): a float is a per-image quantile, anything else
    a per-global-step table."""
    if isinstance(threshold, float):
        return False, threshold
    table = _table(threshold)
    _validate_threshold_table(table, step_index_offset, num_window_steps)
    return True, table


def _renoised_scores(model_fn, schedule, state: StepState, noise, M: int, chunk: int) -> torch.Tensor:
    """M forwards on re-noised pred_x0 (one [M, *shape] draw)."""
    return _ensemble_noised_scores(model_fn, schedule, state, noise, EstimatorConfig(M=M, ensemble_chunk=chunk))


def _pipeline_renoised_scores(model_fn, state: StepState, ab, M: int, noise, ensemble_noise=None, chunk: int = 0):
    """The guided pipelines' own ensemble: x̂0 re-derived unclipped from
    pred_epsilon, x̂ = √ᾱ·x̂0 + √(1−ᾱ)·n, M forwards. ``ensemble_noise``
    ([M, B, ...]) replaces the [M, *shape] draw from ``noise``."""
    eps = state.pred_epsilon.float()
    x0 = (state.sample.float() - torch.sqrt(1.0 - ab) * eps) / torch.sqrt(ab)
    n = ensemble_noise if ensemble_noise is not None else noise.normal((M,) + tuple(x0.shape), torch.float32, x0.device)
    x_hats = torch.sqrt(ab) * x0[None] + torch.sqrt(1.0 - ab) * n
    return ensemble_forward(model_fn, x_hats, state.timestep, chunk, noise)


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


def _eps_gradient(model_fn, schedule, state: StepState, noise, M: int, chunk: int):
    """(∂scalar/∂ε, u) of ``_variance_scalar`` at the state's ε."""
    scalar_u = _variance_scalar(model_fn, schedule, state, noise, M, chunk)
    with torch.enable_grad():
        e = state.pred_epsilon.float().detach().requires_grad_(True)
        scalar, u = scalar_u(e)
        (grad,) = torch.autograd.grad(scalar, e)
    return grad, u.detach()


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
            grad, u = _eps_gradient(model_fn, schedule, state, noise, M, ensemble_chunk)
            mask = quantile_mask(u, percentile)
            new_eps = eps + lr * grad * mask
        return _recompute_prev(schedule, state, new_eps, dcfg), u, aux

    return Guidance(_no_aux_init, apply)


def _alpha_at(schedule, state: StepState, i_global: int, compat_step_index_alpha: bool):
    """ᾱ at the timestep value, or (the reference's latent bug, for the
    compat oracle) ``alphas_cumprod`` at the global step index."""
    return schedule.alphas_cumprod[i_global] if compat_step_index_alpha else schedule.alpha_bar(state.timestep)


def _mask(u, per_step: bool, thr, i_global: int, threshold_type: str):
    if per_step:
        return threshold_mask(u, thr[i_global].to(u.device), threshold_type)
    return quantile_mask(u, thr, threshold_type)


def make_threshold_guidance(
    M: int = 5,
    threshold: Union[float, np.ndarray] = 0.9,
    threshold_type: str = "higher",
    dcfg: DiffusionConfig = DiffusionConfig(),
    ensemble_chunk: int = 0,
    step_index_offset: int = 0,
    num_window_steps: Optional[int] = None,
    compat_step_index_alpha: bool = False,
    compat_batch_sum: bool = False,
    ensemble_noise=None,
) -> Guidance:
    """Posterior-reweight guidance with a per-image quantile (a float) or a
    per-global-step pixel-wise table [num_inference_steps, ...] read at
    ``step_index_offset + window counter`` (the counter is ``aux``).
    ``compat_step_index_alpha``: ᾱ from ``alphas_cumprod`` at the step
    index; ``compat_batch_sum``: the posterior score from the last member
    summed over the batch axis (both the reference's latent bugs);
    ``ensemble_noise``: [num_steps_uc, M, B, ...] injected re-noise draws."""
    per_step, thr = _as_threshold(threshold, step_index_offset, num_window_steps)
    ens_noise = None if ensemble_noise is None else _table(ensemble_noise)

    def init(x_T):
        return 0  # window-step counter

    def apply(model_fn, schedule, state: StepState, noise, step_counter):
        i_global = step_index_offset + step_counter
        ab_t = _alpha_at(schedule, state, i_global, compat_step_index_alpha)
        eps = state.pred_epsilon.float()
        noise_i = None if ens_noise is None else ens_noise[step_counter].to(eps.device)
        scores = _pipeline_renoised_scores(model_fn, state, ab_t, M, noise, noise_i, ensemble_chunk).float()
        stacked = torch.cat([scores, eps[None]], dim=0)
        if compat_batch_sum:
            u = torch.var(stacked, dim=0, correction=1)
            inv_var = 1.0 / (u + 1e-20)
            post_precision = 1.0 / (M * inv_var + 1.0 / ab_t)
            post_score = post_precision * (inv_var * torch.sum(scores[M - 1], dim=0))
        else:
            u, post_score = _posterior_score(stacked, eps, ab_t, M)
        mask = _mask(u, per_step, thr, i_global, threshold_type)
        new_eps = post_score * mask + eps * (1.0 - mask)
        return _recompute_prev(schedule, state, new_eps, dcfg), u, step_counter + 1

    return Guidance(init, apply)


def make_mask_guidance(
    est_cfg: EstimatorConfig,
    mode: str = "binary",  # binary | multiscale
    threshold: float = 0.0,
    threshold_mode: str = "max",  # max: zero out u >= thr; min: zero out u <= thr
    normalize: bool = True,
    channel_amax: bool = False,
    dcfg: DiffusionConfig = DiffusionConfig(),
) -> Guidance:
    """Scheduler-internal epsilon masks on the estimator's map: ``binary``
    (keep the pixels below / above ``threshold`` of the z-normalised u),
    ``multiscale`` (soft 1.0 / 0.9 / 0.8 levels), and ``flip_threshold``
    (``est_cfg.name='flip', channel_amax=True``: channel-amax before the
    normalisation). The z-normalisation is over the whole tensor with the
    population std (``jnp.std``). x0 comes from the original ε; the recorded
    map is the normalised u."""
    estimator = make_estimator(est_cfg)

    def apply(model_fn, schedule, state: StepState, noise, aux):
        u = estimator(model_fn, schedule, state, noise)
        if channel_amax:
            u = u.amax(dim=-1, keepdim=True)
        un = (u - u.mean()) / u.std(correction=0) if normalize else u
        if mode == "binary":
            mask = ((un < threshold) if threshold_mode == "max" else (un > threshold)).float()
        elif mode == "multiscale":
            m2 = ((un < -2.0) & (un > -3.0)).float()
            m1 = ((un < -1.0) & (un > -2.0)).float()
            mask = 0.8 * m2 + 0.9 * m1 + (un >= -1.0).float()
        else:
            raise ValueError(mode)
        eps = state.pred_epsilon.float()
        ab_t = schedule.alpha_bar(state.timestep)
        x0 = (state.sample.float() - torch.sqrt(1.0 - ab_t) * eps) / torch.sqrt(ab_t)
        if dcfg.clip_sample:
            x0 = x0.clamp(-dcfg.clip_sample_range, dcfg.clip_sample_range)
        return _recompute_prev(schedule, state, eps * mask, dcfg, x0=x0), un, aux

    return Guidance(_no_aux_init, apply)


def make_mc_dropout_gradient_guidance(
    M: int = 5,
    mix: float = 0.1,
    dcfg: DiffusionConfig = DiffusionConfig(),
    ensemble_chunk: int = 0,
) -> Guidance:
    """ε' = (1−mix)·ε + mix·∂Var_dropout/∂x_t: Var_m (ddof=1) over M
    forwards on x_t, differentiated in x_t through the dropout forwards;
    ``model_fn`` draws its dropout masks from ``noise``."""

    def apply(model_fn, schedule, state: StepState, noise, aux):
        with torch.enable_grad():
            x = state.sample.float().detach().requires_grad_(True)
            scores = ensemble_forward(model_fn, x.expand((M,) + tuple(x.shape)), state.timestep, ensemble_chunk, noise)
            uu = torch.var(scores.float(), dim=0, correction=1)
            (grad,) = torch.autograd.grad(torch.sum(torch.mean(uu, dim=0)), x)
        new_eps = (1.0 - mix) * state.pred_epsilon.float() + mix * grad
        return _recompute_prev(schedule, state, new_eps, dcfg), uu.detach(), aux

    return Guidance(_no_aux_init, apply)


def make_model_gradient_guidance(
    M: int = 5,
    lr: float = 0.01,
    dcfg: DiffusionConfig = DiffusionConfig(),
    ensemble_chunk: int = 0,
) -> Guidance:
    """ε' = ε + lr·∂(ensemble variance)/∂ε (the JAX module documents why the
    reference's own block cannot run; this is its evident intent)."""

    def apply(model_fn, schedule, state: StepState, noise, aux):
        grad, u = _eps_gradient(model_fn, schedule, state, noise, M, ensemble_chunk)
        new_eps = state.pred_epsilon.float() + lr * grad
        return _recompute_prev(schedule, state, new_eps, dcfg), u, aux

    return Guidance(_no_aux_init, apply)


def make_uncertainty_grad_guidance(
    M: int = 5,
    dcfg: DiffusionConfig = DiffusionConfig(),
    ensemble_chunk: int = 0,
) -> Guidance:
    """The ``uncertainty_grad`` scheduler as a guidance: u = Var_m (ddof=1)
    over M re-noised forwards whose graph runs through ε; ε' = ε +
    ∂(Σ mean_b u)/∂ε · ᾱ_t; x_{t-1} keeps the original (clipped) x̂0 and
    takes only the direction term from ε'; the recorded map is u."""

    def apply(model_fn, schedule, state: StepState, noise, aux):
        ab_t = schedule.alpha_bar(state.timestep)
        grad, u = _eps_gradient(model_fn, schedule, state, noise, M, ensemble_chunk)
        new_eps = state.pred_epsilon.float() + grad * ab_t
        return _recompute_prev(schedule, state, new_eps, dcfg, x0=state.pred_x0.float()), u, aux

    return Guidance(_no_aux_init, apply)


def make_second_order_guidance(
    M: int = 5,
    threshold: Union[float, np.ndarray] = 0.9,
    threshold_type: str = "higher",
    momentum_beta: float = 0.99,
    dcfg: DiffusionConfig = DiffusionConfig(),
    ensemble_chunk: int = 0,
    step_index_offset: int = 0,
    num_window_steps: Optional[int] = None,
    compat_step_index_alpha: bool = False,
    ensemble_noise=None,
    sign_noise=None,
) -> Guidance:
    """ε' = ε + u·sign(n)·mask, u the centered mean-square over M re-noised
    forwards (not an (M+1)-variance); an EMA momentum buffer (β=0.99, from
    zeros) is carried in ``aux`` with the window counter, computed but not
    used by the update, as the reference's active line. Per-step thresholds
    at the global step; ``compat_step_index_alpha`` as the threshold
    guidance; ``ensemble_noise`` ([num_steps_uc, M, B, ...]) and
    ``sign_noise`` ([num_steps_uc, B, ...]) replace the draws."""
    per_step, thr = _as_threshold(threshold, step_index_offset, num_window_steps)
    ens_noise = None if ensemble_noise is None else _table(ensemble_noise)
    sgn_noise = None if sign_noise is None else _table(sign_noise)

    def init(x_T):
        return {"momentum": torch.zeros(x_T.shape, dtype=torch.float32, device=x_T.device), "step": 0}

    def apply(model_fn, schedule, state: StepState, noise, aux):
        step = aux["step"]
        i_global = step_index_offset + step
        eps = state.pred_epsilon.float()
        ab_t = _alpha_at(schedule, state, i_global, compat_step_index_alpha)
        noise_i = None if ens_noise is None else ens_noise[step].to(eps.device)
        scores = _pipeline_renoised_scores(model_fn, state, ab_t, M, noise, noise_i, ensemble_chunk).float()
        u = torch.mean((scores - eps[None]) ** 2, dim=0)
        mask = _mask(u, per_step, thr, i_global, threshold_type)
        momentum = momentum_beta * aux["momentum"] + (1.0 - momentum_beta) * u
        n = noise.normal(tuple(eps.shape), torch.float32, eps.device) if sgn_noise is None else sgn_noise[step].to(eps.device)
        new_eps = eps + u * torch.sign(n) * mask
        return _recompute_prev(schedule, state, new_eps, dcfg), u, {"momentum": momentum, "step": step + 1}

    return Guidance(init, apply)


def make_score_model_gradient_guidance(
    score_model_apply: Callable,  # (score_map, step index [B]) -> u map
    timesteps,  # the inference timestep table (t -> step index)
    normalize_grad: bool = False,
    dcfg: DiffusionConfig = DiffusionConfig(),
) -> Guidance:
    """Trained-surrogate gradient guidance: ε' = ε + ∂(Σ mean_b u)/∂ε · ᾱ_t
    with u = ``score_model_apply(ε, step index)``, optionally min-max
    normalising the gradient; x̂0 stays the original's, the recorded map is
    u broadcast to the image channels. Any differentiable callable serves;
    the trained surrogate itself waits for the port of training."""
    ts = np.asarray(timesteps)

    def apply(model_fn, schedule, state: StepState, noise, aux):
        ab_t = schedule.alpha_bar(state.timestep)
        eps0 = state.pred_epsilon.float()
        idx = torch.full((eps0.shape[0],), int(np.argmax(ts == state.timestep)), dtype=torch.long, device=eps0.device)
        with torch.enable_grad():
            e = eps0.detach().requires_grad_(True)
            u = score_model_apply(e, idx)
            (grad,) = torch.autograd.grad(torch.sum(torch.mean(u, dim=0)), e)
        u = u.detach()
        if normalize_grad:
            grad = (grad - grad.min()) / (grad.max() - grad.min() + 1e-20)
        u_map = u.expand(tuple(u.shape[:-1]) + (eps0.shape[-1],))
        prev = _recompute_prev(schedule, state, eps0 + grad * ab_t, dcfg, x0=state.pred_x0.float())
        return prev, u_map, aux

    return Guidance(_no_aux_init, apply)


GUIDANCE_FACTORIES = {
    "percentile_posterior": make_percentile_guidance,
    "percentile_gradient": lambda **kw: make_percentile_guidance(use_posterior=False, **kw),
    "threshold_posterior": make_threshold_guidance,
    "uncertainty_threshold": make_mask_guidance,
    "multiscale_threshold": lambda est_cfg, **kw: make_mask_guidance(est_cfg, mode="multiscale", **kw),
    "flip_threshold": lambda **kw: make_mask_guidance(EstimatorConfig(name="flip"), channel_amax=True, **kw),
    "mc_dropout_gradient": make_mc_dropout_gradient_guidance,
    "model_gradient_guided": make_model_gradient_guidance,
    "uncertainty_grad": make_uncertainty_grad_guidance,
    "second_order": make_second_order_guidance,
    "score_uncertainty_model_gradient": make_score_model_gradient_guidance,
}
