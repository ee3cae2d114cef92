"""Pixel-wise uncertainty estimators over the model function.

JAX counterpart: ``diffusion_uncertainty_tpu/uncertainty/estimators.py``
(the whole registry: ``uncertainty`` / ``uncertainty_original``
(activation noise), ``uncertainty_centered``, ``uncertainty_zigzag_centered``,
``mc_dropout``, ``uncertainty_image``, ``uncertainty_centered_d``,
``infer_noise``, ``flip``, ``uncertainty_grad``, ``dpm_2_uncertainty_centered``
and the short aliases; ``make_flip_grad_estimator``). ``vmap`` over the M
ensemble members becomes members folded into the batch; ``lax.map`` becomes
a loop over member groups. Where JAX hands each member its own key for a
stochastic model (``mc_dropout``, activation noise), the port hands the
folded forward the noise source, and the model draws one tensor of the
folded [M·B, ...] activation per site (``utils.rng``). Where JAX splits an
estimator's key into ``k_noise`` and ``k_model``, the port draws the
ensemble's re-noise [M, *shape] first and the model draws after it.

Estimator contract (see ``diffusion.sampler``):
    estimator(model_fn, schedule, state: StepState, noise) -> u  [B, ...] float32
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion.sampler import ModelFn, StepState
from ..diffusion.schedule import NoiseSchedule

__all__ = ["EstimatorConfig", "make_estimator", "make_flip_grad_estimator", "ESTIMATORS", "ensemble_forward"]


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Estimator knobs, as in the JAX package."""

    name: str = "uncertainty_centered"
    M: int = 5  # ensemble size
    num_zigzag: int = 3  # zigzag refinements per member
    predict_next: bool = False  # re-noise from x_{t-1} instead of pred_x0
    # zigzag under predict_next re-noises every refinement from the same
    # x_{t-1} and keeps only the last score: the refinements are iid draws of
    # one re-noise+forward, so collapsing them to one forward per member
    # keeps the output distribution. Off by default, as in the reference.
    zigzag_collapse: bool = False
    uncertainty_distance: int = 20  # inference steps ahead for centered_d
    # 0: all M members folded into one batch; c > 0: members c at a time
    ensemble_chunk: int = 0
    eta: float = 0.0  # DDIM eta of the image-space estimator's x_{t-1}


def _member_groups(m: int, chunk: int) -> list[range]:
    if chunk <= 0 or chunk >= m:
        return [range(m)]
    if m % chunk != 0:
        raise ValueError(f"M={m} not divisible by ensemble_chunk={chunk}")
    return [range(i, i + chunk) for i in range(0, m, chunk)]


def _fold(fn: ModelFn, xs: torch.Tensor, t, noise=None) -> torch.Tensor:
    """model_fn on [G, B, ...] inputs as one [G*B, ...] batch; ``noise`` is
    passed on (None: a deterministic forward)."""
    g, b = xs.shape[:2]
    out = fn(xs.reshape((g * b,) + xs.shape[2:]), t, noise)
    return out.reshape((g, b) + out.shape[1:])


def ensemble_forward(model_fn: ModelFn, xs: torch.Tensor, t, chunk: int = 0, noise=None) -> torch.Tensor:
    """M model forwards on stacked inputs [M, B, ...]. ``chunk=0`` folds the
    whole ensemble into one batch of M*B; ``chunk>0`` runs members ``chunk``
    at a time to bound activation memory. ``noise``: the noise source of a
    stochastic ``model_fn`` (one call per group), or None."""
    groups = _member_groups(xs.shape[0], chunk)
    if len(groups) == 1:
        return _fold(model_fn, xs, t, noise)
    return torch.cat([_fold(model_fn, xs[g.start : g.stop], t, noise) for g in groups])


def _renoise(schedule: NoiseSchedule, state: StepState, noise: torch.Tensor, predict_next: bool) -> torch.Tensor:
    """x̂_t from pred_x0 via q(x_t|x_0), or one step ahead from x_{t-1}."""
    if not predict_next:
        return schedule.add_noise(state.pred_x0, noise, state.timestep)
    beta_t = schedule.betas[min(max(state.timestep, 0), schedule.num_train_timesteps - 1)]
    return (torch.sqrt(1.0 - beta_t) * state.prev_sample.float() + torch.sqrt(beta_t) * noise).to(
        state.prev_sample.dtype
    )


def _centered_u(scores: torch.Tensor, pred_epsilon: torch.Tensor) -> torch.Tensor:
    d = scores.float() - pred_epsilon[None].float()
    return torch.mean(d * d, dim=0)


def _ensemble_noised_scores(model_fn, schedule, state: StepState, noise, cfg: EstimatorConfig):
    """[M, B, ...] scores of M independently re-noised forwards (one
    [M, *shape] float32 draw from ``noise``, then the model's draws)."""
    noises = noise.normal((cfg.M,) + tuple(state.pred_x0.shape), torch.float32, state.pred_x0.device)
    x_hats = torch.stack([_renoise(schedule, state, n, cfg.predict_next) for n in noises])
    return ensemble_forward(model_fn, x_hats, state.timestep, cfg.ensemble_chunk, noise)


def centered(model_fn, schedule, state: StepState, noise, cfg: EstimatorConfig):
    """u = mean_m (score_m − pred_eps)² over M re-noised forwards around
    pred_x0 (one [M, *shape] draw per step)."""
    return _centered_u(_ensemble_noised_scores(model_fn, schedule, state, noise, cfg), state.pred_epsilon)


def zigzag_centered(model_fn, schedule, state: StepState, noise, cfg: EstimatorConfig):
    """Centered with ``num_zigzag`` re-noise -> forward -> re-derive-x0
    refinements per member; the last refinement's score is the member's.

    Draws: member by member, zig by zig, one float32 tensor of the sample's
    shape each, whatever ``ensemble_chunk`` is."""
    ab_t = schedule.alpha_bar(state.timestep)
    sqrt_ab = torch.sqrt(ab_t)
    sqrt_1mab = torch.sqrt(1.0 - ab_t)
    n_zig = 1 if (cfg.zigzag_collapse and cfg.predict_next) else cfg.num_zigzag
    shape = tuple(state.pred_x0.shape)
    dev = state.pred_x0.device
    draws = [[noise.normal(shape, torch.float32, dev) for _ in range(n_zig)] for _ in range(cfg.M)]

    scores = []
    for group in _member_groups(cfg.M, cfg.ensemble_chunk):
        x1 = state.pred_x0.float().expand((len(group),) + shape)
        for z in range(n_zig):
            zstate = state._replace(pred_x0=x1)
            eps_z = torch.stack([draws[m][z] for m in group])
            x_hat = _renoise(schedule, zstate, eps_z, cfg.predict_next)
            score = _fold(model_fn, x_hat, state.timestep)
            x1 = (x_hat.float() - sqrt_1mab * score.float()) / sqrt_ab
        scores.append(score)
    return _centered_u(torch.cat(scores), state.pred_epsilon)


def mc_dropout(model_fn, schedule, state: StepState, noise, cfg: EstimatorConfig):
    """u = Var_m(score_m) with ddof=1 over M stochastic forwards on the same
    x_t; ``model_fn`` draws its dropout masks from ``noise`` (the reference
    runs the UNet in train mode inside the window and takes ``torch.var``)."""
    xs = state.sample.expand((cfg.M,) + tuple(state.sample.shape))
    scores = ensemble_forward(model_fn, xs, state.timestep, cfg.ensemble_chunk, noise)
    return torch.var(scores.float(), dim=0, correction=1)


def activation_noise(model_fn, schedule, state: StepState, noise, cfg: EstimatorConfig):
    """The reference's original estimator: M forwards on the same x_t, each
    member with its own N(0, 0.01²) noise at the model's activation-noise
    sites; u = mean_m (score_m − pred_eps)². ``model_fn`` draws the site
    noise from ``noise`` (the bundle's ``apply_fn_act_noise``): one tensor of
    the folded [M·B, ...] activation per site per group forward, and no
    other draw."""
    xs = state.sample.expand((cfg.M,) + tuple(state.sample.shape))
    return _centered_u(ensemble_forward(model_fn, xs, state.timestep, cfg.ensemble_chunk, noise), state.pred_epsilon)


def infer_noise(model_fn, schedule, state: StepState, noise, cfg: EstimatorConfig):
    """Centered-style re-noised forwards reduced as Var_m with ddof=1. Draws:
    one [M, *shape] re-noise, then the model's."""
    scores = _ensemble_noised_scores(model_fn, schedule, state, noise, cfg)
    return torch.var(scores.float(), dim=0, correction=1)


def image_space(model_fn, schedule, state: StepState, noise, cfg: EstimatorConfig):
    """Each member's score carried to image space x_{t-1} (DDIM with
    ``cfg.eta``) and Var_m with ddof=1 there. Draws: one [M, *shape]
    re-noise, then the model's."""
    noises = noise.normal((cfg.M,) + tuple(state.pred_x0.shape), torch.float32, state.pred_x0.device)
    x_hats = torch.stack([_renoise(schedule, state, n, cfg.predict_next) for n in noises])
    scores = ensemble_forward(model_fn, x_hats, state.timestep, cfg.ensemble_chunk, noise).float()
    ab_t = schedule.alpha_bar(state.timestep)
    ab_prev = schedule.alpha_bar(state.prev_timestep)
    std_dev_t = cfg.eta * torch.sqrt((1.0 - ab_prev) / (1.0 - ab_t) * (1.0 - ab_t / ab_prev))
    x0 = (x_hats.float() - torch.sqrt(1.0 - ab_t) * scores) / torch.sqrt(ab_t)
    direction = torch.sqrt(torch.clamp(1.0 - ab_prev - std_dev_t**2, min=0.0)) * scores
    return torch.var(torch.sqrt(ab_prev) * x0 + direction, dim=0, correction=1)


def centered_d(model_fn, schedule, state: StepState, noise, cfg: EstimatorConfig, timesteps: np.ndarray, step_index: int):
    """Centered estimator evaluated ``uncertainty_distance`` inference steps
    ahead: the model runs at the end timestep ``timesteps[step + d]`` (d cut
    at the last step) on x̂ = x_est·√ā + √(1−ā)·n with ā = ᾱ_t / ᾱ_end, and
    u = mean_m (score_m − pred_eps)². As JAX, the end timestep's value is
    passed to the model and indexes ᾱ (the reference passes the step
    index). Draws: one [M, *shape] re-noise, then the model's."""
    n_steps = len(timesteps)
    d = min(cfg.uncertainty_distance, n_steps - step_index - 1)
    end_t = int(timesteps[min(max(step_index + d, 0), n_steps - 1)])
    ab_t = schedule.alpha_bar(state.timestep)
    ab_end = schedule.alpha_bar(end_t) if d > 0 else torch.ones_like(ab_t)
    true_alpha = ab_t / ab_end
    eps = state.pred_epsilon.float()
    x_est = (state.sample.float() - torch.sqrt(1.0 - true_alpha) * eps) / torch.sqrt(true_alpha)
    noises = noise.normal((cfg.M,) + tuple(state.sample.shape), torch.float32, state.sample.device)
    x_hats = (x_est * torch.sqrt(true_alpha) + torch.sqrt(1.0 - true_alpha) * noises).to(state.sample.dtype)
    return _centered_u(ensemble_forward(model_fn, x_hats, end_t, cfg.ensemble_chunk, noise), eps)


def flip(model_fn, schedule, state: StepState, noise, cfg: EstimatorConfig):
    """One forward on pred_x0 flipped along H (dim 1 in NHWC; the reference
    flips dim 2 of NCHW): u = (pred_eps − flip(model(flip(x0), t)))². Draws:
    the model's only."""
    flipped = torch.flip(state.pred_x0.to(state.sample.dtype), dims=(1,))
    out = torch.flip(model_fn(flipped, state.timestep, noise), dims=(1,))
    d = state.pred_epsilon.float() - out.float()
    return d * d


def grad_based(model_fn, schedule, state: StepState, noise, cfg: EstimatorConfig):
    """u = |∂ Σ mean_m (score_m − ε)² / ∂ε| over M re-noised forwards around
    the x0 re-derived (unclipped) from ε, the gradient taken through the
    model (autograd on around it; the kernels' autograd wrappers carry it).
    Draws: one [M, *shape] re-noise, then the model's."""
    ab_t = schedule.alpha_bar(state.timestep)
    with torch.enable_grad():
        eps = state.pred_epsilon.float().detach().requires_grad_(True)
        x0 = (state.sample.float() - torch.sqrt(1.0 - ab_t) * eps) / torch.sqrt(ab_t)
        scores = _ensemble_noised_scores(model_fn, schedule, state._replace(pred_epsilon=eps, pred_x0=x0), noise, cfg)
        d = scores.float() - eps[None]
        (grad,) = torch.autograd.grad(torch.sum(torch.mean(d * d, dim=0)), eps)
    return grad.abs()


def make_flip_grad_estimator(model, y=None):
    """flip_grad: activation-gradient saliency of the flip-consistency loss
    MSE(ε(x), flip(ε(flip x))) on the first 3 channels. The gradient is taken
    at every ResBlock tap of the ADM (``ADMUNet.forward(taps=)``; one tap
    tensor serves both forwards, as JAX's perturbations collection); each
    map is channel-amaxed, min-max normalised over the whole tensor (1e-20
    floor), upscaled to H×W nearest (integer power-of-two factors, where
    ``F.interpolate`` and ``jax.image.resize`` pick the same pixels), and
    the maps' amax is u [B, H, W, 1]. The ``model_fn`` passed is ignored:
    the estimator needs the module (JAX ``make_flip_grad_estimator``, which
    documents why the reference's own block cannot run). Draws: none."""

    def estimator(model_fn, schedule, state: StepState, noise):
        x, t = state.sample, state.timestep
        b, height, width, _ = x.shape
        taps: dict = {}
        with torch.enable_grad():
            eps = model(x, t, y, taps=taps)[..., :3]
            eps_f = model(torch.flip(x, dims=(1,)), t, y, taps=taps)[..., :3]
            d = eps.float() - torch.flip(eps_f, dims=(1,)).float()
            grads = torch.autograd.grad(torch.mean(d * d), list(taps.values()))
        maps = []
        for g in grads:
            g = g.float().abs().amax(dim=-1, keepdim=True)
            g = (g - g.min()) / (g.max() - g.min() + 1e-20)
            g = F.interpolate(g.permute(0, 3, 1, 2), size=(height, width), mode="nearest").permute(0, 2, 3, 1)
            maps.append(g)
        return torch.cat(maps, dim=-1).amax(dim=-1, keepdim=True)

    return estimator


ESTIMATORS: dict[str, Callable] = {
    # canonical names: the reference CLI's --scheduler-type choices
    "uncertainty": activation_noise,
    "uncertainty_original": activation_noise,
    "uncertainty_centered": centered,
    "uncertainty_zigzag_centered": zigzag_centered,
    "mc_dropout": mc_dropout,
    "uncertainty_image": image_space,
    "uncertainty_centered_d": centered_d,
    "infer_noise": infer_noise,
    "flip": flip,
    "uncertainty_grad": grad_based,
    # DPM-Solver-2 carries the centered estimator inside its step (sampler="dpm")
    "dpm_2_uncertainty_centered": centered,
    # short aliases
    "centered": centered,
    "zigzag_centered": zigzag_centered,
    "image": image_space,
    "centered_d": centered_d,
}


def make_estimator(cfg: EstimatorConfig, timesteps=None):
    """Bind an EstimatorConfig to its estimator. The zigzag family always
    re-noises from x_{t-1}: the reference's zigzag schedulers hardcode
    ``predict_next=True``. ``centered_d`` needs the inference timestep table
    and recovers the step index from the state's timestep value (the first
    match; index 0 when none matches, as JAX's ``argmax``)."""
    fn = ESTIMATORS.get(cfg.name)
    if fn is None:
        raise KeyError(f"unknown estimator {cfg.name!r}; available: {sorted(ESTIMATORS)}")
    if fn is zigzag_centered and not cfg.predict_next:
        cfg = dataclasses.replace(cfg, predict_next=True)
    if fn is centered_d:
        if timesteps is None:
            raise ValueError("centered_d needs the inference timestep table")
        ts = np.asarray(timesteps)

        def bound(model_fn, schedule, state, noise):
            return centered_d(model_fn, schedule, state, noise, cfg, ts, int(np.argmax(ts == state.timestep)))

        return bound
    return partial(fn, cfg=cfg)
