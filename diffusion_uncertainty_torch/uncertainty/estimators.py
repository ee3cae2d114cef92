"""Pixel-wise uncertainty estimators over the model function (main-path part).

JAX counterpart: ``diffusion_uncertainty_tpu/uncertainty/estimators.py``.
Ported so far: ``uncertainty_centered``, ``uncertainty_zigzag_centered``
(and their aliases), ``mc_dropout``, and ``_ensemble_noised_scores``, which
the guidance shares. ``vmap`` over the M ensemble members becomes members
folded into the batch; ``lax.map`` becomes a loop over member groups. Where
JAX hands each member its own key for a stochastic model (``mc_dropout``),
the port hands the folded forward the noise source, and the model draws one
mask of the folded [M·B, ...] activation per dropout site (``utils.rng``).

Estimator contract (see ``diffusion.sampler``):
    estimator(model_fn, schedule, state: StepState, noise) -> u  [B, ...] float32
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from ..diffusion.sampler import ModelFn, StepState
from ..diffusion.schedule import NoiseSchedule

__all__ = ["EstimatorConfig", "make_estimator", "ESTIMATORS", "ensemble_forward"]


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Estimator knobs, as in the JAX package (the fields of estimators not
    ported yet come with them)."""

    name: str = "uncertainty_centered"
    M: int = 5  # ensemble size
    num_zigzag: int = 3  # zigzag refinements per member
    predict_next: bool = False  # re-noise from x_{t-1} instead of pred_x0
    # zigzag under predict_next re-noises every refinement from the same
    # x_{t-1} and keeps only the last score: the refinements are iid draws of
    # one re-noise+forward, so collapsing them to one forward per member
    # keeps the output distribution. Off by default, as in the reference.
    zigzag_collapse: bool = False
    # 0: all M members folded into one batch; c > 0: members c at a time
    ensemble_chunk: int = 0


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
    [M, *shape] float32 draw from ``noise``)."""
    noises = noise.normal((cfg.M,) + tuple(state.pred_x0.shape), torch.float32, state.pred_x0.device)
    x_hats = torch.stack([_renoise(schedule, state, n, cfg.predict_next) for n in noises])
    return ensemble_forward(model_fn, x_hats, state.timestep, cfg.ensemble_chunk)


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


ESTIMATORS: dict[str, Callable] = {
    "uncertainty_centered": centered,
    "uncertainty_zigzag_centered": zigzag_centered,
    "dpm_2_uncertainty_centered": centered,
    "centered": centered,
    "zigzag_centered": zigzag_centered,
    "mc_dropout": mc_dropout,
}

# estimators of the JAX registry that the port does not have yet
NOT_PORTED = (
    "uncertainty", "uncertainty_original", "uncertainty_image",
    "uncertainty_centered_d", "infer_noise", "flip", "uncertainty_grad",
    "image", "centered_d",
)


def make_estimator(cfg: EstimatorConfig):
    """Bind an EstimatorConfig to its estimator. The zigzag family always
    re-noises from x_{t-1}: the reference's zigzag schedulers hardcode
    ``predict_next=True``."""
    fn = ESTIMATORS.get(cfg.name)
    if fn is None:
        if cfg.name in NOT_PORTED:
            raise KeyError(
                f"estimator {cfg.name!r} is not ported to the torch package yet; "
                f"ported: {sorted(ESTIMATORS)}; still to port: {sorted(NOT_PORTED)}"
            )
        raise KeyError(f"unknown estimator {cfg.name!r}; available: {sorted(ESTIMATORS)}")
    if fn is zigzag_centered and not cfg.predict_next:
        cfg = dataclasses.replace(cfg, predict_next=True)
    return partial(fn, cfg=cfg)
