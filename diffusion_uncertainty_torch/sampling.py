"""Batched uncertainty-map generation: the orchestration of the dataset CLI.

JAX counterpart: ``diffusion_uncertainty_tpu/sampling.py``
(``GenerationResult``, ``generate_uncertainty_dataset``, :56-177). The same
contract: the starting points are cut into batches of ``batch_size`` (the
last one padded to that size by repeating its last entry, so every batch
has one shape), each batch is sampled with ``sample_ddim`` (``sampler="ddim"``)
or ``sample_dpm_solver`` (``sampler="dpm"``: DPM-Solver++ of order 2, its
steps and window from ``sampler_cfg``) and its own noise source, and, given
a run directory, written as shards ``gen_images_<i>``,
``uncertainty_<i>`` and ``score_<i>`` (``utils.experiments``), plus
``timestep.npz`` with the first batch. A shard whose ``gen_images`` file
exists is skipped, so a cut run resumes where it stopped.

Per-batch noise: batch ``b`` draws from ``TorchNoise(batch_seed(seed, b))``
(``utils.rng.batch_seed``), so its draws do not depend on which batches ran
before it, as the JAX ``batch_key(run_key(seed), b)``. ``estimator_apply_fn``
is the model the estimator calls (the dropout forward of ``mc_dropout``); the
trajectory forward is ``apply_fn`` and stays deterministic. A latent
model's ``decode_fn`` (U-ViT's VAE decoder) maps each batch's final sample
to images before the uint8 conversion; its uncertainty maps and scores stay
in latent space. Not ported: the device mesh (ROADMAP.md queue 1 item 18)
and the FID hook.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .diffusion.dpm_solver import DPMSolverConfig, sample_dpm_solver
from .diffusion.sampler import SamplerConfig, sample_ddim, to_uint8
from .diffusion.schedule import NoiseSchedule
from .utils.experiments import save_shard
from .utils.rng import TorchNoise, batch_seed

__all__ = ["GenerationResult", "generate_uncertainty_dataset"]

log = logging.getLogger(__name__)

# conditioned model: (x, t, y, noise) -> epsilon [B, H, W, C]
ApplyFn = Callable[..., torch.Tensor]


@dataclasses.dataclass
class GenerationResult:
    gen_images: Optional[np.ndarray]  # [N, H, W, C] uint8
    uncertainty: Optional[np.ndarray]  # [N, num_steps_uc, H, W, C] float32
    pred_epsilon: Optional[np.ndarray]
    x_t: Optional[np.ndarray]  # the starting noises used
    y: Optional[np.ndarray]
    timesteps: Optional[np.ndarray]  # the window's timesteps [num_steps_uc]


def generate_uncertainty_dataset(
    apply_fn: ApplyFn,
    schedule: NoiseSchedule,
    sampler_cfg: SamplerConfig,
    X_T: np.ndarray,  # [N, H, W, C]
    y: Optional[np.ndarray],  # [N] int labels, or None (unconditional)
    batch_size: int,
    seed: int = 0,
    estimator=None,
    guidance=None,
    run_dir: Optional[Path] = None,
    shard_offset: int = 0,
    keep_in_memory: bool = True,
    collect_eps: bool = True,
    sampler: str = "ddim",  # ddim | dpm (DPM-Solver++ order 2)
    estimator_apply_fn: Optional[ApplyFn] = None,
    noise_factory: Callable = TorchNoise,
    decode_fn: Optional[Callable] = None,  # latent models: latents -> images before uint8
) -> GenerationResult:
    """Sample every starting point of ``X_T`` on the schedule's device.
    ``noise_factory(seed, device)`` makes each batch's noise source (a test
    may pass one that replays recorded draws)."""
    if sampler == "dpm":
        dpm_cfg = DPMSolverConfig(
            num_inference_steps=sampler_cfg.num_inference_steps,
            num_train_timesteps=sampler_cfg.num_train_timesteps,
            after_step=sampler_cfg.after_step,
            num_steps_uc=sampler_cfg.num_steps_uc,
        )
    elif sampler != "ddim":
        raise ValueError(f"unknown sampler {sampler!r}: ddim | dpm")
    dev = schedule.device
    n = X_T.shape[0]
    num_batches = (n + batch_size - 1) // batch_size
    images, uncs, epss, used_x, used_y = [], [], [], [], []
    window_ts = None
    for b in range(num_batches):
        shard_id = shard_offset + b
        if run_dir is not None and (Path(run_dir) / f"gen_images_{shard_id}.npz").exists():
            log.info("shard %d exists, skipping (resume)", shard_id)
            continue
        lo, hi = b * batch_size, min((b + 1) * batch_size, n)
        xb = np.asarray(X_T[lo:hi], np.float32)
        yb = np.asarray(y[lo:hi], np.int64) if y is not None else np.zeros(hi - lo, np.int64)
        pad = batch_size - (hi - lo)
        if pad:
            xb = np.concatenate([xb, np.repeat(xb[-1:], pad, axis=0)])
            yb = np.concatenate([yb, np.repeat(yb[-1:], pad, axis=0)])
        y_dev = torch.from_numpy(yb).to(dev)
        model_fn = lambda x, t, noise: apply_fn(x, t, y_dev, noise)  # noqa: E731
        est_fn = None
        if estimator_apply_fn is not None:
            est_fn = lambda x, t, noise: estimator_apply_fn(x, t, y_dev, noise)  # noqa: E731
        x_T, noise = torch.from_numpy(xb).to(dev), noise_factory(batch_seed(seed, b), dev)
        if sampler == "dpm":
            res = sample_dpm_solver(model_fn, schedule, x_T, noise, dpm_cfg, estimator=estimator, guidance=guidance,
                                    estimator_model_fn=est_fn)
        else:
            res = sample_ddim(model_fn, schedule, x_T, noise, sampler_cfg, estimator=estimator, guidance=guidance,
                              estimator_model_fn=est_fn)
        sample = res.sample if decode_fn is None else decode_fn(res.sample)
        imgs = to_uint8(sample).cpu().numpy()[: hi - lo]
        u = res.uncertainty.transpose(0, 1).cpu().numpy()[: hi - lo] if res.uncertainty is not None else None
        eps = None
        if collect_eps and res.pred_epsilon is not None:
            eps = res.pred_epsilon.transpose(0, 1).cpu().numpy()[: hi - lo]
        window_ts = res.window_timesteps

        if run_dir is not None:
            save_shard(run_dir, "gen_images", shard_id, imgs)
            if u is not None:
                save_shard(run_dir, "uncertainty", shard_id, u)
            if eps is not None:
                save_shard(run_dir, "score", shard_id, eps)
            if window_ts is not None and b == 0:
                np.savez(Path(run_dir) / "timestep.npz", data=np.asarray(window_ts))
        if keep_in_memory:
            images.append(imgs)
            used_x.append(xb[: hi - lo])
            used_y.append(yb[: hi - lo])
            if u is not None:
                uncs.append(u)
            if eps is not None:
                epss.append(eps)
        log.info("batch %d/%d done (%d images)", b + 1, num_batches, hi - lo)

    def cat(xs):
        return np.concatenate(xs, axis=0) if xs else None

    return GenerationResult(
        gen_images=cat(images) if keep_in_memory else None,
        uncertainty=cat(uncs),
        pred_epsilon=cat(epss),
        x_t=cat(used_x),
        y=cat(used_y),
        timesteps=np.asarray(window_ts) if window_ts is not None else None,
    )
