"""Generate per-sample pixel-wise uncertainty maps: the paper's dataset CLI.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/generate_dataset_score_uncertainty.py``
(``Config``, ``select_apply_fn``, ``load_starting_points``, ``main``), with
the same flags and defaults, plus ``--device`` (the card unless ``cpu``; no
card raises). Reads the shared starting points
(``scripts.generate_starting_points``), builds the dataset's model and
schedule (``factory``), and writes the run's shards (``sampling``) into
``results/score-uncertainty/<timestamp>/`` or ``--run-dir``.

    python -m diffusion_uncertainty_torch.scripts.generate_starting_points --datasets cifar10
    DU_TPU_WINOGRAD=1 python -m diffusion_uncertainty_torch.scripts.generate_dataset_score_uncertainty \\
        --dataset cifar10 --scheduler-type mc_dropout --random-init true \\
        --num-samples 128 --batch-size 128 --M 5 --generation-steps 50 \\
        --start-step-uc 40 --num-steps-uc 10

``DU_TPU_WINOGRAD=1``, the switch the JAX package honours, is read once here
and builds the model with its Winograd conv route on. Runs: ``cifar10``,
``imagenet64``, ``imagenet128``, ``tiny`` and the U-ViT latent datasets
``imagenet256`` and ``imagenet512`` (sampled in latent space and decoded to
images by the bundle's VAE) with every scheduler type of the JAX CLI: the
estimators of ``uncertainty.ESTIMATORS`` (``uncertainty`` and
``uncertainty_original`` on the activation-noise forward, ``mc_dropout`` on
the dropout forward, ``dpm_2_uncertainty_centered`` on the DPM-Solver++
sampler) and ``uncertainty_grad``, a guidance
(``uncertainty.resolve_scheduler_transform``); and ADM classifier guidance
(``--classifier-scale`` > 0: the trajectory forward guided by the dataset's
noisy classifier, ``factory.load_classifier``; the window's ensemble runs
the unguided model):

    python -m diffusion_uncertainty_torch.scripts.generate_starting_points --datasets imagenet256
    python -m diffusion_uncertainty_torch.scripts.generate_dataset_score_uncertainty --dataset imagenet256 \\
        --scheduler-type uncertainty_zigzag_centered --random-init true --num-samples 8 --batch-size 8 \\
        --M 5 --num-zigzag 3 --generation-steps 50 --start-step-uc 40 --num-steps-uc 10
    python -m diffusion_uncertainty_torch.scripts.generate_dataset_score_uncertainty --dataset imagenet128 \\
        --scheduler-type uncertainty_grad --random-init true --num-samples 8 --batch-size 8 --M 5 \\
        --generation-steps 50 --start-step-uc 40 --num-steps-uc 10

Not ported yet: the device mesh (``--mesh-data`` > 1 exits naming ROADMAP.md
queue 1 item 18).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..classifier_guidance import with_classifier_guidance
from ..diffusion.ddim import DiffusionConfig
from ..diffusion.sampler import SamplerConfig
from ..diffusion.schedule import spaced_timesteps
from ..factory import instantiate_model_scheduler, load_classifier
from ..sampling import generate_uncertainty_dataset
from ..uncertainty import EstimatorConfig, resolve_scheduler_transform
from ..utils import paths
from ..utils.config import parse_config, save_config
from ..utils.experiments import new_run_dir

__all__ = ["Config", "select_apply_fn", "load_starting_points", "local_shard_bounds", "main"]


@dataclasses.dataclass
class Config:
    """Flags of the JAX CLI (the reference's), plus ``device``."""

    dataset: str = "cifar10"
    scheduler_type: str = "uncertainty_centered"
    num_samples: int = 300
    batch_size: int = 32
    generation_steps: int = 20
    M: int = 30
    start_step_uc: int = 0
    num_steps_uc: int = 20
    seed: int = 0
    eta: float = 0.0
    dropout: float = 0.1
    start_index: int = 0
    predict_next: bool = False
    uncertainty_distance: int = 20
    num_zigzag: int = 3
    ensemble_chunk: int = 0
    # classifier guidance
    classifier_scale: float = 0.0
    # parallelism
    mesh_data: int = 0  # 0 = no mesh (one card)
    worker_index: int = 0
    num_workers: int = 1
    # environment
    checkpoint: Optional[str] = None
    random_init: bool = False
    dtype: str = "bfloat16"
    run_dir: Optional[str] = None
    device: str = "cuda"


def select_apply_fn(bundle, scheduler_type: str):
    """(trajectory forward, estimator forward or None). The stochastic
    variants' noise lives only in the uncertainty ensemble (MC dropout, the
    activation noise of the original estimator): the trajectory forward is
    deterministic."""
    if scheduler_type == "mc_dropout":
        return bundle.apply_fn, bundle.apply_fn_dropout
    if scheduler_type in ("uncertainty", "uncertainty_original"):
        return bundle.apply_fn, bundle.apply_fn_act_noise
    return bundle.apply_fn, None


def load_starting_points(dataset: str, start: int, stop: int):
    folder = paths.starting_points() / dataset
    if not (folder / "X_T.npz").exists():
        raise FileNotFoundError(f"{folder}/X_T.npz not found: run scripts.generate_starting_points first")
    with np.load(folder / "X_T.npz") as f:
        x = f["data"][start:stop]
    with np.load(folder / "y.npz") as f:
        y = f["data"][start:stop]
    return x, y


def local_shard_bounds(total: int, rank: int, world: int) -> tuple[int, int]:
    """[start, stop) of this worker's contiguous slice of the starting points."""
    per = total // world
    start = rank * per
    stop = total if rank == world - 1 else start + per
    return start, stop


def main(argv=None) -> Path:
    cfg = parse_config(Config, argv)
    if cfg.mesh_data > 1:
        raise SystemExit("the device mesh is not ported yet: ROADMAP.md queue 1, item 18 (parallelism)")
    winograd = os.environ.get("DU_TPU_WINOGRAD", "0") == "1"
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    bundle = instantiate_model_scheduler(
        cfg.dataset,
        dropout=cfg.dropout if cfg.scheduler_type == "mc_dropout" else 0.0,
        dtype=dtype,
        checkpoint=Path(cfg.checkpoint) if cfg.checkpoint else None,
        random_init=cfg.random_init,
        device=cfg.device,
        winograd=winograd,
    )

    w_start, w_stop = local_shard_bounds(cfg.num_samples, cfg.worker_index, cfg.num_workers)
    x_t, y = load_starting_points(cfg.dataset, cfg.start_index + w_start, cfg.start_index + w_stop)
    if bundle.num_classes is None:
        y = None

    sampler_cfg = SamplerConfig(
        num_inference_steps=cfg.generation_steps,
        num_train_timesteps=bundle.schedule.num_train_timesteps,
        diffusion=DiffusionConfig(eta=cfg.eta),
        after_step=cfg.start_step_uc,
        num_steps_uc=cfg.num_steps_uc,
    )
    est_cfg = EstimatorConfig(
        name=cfg.scheduler_type,
        M=cfg.M,
        num_zigzag=cfg.num_zigzag,
        predict_next=cfg.predict_next,
        uncertainty_distance=cfg.uncertainty_distance,
        ensemble_chunk=cfg.ensemble_chunk,
        eta=cfg.eta,
    )
    ts = spaced_timesteps(bundle.schedule.num_train_timesteps, cfg.generation_steps)
    estimator, guidance = resolve_scheduler_transform(est_cfg, timesteps=ts, dcfg=DiffusionConfig(eta=cfg.eta))
    apply_fn, estimator_apply_fn = select_apply_fn(bundle, cfg.scheduler_type)
    if cfg.classifier_scale > 0:
        classifier = load_classifier(cfg.dataset, random_init=cfg.random_init, device=cfg.device)
        if estimator_apply_fn is None:
            estimator_apply_fn = apply_fn  # only the trajectory forward is guided
        apply_fn = with_classifier_guidance(apply_fn, classifier, bundle.schedule, cfg.classifier_scale)

    run_dir = Path(cfg.run_dir) if cfg.run_dir else new_run_dir()
    if not (run_dir / "args.yaml").exists():
        save_config(cfg, run_dir / "args.yaml", winograd=winograd)
    print(f"run dir: {run_dir}")

    t0 = time.perf_counter()
    generate_uncertainty_dataset(
        apply_fn,
        bundle.schedule,
        sampler_cfg,
        x_t,
        y,
        cfg.batch_size,
        seed=cfg.seed,
        estimator=estimator,
        guidance=guidance,
        estimator_apply_fn=estimator_apply_fn,
        run_dir=run_dir,
        shard_offset=cfg.worker_index * 100000,  # disjoint shard ids per worker
        keep_in_memory=False,
        decode_fn=bundle.decode_fn,
        sampler="dpm" if cfg.scheduler_type == "dpm_2_uncertainty_centered" else "ddim",
    )
    if bundle.schedule.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"{len(x_t)} images in {dt:.2f} s ({len(x_t) / dt:.4f} images/s) on {bundle.schedule.device}; artifacts in {run_dir}")
    return run_dir


if __name__ == "__main__":
    main(sys.argv[1:])
