"""Uncertainty-guided generation A/B: plain DDIM against a guided run, and FID.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/generate_guided.py``
(``Config``, ``build_guidance``, ``main``), with the same flags and
defaults, plus ``--device`` (the card unless ``cpu``; no card raises). The
paper's guided-sampling experiment: the same starting points
(``scripts.generate_starting_points``) are sampled twice with
``sampling.generate_uncertainty_dataset``, plain and with the guidance of
``--guidance``:

  posterior            threshold guidance (``make_threshold_guidance``): a
                       per-image quantile ``--threshold``, or the per-step
                       pixel-wise table of ``--threshold-file`` (an npz
                       of ``scripts.compute_threshold_pixel_wise``, its
                       ``window_offset`` the producing run's first window
                       step)
  gradient, percentile the percentile guidance's gradient / posterior branch
  second_order         the second-order guidance (threshold as posterior)
  mask                 the binary mask guidance on ``infer_noise``
  mc_dropout_gradient  the MC-dropout gradient guidance
  model_gradient       the model-gradient guidance

With ``--compute-fid true`` both sets go through
``compute_fid.make_extractor`` (InceptionV3 when its weights exist, else
``RandomConvFeatures``): FID of each against the dataset's cached real
statistics where they exist, and of guided against plain. One record with
the JAX CLI's keys is appended to
``results/uncertainty_guidance/results.json``::

    python -m diffusion_uncertainty_torch.scripts.generate_starting_points --datasets imagenet128 --num-samples 8
    python -m diffusion_uncertainty_torch.scripts.generate_guided --dataset imagenet128 --guidance posterior \\
        --random-init true --num-samples 8 --batch-size 8 --generation-steps 50 --start-step-uc 40 --num-steps-uc 10

As in JAX, both runs use the bundle's deterministic forward (the
``mc_dropout_gradient`` guidance's members then agree).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..diffusion.ddim import DiffusionConfig
from ..diffusion.sampler import SamplerConfig
from ..factory import instantiate_model_scheduler
from ..sampling import generate_uncertainty_dataset
from ..uncertainty import EstimatorConfig
from ..uncertainty.guidance import (
    make_mask_guidance,
    make_mc_dropout_gradient_guidance,
    make_model_gradient_guidance,
    make_percentile_guidance,
    make_second_order_guidance,
    make_threshold_guidance,
)
from ..utils import paths
from ..utils.config import parse_config
from ..utils.logging import MetricsSink, get_logger
from .generate_dataset_score_uncertainty import load_starting_points, select_apply_fn

__all__ = ["Config", "build_guidance", "main"]

log = get_logger(__name__)


@dataclasses.dataclass
class Config:
    """Flags of the JAX CLI, plus ``device``."""

    dataset: str = "cifar10"
    guidance: str = "posterior"  # posterior | gradient | second_order | percentile | mask | mc_dropout_gradient | model_gradient
    num_samples: int = 128
    batch_size: int = 32
    generation_steps: int = 50
    M: int = 5
    start_step_uc: int = 40
    num_steps_uc: int = 10
    threshold: float = 0.95  # a per-image quantile
    threshold_file: Optional[str] = None  # per-step pixel-wise thresholds (npz)
    threshold_type: str = "higher"
    lr: float = 1.0
    eta: float = 0.0
    seed: int = 0
    start_index: int = 0
    random_init: bool = False
    dtype: str = "bfloat16"
    compute_fid: bool = True
    device: str = "cuda"


def build_guidance(cfg: Config):
    """The ``--guidance`` transform. A threshold table's row j is global step
    ``window_offset + j`` of the run that produced it, and the guidance
    reads it at the global step, so its offset is ``start_step_uc -
    window_offset``."""
    thr = cfg.threshold
    window_offset = 0
    if cfg.threshold_file:
        with np.load(cfg.threshold_file) as f:
            thr = f["data"]
            window_offset = int(f["window_offset"]) if "window_offset" in f else 0
    dcfg = DiffusionConfig(eta=cfg.eta)
    offset = cfg.start_step_uc - window_offset if cfg.threshold_file else 0
    if cfg.threshold_file and offset < 0:
        raise SystemExit(
            f"threshold table starts at global step {window_offset} but this run's window starts earlier "
            f"(start_step_uc={cfg.start_step_uc})"
        )
    if cfg.guidance == "posterior":
        return make_threshold_guidance(M=cfg.M, threshold=thr, threshold_type=cfg.threshold_type, dcfg=dcfg,
                                       step_index_offset=offset, num_window_steps=cfg.num_steps_uc)
    if cfg.guidance == "gradient":
        return make_percentile_guidance(M=cfg.M, percentile=float(cfg.threshold), use_posterior=False, lr=cfg.lr, dcfg=dcfg)
    if cfg.guidance == "percentile":
        return make_percentile_guidance(M=cfg.M, percentile=float(cfg.threshold), use_posterior=True, dcfg=dcfg)
    if cfg.guidance == "second_order":
        return make_second_order_guidance(M=cfg.M, threshold=thr, threshold_type=cfg.threshold_type, dcfg=dcfg,
                                          step_index_offset=offset, num_window_steps=cfg.num_steps_uc)
    if cfg.guidance == "mask":
        return make_mask_guidance(EstimatorConfig(name="infer_noise", M=cfg.M), dcfg=dcfg)
    if cfg.guidance == "mc_dropout_gradient":
        return make_mc_dropout_gradient_guidance(M=cfg.M, dcfg=dcfg)
    if cfg.guidance == "model_gradient":
        return make_model_gradient_guidance(M=cfg.M, dcfg=dcfg)
    raise SystemExit(f"unknown guidance {cfg.guidance!r}")


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    bundle = instantiate_model_scheduler(cfg.dataset, dtype=dtype, random_init=cfg.random_init, device=cfg.device)
    apply_fn, _ = select_apply_fn(bundle, "plain")

    x_t, y = load_starting_points(cfg.dataset, cfg.start_index, cfg.start_index + cfg.num_samples)
    if bundle.num_classes is None:
        y = None

    sampler_cfg = SamplerConfig(
        num_inference_steps=cfg.generation_steps,
        num_train_timesteps=bundle.schedule.num_train_timesteps,
        diffusion=DiffusionConfig(eta=cfg.eta),
        after_step=cfg.start_step_uc,
        num_steps_uc=cfg.num_steps_uc,
    )

    def gen(guidance, label):
        t0 = time.perf_counter()
        res = generate_uncertainty_dataset(apply_fn, bundle.schedule, sampler_cfg, x_t, y, cfg.batch_size,
                                           seed=cfg.seed, guidance=guidance, decode_fn=bundle.decode_fn)
        dt = time.perf_counter() - t0
        print(f"{label}: {len(x_t)} images in {dt:.2f} s ({len(x_t) / dt:.4f} images/s) on {bundle.schedule.device}")
        return res

    plain = gen(None, "plain")
    guided = gen(build_guidance(cfg), f"{cfg.guidance}-guided")

    record = {
        "dataset": cfg.dataset,
        "guidance": cfg.guidance,
        "threshold": cfg.threshold if not cfg.threshold_file else cfg.threshold_file,
        "num_samples": cfg.num_samples,
        "M": cfg.M,
        "start_step_uc": cfg.start_step_uc,
        "num_steps_uc": cfg.num_steps_uc,
    }
    if cfg.compute_fid:
        from ..metrics.fid import compute_statistics, extract_features, fid_from_stats, load_stats
        from .compute_fid import Config as FidConfig
        from .compute_fid import make_extractor

        try:
            real_stats = load_stats(cfg.dataset)
        except FileNotFoundError:
            log.warning("no cached real stats for %s: comparing guided with plain only", cfg.dataset)
            real_stats = None
        ext = make_extractor(FidConfig(dataset=cfg.dataset, device=cfg.device))
        f_plain = extract_features(ext, plain.gen_images, cfg.batch_size)
        f_guided = extract_features(ext, guided.gen_images, cfg.batch_size)
        if real_stats is not None:
            record["fid_plain"] = fid_from_stats(compute_statistics(f_plain), real_stats)
            record["fid_guided"] = fid_from_stats(compute_statistics(f_guided), real_stats)
        record["fid_guided_vs_plain"] = fid_from_stats(compute_statistics(f_guided), compute_statistics(f_plain))
    MetricsSink(paths.results() / "uncertainty_guidance" / "results.json").append(record)
    log.info("results: %s", record)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
