"""Grid benchmark of the estimators and guidances on one dataset.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/uncertainty_benchmark.py``
(``ESTIMATOR_METHODS``, ``GUIDED_METHODS``, ``Config``, ``main``), with the
same flags and defaults, plus ``--device`` (the card unless ``cpu``; no card
raises). Each method of ``--methods`` samples the same starting points
(``scripts.generate_starting_points``) through
``sampling.generate_uncertainty_dataset`` with a model built anew; one record
each (wall seconds, images/s, the mean of its maps) is appended to
``results/uncertainty_benchmark.json``::

    python -m diffusion_uncertainty_torch.scripts.generate_starting_points --datasets imagenet128 --num-samples 8
    python -m diffusion_uncertainty_torch.scripts.uncertainty_benchmark --dataset imagenet128 --random-init true \\
        --num-samples 8 --batch-size 8 --generation-steps 20 --start-step-uc 16 --num-steps-uc 4

As in JAX, the trajectory forward is the bundle's deterministic one
(``select_apply_fn``): ``mc_dropout_gradient`` gets no dropout forward, so its
members agree.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from ..diffusion.sampler import SamplerConfig
from ..factory import instantiate_model_scheduler
from ..sampling import generate_uncertainty_dataset
from ..uncertainty import EstimatorConfig, make_estimator
from ..uncertainty.guidance import GUIDANCE_FACTORIES
from ..utils import paths
from ..utils.config import parse_config
from ..utils.logging import MetricsSink, get_logger
from .generate_dataset_score_uncertainty import load_starting_points, select_apply_fn

__all__ = ["ESTIMATOR_METHODS", "GUIDED_METHODS", "Config", "main"]

log = get_logger(__name__)

ESTIMATOR_METHODS = (
    "uncertainty_centered",
    "uncertainty_zigzag_centered",
    "mc_dropout",
    "flip",
    "infer_noise",
    "uncertainty_image",
)
GUIDED_METHODS = ("uncertainty_threshold", "multiscale_threshold", "mc_dropout_gradient", "model_gradient_guided")


@dataclasses.dataclass
class Config:
    """Flags of the JAX CLI, plus ``device``."""

    dataset: str = "cifar10"
    methods: tuple = ESTIMATOR_METHODS
    num_samples: int = 64
    batch_size: int = 32
    generation_steps: int = 20
    M: int = 5
    start_step_uc: int = 0
    num_steps_uc: int = 20
    seed: int = 0
    start_index: int = 0
    random_init: bool = False
    dtype: str = "bfloat16"
    device: str = "cuda"


def main(argv=None) -> list:
    cfg = parse_config(Config, argv)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    sink = MetricsSink(paths.results() / "uncertainty_benchmark.json")
    x_t, y = load_starting_points(cfg.dataset, cfg.start_index, cfg.start_index + cfg.num_samples)
    results = []
    for method in cfg.methods:
        bundle = instantiate_model_scheduler(
            cfg.dataset, dropout=0.1 if "dropout" in method else 0.0, dtype=dtype, random_init=cfg.random_init,
            device=cfg.device,
        )
        yy = y if bundle.num_classes is not None else None
        sampler_cfg = SamplerConfig(
            num_inference_steps=cfg.generation_steps,
            num_train_timesteps=bundle.schedule.num_train_timesteps,
            after_step=cfg.start_step_uc,
            num_steps_uc=cfg.num_steps_uc,
        )
        estimator = guidance = None
        if method in GUIDANCE_FACTORIES:
            factory = GUIDANCE_FACTORIES[method]
            if method in ("uncertainty_threshold", "multiscale_threshold"):
                guidance = factory(EstimatorConfig(name="infer_noise", M=cfg.M))
            else:
                guidance = factory(M=cfg.M)
        else:
            estimator = make_estimator(EstimatorConfig(name=method, M=cfg.M))
        apply_fn, estimator_apply_fn = select_apply_fn(bundle, method)

        if bundle.schedule.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate_uncertainty_dataset(
            apply_fn, bundle.schedule, sampler_cfg, x_t, yy, cfg.batch_size, seed=cfg.seed, estimator=estimator,
            guidance=guidance, estimator_apply_fn=estimator_apply_fn, decode_fn=bundle.decode_fn,
        )
        if bundle.schedule.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        rec = {
            "dataset": cfg.dataset,
            "method": method,
            "num_samples": cfg.num_samples,
            "wall_s": round(elapsed, 2),
            "images_per_sec": round(cfg.num_samples / elapsed, 3),
            "mean_uncertainty": float(np.mean(res.uncertainty)) if res.uncertainty is not None else None,
        }
        sink.append(rec)
        results.append(rec)
        log.info("%s: %s", method, rec)
        del bundle, res
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
