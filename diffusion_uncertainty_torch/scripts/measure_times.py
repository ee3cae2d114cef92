"""Wall-clock comparison: uncertainty sampling against a plain baseline.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/measure_times.py``
(``Config``, ``_time``, ``main``), with the same flags and defaults, plus
``--device`` (the card unless ``cpu``; no card raises). The paper's overhead
protocol: one batch sampled with ``--scheduler-type`` over its window
(``sample_ddim`` with the estimator or guidance), and the same batch with a
plain sampler, ``--baseline ddim`` (``sample_ddim`` without a window) or
``kdpm2`` (``diffusion.kdpm2``, two model calls a step). Each is called once
to warm up (cuDNN and cuBLAS plans, the kernels' first launch), then
``--repeats`` times; the minimum counts, with ``torch.cuda.synchronize()``
before each clock read. One record with the JAX CLI's keys is appended to
``results/times.json`` (``device``: the card's name)::

    python -m diffusion_uncertainty_torch.scripts.measure_times --dataset imagenet128 --random-init true \\
        --batch-size 8 --scheduler-type uncertainty_zigzag_centered --M 5 --num-zigzag 3 \\
        --generation-steps 50 --start-step-uc 40 --num-steps-uc 10 --baseline kdpm2

As in JAX, x_T is drawn at (image_size, image_size, 3), so the latent
datasets (``imagenet256``, ``imagenet512``) do not run through it.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from ..diffusion.ddim import DiffusionConfig
from ..diffusion.kdpm2 import KDPM2Config, sample_kdpm2
from ..diffusion.sampler import SamplerConfig, sample_ddim
from ..factory import instantiate_model_scheduler
from ..uncertainty import EstimatorConfig, resolve_scheduler_transform
from ..utils import paths
from ..utils.config import parse_config
from ..utils.logging import MetricsSink, get_logger
from ..utils.rng import TorchNoise
from .generate_dataset_score_uncertainty import select_apply_fn

__all__ = ["Config", "main"]

log = get_logger(__name__)


@dataclasses.dataclass
class Config:
    """Flags of the JAX CLI, plus ``device``."""

    dataset: str = "cifar10"
    scheduler_type: str = "uncertainty_centered"
    batch_size: int = 32
    generation_steps: int = 50
    M: int = 5
    start_step_uc: int = 40
    num_steps_uc: int = 10
    num_zigzag: int = 3
    seed: int = 0
    repeats: int = 3
    baseline: str = "ddim"  # ddim | kdpm2
    random_init: bool = False
    dtype: str = "bfloat16"
    device: str = "cuda"


def _time(fn, repeats: int = 3, sync=lambda: None) -> float:
    """min seconds of ``fn()`` over ``repeats`` calls after one warm-up call,
    ``sync()`` before each clock read."""
    fn()
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    bundle = instantiate_model_scheduler(
        cfg.dataset, dropout=0.1 if cfg.scheduler_type == "mc_dropout" else 0.0, dtype=dtype,
        random_init=cfg.random_init, device=cfg.device,
    )
    apply_fn, estimator_apply_fn = select_apply_fn(bundle, cfg.scheduler_type)
    dev = bundle.schedule.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    size = bundle.image_size
    x_T = TorchNoise(cfg.seed, dev).normal((cfg.batch_size, size, size, 3))
    y = torch.zeros((cfg.batch_size,), dtype=torch.int64, device=dev)

    est, guid = resolve_scheduler_transform(EstimatorConfig(name=cfg.scheduler_type, M=cfg.M, num_zigzag=cfg.num_zigzag))
    uc_cfg = SamplerConfig(
        num_inference_steps=cfg.generation_steps,
        num_train_timesteps=bundle.schedule.num_train_timesteps,
        after_step=cfg.start_step_uc,
        num_steps_uc=cfg.num_steps_uc,
        diffusion=DiffusionConfig(),
    )
    plain_cfg = dataclasses.replace(uc_cfg, num_steps_uc=0)
    mf = lambda x, t, noise: apply_fn(x, t, y, noise)  # noqa: E731
    emf = None if estimator_apply_fn is None else (lambda x, t, noise: estimator_apply_fn(x, t, y, noise))

    # every call draws the same noise, as the JAX CLI passes one key to each
    def f_uc():
        return sample_ddim(mf, bundle.schedule, x_T, TorchNoise(cfg.seed + 1, dev), uc_cfg, estimator=est, guidance=guid,
                           estimator_model_fn=emf)

    if cfg.baseline == "kdpm2":
        k_cfg = KDPM2Config(num_inference_steps=cfg.generation_steps, num_train_timesteps=bundle.schedule.num_train_timesteps)

        def f_plain():
            return sample_kdpm2(mf, bundle.schedule, x_T, TorchNoise(cfg.seed + 1, dev), k_cfg)
    else:
        def f_plain():
            return sample_ddim(mf, bundle.schedule, x_T, TorchNoise(cfg.seed + 1, dev), plain_cfg)

    t_uc = _time(f_uc, repeats=cfg.repeats, sync=sync)
    t_plain = _time(f_plain, repeats=cfg.repeats, sync=sync)

    record = {
        "dataset": cfg.dataset,
        "scheduler_type": cfg.scheduler_type,
        "baseline": cfg.baseline,
        "batch_size": cfg.batch_size,
        "generation_steps": cfg.generation_steps,
        "M": cfg.M,
        "num_steps_uc": cfg.num_steps_uc,
        "time_uncertainty_s": round(t_uc, 4),
        "time_plain_s": round(t_plain, 4),
        "overhead_x": round(t_uc / t_plain, 3),
        "images_per_sec_uncertainty": round(cfg.batch_size / t_uc, 3),
        "images_per_sec_plain": round(cfg.batch_size / t_plain, 3),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
    }
    MetricsSink(paths.results() / "times.json").append(record)
    log.info("times: %s", record)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
