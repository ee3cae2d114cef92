"""Bits-per-dim NLL: the variational bound of a learned-variance model.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/compute_nll.py``, with
the same flags and defaults, plus ``--device`` (the card unless ``cpu``; no
card raises). The model's full output (epsilon and the raw variance, 6
channels for ADM) with each batch's labels runs at every train timestep
(``metrics.nll.calc_bpd_loop``, ``learned_range`` by default); the mean
total bpd goes to ``results/nll/results_<dataset>.yaml``. Without
``--data-root`` the images are the synthetic dataset::

    python -m diffusion_uncertainty_torch.scripts.compute_nll --dataset imagenet64 \\
        --batch-size 8 --num-samples 8 --random-init true

Each batch draws its noise from ``TorchNoise(batch_seed(seed, b))``.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..datasets import CIFAR10Dataset, ImagenetDataset, SyntheticDataset, iterate_batches
from ..factory import instantiate_model_scheduler
from ..metrics.nll import calc_bpd_loop
from ..utils import paths
from ..utils.config import parse_config, save_config
from ..utils.logging import get_logger
from ..utils.rng import TorchNoise, batch_seed

__all__ = ["Config", "NLLResult", "main"]

log = get_logger(__name__)


@dataclasses.dataclass
class Config:
    """Flags of the JAX CLI, plus ``device``."""

    dataset: str = "imagenet64"
    num_samples: int = 64
    batch_size: int = 8
    seed: int = 0
    variance_type: str = "learned_range"
    data_root: Optional[str] = None  # real images; None -> synthetic smoke
    random_init: bool = False
    dtype: str = "bfloat16"
    device: str = "cuda"


class NLLResult(NamedTuple):
    total_bpd: float
    seconds_per_batch: float


def main(argv=None) -> NLLResult:
    cfg = parse_config(Config, argv)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    bundle = instantiate_model_scheduler(cfg.dataset, dtype=dtype, random_init=cfg.random_init, device=cfg.device)
    dev = bundle.schedule.device

    if cfg.data_root is None:
        log.warning("no --data-root: synthetic smoke dataset")
        ds = SyntheticDataset(num_samples=cfg.num_samples, image_size=bundle.image_size)
    elif cfg.dataset == "cifar10":
        ds = CIFAR10Dataset(cfg.data_root, image_size=bundle.image_size)
    else:
        ds = ImagenetDataset(cfg.data_root, "val", image_size=bundle.image_size)

    totals = []
    t0 = time.perf_counter()
    for b, batch in enumerate(iterate_batches(ds, cfg.batch_size, range(min(cfg.num_samples, len(ds))))):
        x0 = torch.from_numpy(batch["image"]).to(dev) * 2.0 - 1.0
        y = torch.from_numpy(batch["label"]).long().to(dev) if bundle.num_classes else None
        # the full output: epsilon and the variance channels, one label set a batch
        model6 = lambda x, t, _: bundle.model(x, t, y)  # noqa: E731
        res = calc_bpd_loop(model6, bundle.schedule, x0, TorchNoise(batch_seed(cfg.seed, b), dev), cfg.variance_type)
        totals.append(res.total_bpd.cpu().numpy()[: batch["count"]])
        log.info("batch %d: bpd %.4f", b, float(np.mean(totals[-1])))
    seconds_per_batch = (time.perf_counter() - t0) / len(totals)
    total = float(np.mean(np.concatenate(totals)))
    log.info("total bpd: %.4f over %d samples (%.2f s a batch on %s)", total, sum(len(t) for t in totals),
             seconds_per_batch, dev)

    save_config({"total_bpd": total, **dataclasses.asdict(cfg)}, paths.ensure(paths.results() / "nll") / f"results_{cfg.dataset}.yaml")
    return NLLResult(total, seconds_per_batch)


if __name__ == "__main__":
    main(sys.argv[1:])
