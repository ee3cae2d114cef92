"""FID tooling: real-dataset statistics and the drop-top-uncertain experiment.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/compute_fid.py``, with
the same flags and defaults, plus ``--device`` (the card unless ``cpu``; no
card raises). Two modes (``--mode``):

  stats  features of the real dataset (synthetic without ``--data-root``)
         -> mu/sigma in ``results/fid-stats/<dataset>/``.
  drop   score each generated image of a dataset-CLI run (``--run-dir``) by
         its total uncertainty, drop the top ``--drop-fraction`` most (or
         least) uncertain, FID of the kept set against the real statistics,
         beside a random drop of the same size; one record appended to
         ``results/fid_scores.json``.

The extractor is the pytorch-fid InceptionV3 when its weight file exists
(``--inception-weights``, default ``models/pt_inception-2015-12-05-6726825d.pth``),
otherwise ``RandomConvFeatures`` (relative comparisons only)::

    python -m diffusion_uncertainty_torch.scripts.compute_fid --mode stats --dataset imagenet64 --num-samples 64
    python -m diffusion_uncertainty_torch.scripts.compute_fid --mode drop --dataset imagenet64 --run-dir <run>
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from ..datasets import CIFAR10Dataset, ImagenetDataset, SyntheticDataset, iterate_batches
from ..factory import DATASET_IMAGE_SIZE
from ..metrics.features import InceptionV3Features, RandomConvFeatures
from ..metrics.fid import compute_statistics, extract_features, fid_from_stats, load_stats, save_stats
from ..utils import paths
from ..utils.config import parse_config
from ..utils.experiments import load_run_arrays
from ..utils.logging import MetricsSink, get_logger

__all__ = ["Config", "make_extractor", "real_dataset", "real_features", "drop_indices", "main"]

log = get_logger(__name__)


@dataclasses.dataclass
class Config:
    """Flags of the JAX CLI, plus ``device``."""

    mode: str = "drop"  # stats | drop
    dataset: str = "cifar10"
    # stats mode
    data_root: Optional[str] = None
    num_samples: int = 10000
    batch_size: int = 64
    # drop mode
    run_dir: Optional[str] = None
    drop_fraction: float = 0.1
    drop_mode: str = "most"  # most | least | random
    seed: int = 0
    inception_weights: Optional[str] = None
    feature_dim: int = 256  # random extractor dim when no weights
    device: str = "cuda"


def make_extractor(cfg: Config):
    w = cfg.inception_weights or (paths.models_dir() / "pt_inception-2015-12-05-6726825d.pth")
    if Path(w).exists():
        log.info("using InceptionV3 features from %s", w)
        return InceptionV3Features(Path(w), device=cfg.device)
    log.warning("no Inception weights at %s: using RandomConvFeatures (relative FID only)", w)
    return RandomConvFeatures(dim=cfg.feature_dim, device=cfg.device)


def real_dataset(dataset: str, data_root: Optional[str], num_samples: int):
    """The dataset's real images (the synthetic dataset without a root)."""
    size = DATASET_IMAGE_SIZE[dataset]
    if data_root is None:
        log.warning("no --data-root: synthetic dataset (smoke mode)")
        return SyntheticDataset(num_samples=num_samples, image_size=size)
    if dataset == "cifar10":
        return CIFAR10Dataset(data_root, image_size=size)
    return ImagenetDataset(data_root, "train", image_size=size)


def real_features(ext, ds, num_samples: int, batch_size: int) -> np.ndarray:
    feats = []
    for batch in iterate_batches(ds, batch_size, range(min(num_samples, len(ds)))):
        imgs = (batch["image"] * 255).astype(np.uint8)[: batch["count"]]
        feats.append(extract_features(ext, imgs, batch_size))
    return np.concatenate(feats)


def mode_stats(cfg: Config):
    ds = real_dataset(cfg.dataset, cfg.data_root, cfg.num_samples)
    mu, sigma = compute_statistics(real_features(make_extractor(cfg), ds, cfg.num_samples, cfg.batch_size))
    out = save_stats(cfg.dataset, mu, sigma)
    log.info("saved stats (%d samples) -> %s", min(cfg.num_samples, len(ds)), out)
    return out


def drop_indices(total_u: np.ndarray, fraction: float, mode: str, seed: int) -> np.ndarray:
    """Keep-indices after dropping ``fraction`` of the samples by their
    uncertainty score (ascending order: ``most`` drops the k most uncertain,
    ``least`` the k least, anything else a seeded random k)."""
    n = total_u.shape[0]
    k = int(round(n * fraction))
    order = np.argsort(total_u)
    if mode == "most":
        return order[: n - k]
    if mode == "least":
        return order[k:]
    rng = np.random.RandomState(seed)
    return rng.permutation(n)[: n - k]


def mode_drop(cfg: Config):
    run = Path(cfg.run_dir)
    gen = load_run_arrays(run, "gen_images")  # [N, H, W, 3] uint8
    unc = load_run_arrays(run, "uncertainty")  # [N, steps, H, W, C]
    total_u = unc.reshape(unc.shape[0], -1).sum(axis=1)

    ext = make_extractor(cfg)
    real_stats = load_stats(cfg.dataset)
    feats = extract_features(ext, gen, cfg.batch_size)

    results = {}
    for mode in (cfg.drop_mode, "random"):
        keep = drop_indices(total_u, cfg.drop_fraction, mode, cfg.seed)
        results[f"fid_drop_{mode}"] = fid_from_stats(compute_statistics(feats[keep]), real_stats)
    results.update(dataset=cfg.dataset, run_dir=str(run), drop_fraction=cfg.drop_fraction, num_samples=int(gen.shape[0]))
    MetricsSink(paths.results() / "fid_scores.json").append(results)
    log.info("FID drop results: %s", json.dumps(results))
    return results


def main(argv=None):
    cfg = parse_config(Config, argv)
    if cfg.mode == "stats":
        return mode_stats(cfg)
    if cfg.mode == "drop":
        if not cfg.run_dir:
            raise SystemExit("--run-dir required in drop mode")
        return mode_drop(cfg)
    raise SystemExit(f"unknown mode {cfg.mode}")


if __name__ == "__main__":
    main(sys.argv[1:])
