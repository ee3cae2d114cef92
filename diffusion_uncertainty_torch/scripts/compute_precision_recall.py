"""Improved precision/recall of generated runs against a real-feature manifold.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/compute_precision_recall.py``,
with the same flags and defaults, plus ``--device`` (the card unless
``cpu``; no card raises). Two modes (``--mode``):

  real       features of the real dataset (synthetic without ``--data-root``)
             cached as ``results/pr-features/<dataset>_real.npy``.
  generated  precision and recall of a dataset-CLI run (``--run-dir``) after
             dropping the top ``--drop-fraction`` by uncertainty, beside a
             random drop; one record appended to ``results/precision_recall.json``.

The extractor is VGG16 fc2 (the reference protocol) when its weight file
exists (``--vgg-weights``, default ``models/vgg16-397923af.pth``), otherwise
``compute_fid``'s (Inception or ``RandomConvFeatures``; relative numbers only)::

    python -m diffusion_uncertainty_torch.scripts.compute_precision_recall --mode real --dataset imagenet64
    python -m diffusion_uncertainty_torch.scripts.compute_precision_recall --mode generated --dataset imagenet64 --run-dir <run>
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from ..metrics.features import VGG16Features
from ..metrics.fid import extract_features
from ..metrics.precision_recall import precision_recall
from ..utils import paths
from ..utils.config import parse_config
from ..utils.experiments import load_run_arrays
from ..utils.logging import MetricsSink, get_logger
from .compute_fid import Config as FidConfig
from .compute_fid import drop_indices, make_extractor, real_dataset, real_features

__all__ = ["Config", "main"]

log = get_logger(__name__)


@dataclasses.dataclass
class Config:
    """Flags of the JAX CLI, plus ``device``."""

    mode: str = "generated"  # real | generated
    dataset: str = "cifar10"
    data_root: Optional[str] = None
    num_samples: int = 5000
    batch_size: int = 64
    run_dir: Optional[str] = None
    drop_fraction: float = 0.1
    drop_mode: str = "most"
    k: int = 3
    seed: int = 0
    vgg_weights: Optional[str] = None  # torchvision vgg16 state dict (the reference protocol)
    inception_weights: Optional[str] = None  # fallback extractor
    device: str = "cuda"


def _pr_extractor(cfg: Config):
    """VGG16 fc2 when its weights exist, else the FID extractor."""
    w = cfg.vgg_weights or (paths.models_dir() / "vgg16-397923af.pth")
    if Path(w).exists():
        log.info("using VGG16-fc2 features from %s (reference P&R protocol)", w)
        return VGG16Features(Path(w), device=cfg.device)
    log.warning("no VGG16 weights at %s: falling back to the FID extractor (relative P&R only)", w)
    return make_extractor(FidConfig(dataset=cfg.dataset, inception_weights=cfg.inception_weights, device=cfg.device))


def _real_features_path(dataset: str) -> Path:
    return paths.ensure(paths.results() / "pr-features") / f"{dataset}_real.npy"


def mode_real(cfg: Config):
    ds = real_dataset(cfg.dataset, cfg.data_root, cfg.num_samples)
    out = _real_features_path(cfg.dataset)
    np.save(out, real_features(_pr_extractor(cfg), ds, cfg.num_samples, cfg.batch_size))
    log.info("cached real manifold features -> %s", out)
    return out


def mode_generated(cfg: Config):
    real = np.load(_real_features_path(cfg.dataset))
    run = Path(cfg.run_dir)
    gen = load_run_arrays(run, "gen_images")
    unc = load_run_arrays(run, "uncertainty")
    total_u = unc.reshape(unc.shape[0], -1).sum(axis=1)
    feats = extract_features(_pr_extractor(cfg), gen, cfg.batch_size)

    results = {"dataset": cfg.dataset, "run_dir": str(run), "k": cfg.k, "drop_fraction": cfg.drop_fraction}
    for mode in (cfg.drop_mode, "random"):
        keep = drop_indices(total_u, cfg.drop_fraction, mode, cfg.seed)
        pr = precision_recall(real, feats[keep], k=cfg.k, device=cfg.device)
        results[f"precision_drop_{mode}"] = pr.precision
        results[f"recall_drop_{mode}"] = pr.recall
    MetricsSink(paths.results() / "precision_recall.json").append(results)
    log.info("P&R: %s", results)
    return results


def main(argv=None):
    cfg = parse_config(Config, argv)
    if cfg.mode == "real":
        return mode_real(cfg)
    if not cfg.run_dir:
        raise SystemExit("--run-dir required in generated mode")
    return mode_generated(cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
