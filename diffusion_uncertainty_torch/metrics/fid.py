"""Fréchet Inception Distance: features on the device, float64 Fréchet math
on the host.

JAX counterpart: ``diffusion_uncertainty_tpu/metrics/fid.py`` (:35-140). Only
the feature extractor (``features.py``) runs on the device; the running
sums, statistics, matrix square root (scipy ``sqrtm``, float64) and the
cached statistics ``results/fid-stats/<dataset>/{mu,sigma}.npy`` are host
numpy, a copy of the JAX functions.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import paths

__all__ = [
    "RunningStats",
    "frechet_distance",
    "fid_from_stats",
    "compute_statistics",
    "save_stats",
    "load_stats",
    "FIDEvaluator",
    "extract_features",
]


class RunningStats:
    """Streaming mean/covariance via (count, Σx, Σxxᵀ) in float64."""

    def __init__(self, dim: int):
        self.n = 0
        self.s1 = np.zeros(dim, np.float64)
        self.s2 = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray) -> None:
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.s1 += f.sum(axis=0)
        self.s2 += f.T @ f

    def merge(self, other: "RunningStats") -> None:
        self.n += other.n
        self.s1 += other.s1
        self.s2 += other.s2

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n < 2:
            raise ValueError("need >= 2 samples for covariance")
        mu = self.s1 / self.n
        cov = (self.s2 - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) with the reference's ``np.cov``/(n-1) convention."""
    rs = RunningStats(features.shape[1])
    rs.update(features)
    return rs.finalize()


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray, eps: float = 1e-6
) -> float:
    """||μ1−μ2||² + Tr(Σ1 + Σ2 − 2√(Σ1Σ2)) in float64, with the reference's
    eps-jitter retry and imaginary-component guard."""
    from scipy import linalg

    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_stats(stats1, stats2) -> float:
    return frechet_distance(stats1[0], stats1[1], stats2[0], stats2[1])


def _stats_dir(dataset: str, base: Optional[Path] = None) -> Path:
    return paths.ensure((base or paths.fid_stats()) / dataset)


def save_stats(dataset: str, mu: np.ndarray, sigma: np.ndarray, base: Optional[Path] = None) -> Path:
    d = _stats_dir(dataset, base)
    np.save(d / "mu.npy", mu)
    np.save(d / "sigma.npy", sigma)
    return d


def load_stats(dataset: str, base: Optional[Path] = None) -> Tuple[np.ndarray, np.ndarray]:
    d = _stats_dir(dataset, base)
    return np.load(d / "mu.npy"), np.load(d / "sigma.npy")


def _features(extractor, images_uint8: np.ndarray) -> np.ndarray:
    return extractor(torch.from_numpy(np.ascontiguousarray(images_uint8))).cpu().numpy()


class FIDEvaluator:
    """Incremental FID against cached real statistics."""

    def __init__(self, extractor, real_stats: Tuple[np.ndarray, np.ndarray], batch_size: int = 64):
        self.extractor = extractor
        self.real_stats = real_stats
        self.batch_size = batch_size
        self.stats = RunningStats(extractor.dim)

    def update(self, images_uint8: np.ndarray) -> None:
        """images [N, H, W, 3] uint8."""
        for lo in range(0, images_uint8.shape[0], self.batch_size):
            self.stats.update(_features(self.extractor, images_uint8[lo : lo + self.batch_size]))

    def compute(self) -> float:
        return fid_from_stats(self.stats.finalize(), self.real_stats)


def extract_features(extractor, images_uint8: np.ndarray, batch_size: int = 64) -> np.ndarray:
    """[N, H, W, 3] uint8 -> [N, dim] float32 features, ``batch_size`` images
    a call of the extractor (on its device)."""
    out = [_features(extractor, images_uint8[lo : lo + batch_size]) for lo in range(0, images_uint8.shape[0], batch_size)]
    return np.concatenate(out, axis=0)
