"""Output locations, created on first use (nothing at import time).

JAX counterpart: ``diffusion_uncertainty_tpu/utils/paths.py`` (the part the
CLIs of the port need): everything lives under
``$DIFFUSION_UNCERTAINTY_ROOT`` (default: the working directory) in the
reference's layout.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = [
    "root",
    "ensure",
    "results",
    "models_dir",
    "data_dir",
    "score_uncertainty",
    "thresholds",
    "ause",
    "fid_stats",
    "starting_points",
    "sd_uncertainty_guidance",
]


def root() -> Path:
    return Path(os.environ.get("DIFFUSION_UNCERTAINTY_ROOT", Path.cwd()))


def ensure(p: Path) -> Path:
    p.mkdir(parents=True, exist_ok=True)
    return p


def results() -> Path:
    return root() / "results"


def models_dir() -> Path:
    """Pretrained checkpoint directory."""
    return root() / "models"


def data_dir() -> Path:
    return root() / "data"


def score_uncertainty() -> Path:
    """Uncertainty-map generation runs (``results/score-uncertainty/<run>/``)."""
    return results() / "score-uncertainty"


def thresholds() -> Path:
    """Per-timestep pixel-wise threshold tables (``compute_threshold_pixel_wise``)."""
    return results() / "thresholds"


def ause() -> Path:
    """AUSE / AURG results, one folder per dataset (``compute_ause``)."""
    return results() / "ause"


def fid_stats() -> Path:
    """Cached real-dataset feature statistics, one folder per dataset (``compute_fid``)."""
    return results() / "fid-stats"


def starting_points() -> Path:
    """Shared X_T / y starting tensors, one folder per dataset."""
    return data_dir() / "diffusion-starting-points"


def sd_uncertainty_guidance() -> Path:
    """Numbered output folders of the text-to-image guided-generation CLI."""
    return results() / "stable-diffusion-uncertainty-guidance"
