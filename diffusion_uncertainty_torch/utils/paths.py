"""Output locations, created on first use (nothing at import time).

JAX counterpart: ``diffusion_uncertainty_tpu/utils/paths.py`` (the part the
text-to-image CLI needs): everything lives under
``$DIFFUSION_UNCERTAINTY_ROOT`` (default: the working directory) in the
reference's layout.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["root", "ensure", "results", "sd_uncertainty_guidance"]


def root() -> Path:
    return Path(os.environ.get("DIFFUSION_UNCERTAINTY_ROOT", Path.cwd()))


def ensure(p: Path) -> Path:
    p.mkdir(parents=True, exist_ok=True)
    return p


def results() -> Path:
    return root() / "results"


def sd_uncertainty_guidance() -> Path:
    """Numbered output folders of the text-to-image guided-generation CLI."""
    return results() / "stable-diffusion-uncertainty-guidance"
