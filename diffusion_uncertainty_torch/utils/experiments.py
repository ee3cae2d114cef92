"""Run directories and artifact shards of the dataset-generation CLI.

JAX counterpart: ``diffusion_uncertainty_tpu/utils/experiments.py``
(``new_run_dir``, ``save_shard``, ``load_shard``, ``load_run_arrays``,
:42-78), with the same layout, so the JAX package's tools read the port's
runs::

    results/score-uncertainty/<YYYY-MM-DD_HH-MM-SS>/
        args.yaml                 run metadata
        gen_images_<shard>.npz    uint8 images [n, H, W, C]
        uncertainty_<shard>.npz   float32 maps [n, num_steps_uc, H, W, C]
        score_<shard>.npz         float32 window scores, same shape
        timestep.npz              the window's timesteps

Arrays are stored under the key ``data``.
"""

from __future__ import annotations

import datetime
from pathlib import Path
from typing import Any, Optional

import numpy as np

from . import paths
from .config import save_config

__all__ = ["new_run_dir", "save_shard", "load_shard", "load_run_arrays"]


def new_run_dir(base: Optional[Path] = None, config: Any = None, timestamp: Optional[str] = None) -> Path:
    """A new ``<base>/<timestamp>`` folder (``base``: ``paths.score_uncertainty()``),
    with ``args.yaml`` when a config is given."""
    base = Path(base) if base is not None else paths.score_uncertainty()
    ts = timestamp or datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run = paths.ensure(base / ts)
    if config is not None:
        save_config(config, run / "args.yaml")
    return run


def save_shard(run_dir: Path, name: str, shard: int, array: np.ndarray) -> Path:
    """One file per (name, shard): ``<name>_<shard>.npz``."""
    path = Path(run_dir) / f"{name}_{shard}.npz"
    np.savez_compressed(path, data=np.asarray(array))
    return path


def load_shard(run_dir: Path, name: str, shard: int) -> np.ndarray:
    with np.load(Path(run_dir) / f"{name}_{shard}.npz") as f:
        return f["data"]


def load_run_arrays(run_dir: Path, name: str) -> np.ndarray:
    """All shards of an artifact concatenated along the batch axis, in shard
    order."""
    run_dir = Path(run_dir)
    shards = sorted(run_dir.glob(f"{name}_*.npz"), key=lambda p: int(p.stem.rsplit("_", 1)[1]))
    if not shards:
        raise FileNotFoundError(f"no '{name}_*.npz' shards in {run_dir}")
    arrays = []
    for p in shards:
        with np.load(p) as f:
            arrays.append(f["data"])
    return np.concatenate(arrays, axis=0)
