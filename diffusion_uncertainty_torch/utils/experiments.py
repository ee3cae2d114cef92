"""Run directories and artifact shards of the dataset-generation CLI.

JAX counterpart: ``diffusion_uncertainty_tpu/utils/experiments.py``
(``new_run_dir``, ``save_shard``, ``load_shard``, ``load_run_arrays``,
``find_runs``, ``clean_empty_runs``, :42-117), with the same layout, so the
JAX package's tools read the port's runs and the port's read the JAX
package's::

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
from typing import Any, Iterator, Optional

import numpy as np

from . import paths
from .config import read_config, save_config

__all__ = ["new_run_dir", "save_shard", "load_shard", "load_run_arrays", "find_runs", "clean_empty_runs"]


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


def _yaml_errors() -> tuple:
    """PyYAML's parse error, where PyYAML is installed."""
    try:
        import yaml
    except ImportError:
        return ()
    return (yaml.YAMLError,)


def find_runs(base: Optional[Path] = None, **query: Any) -> Iterator[Path]:
    """The run folders under ``base`` (``paths.score_uncertainty()``) whose
    ``args.yaml`` holds every ``key=value`` of the query, in name order."""
    base = Path(base) if base is not None else paths.score_uncertainty()
    if not base.exists():
        return
    for run in sorted(base.iterdir()):
        meta_file = run / "args.yaml"
        if not meta_file.exists():
            continue
        try:
            meta = read_config(meta_file) or {}
        except (ImportError, *_yaml_errors()):  # unreadable here (no PyYAML, or not YAML): skipped
            continue
        if all(meta.get(k) == v for k, v in query.items()):
            yield run


def clean_empty_runs(base: Optional[Path] = None) -> list[Path]:
    """Delete the run folders under ``base`` that hold no ``.npz`` shard
    (crashed runs); returns them."""
    base = Path(base) if base is not None else paths.score_uncertainty()
    removed = []
    if not base.exists():
        return removed
    for run in sorted(base.iterdir()):
        if not run.is_dir():
            continue
        if not any(run.glob("*.npz")):
            for f in run.iterdir():
                f.unlink()
            run.rmdir()
            removed.append(run)
    return removed
