"""Per-timestep per-pixel uncertainty thresholds from saved runs.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/compute_threshold_pixel_wise.py``
(host numpy, a copy; its output is byte-equal to the JAX script's). For each
window step, the per-pixel value ranked at floor(N·perc) over the runs' N
samples, written to
``results/thresholds/<dataset>/thresholds_<scheduler_type>_perc=<p>.npz``
with ``data`` [num_steps_uc, H, W, C] and ``window_offset`` (the producing
run's ``start_step_uc``: row j is the threshold of inference step
``window_offset + j``), and the run settings beside it::

    python -m diffusion_uncertainty_torch.scripts.compute_threshold_pixel_wise --run-dirs <run>[,<run>...] --perc 0.15

A run folder is a path, or a name under ``results/score-uncertainty/``.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

from ..utils import paths
from ..utils.config import parse_config, read_config, save_config
from ..utils.experiments import load_run_arrays
from ..utils.logging import get_logger

__all__ = ["Config", "compute_thresholds", "main"]

log = get_logger(__name__)


@dataclasses.dataclass
class Config:
    run_dirs: tuple = ()
    perc: float = 0.15


def compute_thresholds(uncertainty: np.ndarray, perc: float) -> np.ndarray:
    """[N, T, ...] -> [T, ...]: the value ranked at floor(N·perc) per pixel."""
    k = int(uncertainty.shape[0] * perc)
    return np.sort(uncertainty, axis=0)[k]


def main(argv=None) -> Path:
    cfg = parse_config(Config, argv)
    if not cfg.run_dirs:
        raise SystemExit("--run-dirs required (comma-separated run folders)")
    run_dirs = []
    for d in cfg.run_dirs:
        p = Path(d)
        if not p.exists():
            p = paths.score_uncertainty() / d
        if not p.exists():
            raise FileNotFoundError(d)
        run_dirs.append(p)

    meta = read_config(run_dirs[0] / "args.yaml")
    uncertainty = np.concatenate([load_run_arrays(d, "uncertainty") for d in run_dirs], axis=0)
    log.info("loaded uncertainty %s from %d runs", uncertainty.shape, len(run_dirs))

    thresholds = compute_thresholds(uncertainty, cfg.perc)
    out_dir = paths.ensure(paths.thresholds() / meta["dataset"])
    name = f"thresholds_{meta['scheduler_type']}_perc={cfg.perc}"
    np.savez(out_dir / f"{name}.npz", data=thresholds, window_offset=np.int32(meta.get("start_step_uc", 0)))
    save_config({**dataclasses.asdict(cfg), "run_dirs": [str(d) for d in run_dirs], "dataset_config": meta},
                out_dir / f"config_{meta['scheduler_type']}_perc={cfg.perc}.yaml")
    log.info("saved thresholds %s -> %s", thresholds.shape, out_dir / name)
    return out_dir / f"{name}.npz"


if __name__ == "__main__":
    main(sys.argv[1:])
