"""A table of the dataset CLI's runs from their ``args.yaml``.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/summary_experiments.py``
(``KEYS``, ``Config``, ``main``), with the same flag: it prints the same
table for the same run folders, whichever package wrote them (the port's
``args.yaml`` holds JSON values on YAML lines, the JAX package's a PyYAML
dump; ``utils.config.read_config`` reads both). ``--clean true`` first
deletes the runs that hold no shard (``utils.experiments.clean_empty_runs``).
Host-only: it reads files and launches nothing::

    python -m diffusion_uncertainty_torch.scripts.summary_experiments
"""

from __future__ import annotations

import dataclasses
import sys

from ..utils import paths
from ..utils.config import parse_config, read_config
from ..utils.experiments import clean_empty_runs

__all__ = ["KEYS", "Config", "main"]

KEYS = ("dataset", "scheduler_type", "num_samples", "M", "generation_steps", "start_step_uc", "num_steps_uc")


@dataclasses.dataclass
class Config:
    """The JAX CLI's flag (no ``device``: nothing runs on a card)."""

    clean: bool = False


def main(argv=None) -> list:
    cfg = parse_config(Config, argv)
    if cfg.clean:
        removed = clean_empty_runs()
        print(f"removed {len(removed)} empty runs")
    base = paths.score_uncertainty()
    rows = []
    if base.exists():
        for run in sorted(base.iterdir()):
            meta_file = run / "args.yaml"
            if not meta_file.exists():
                continue
            meta = read_config(meta_file) or {}
            n_shards = len(list(run.glob("uncertainty_*.npz")))
            rows.append([run.name] + [meta.get(k, "-") for k in KEYS] + [n_shards])
    header = ["run"] + list(KEYS) + ["shards"]
    if not rows:
        print("no runs found under", base)
        return []
    widths = [max(len(str(r[i])) for r in [header] + rows) for i in range(len(header))]
    for r in [header] + rows:
        print("  ".join(str(v).ljust(w) for v, w in zip(r, widths)))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
