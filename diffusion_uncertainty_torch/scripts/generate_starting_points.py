"""Pre-generate the shared diffusion starting tensors X_T / y per dataset.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/generate_starting_points.py``
(numpy only; this is the port's own copy). For each dataset, in the order
of ``_DATASETS``, 61 000 (60 000 + 1 000 extra) standard-normal starting
points and uniform labels from ``np.random.RandomState(seed)``, the seed
chain starting at 49394 and stepping by one per dataset (skipped datasets
included), so both packages write byte-identical ``X_T.npz`` and ``y.npz``
(NHWC float32, int32 labels, under ``data``) into
``data/diffusion-starting-points/<dataset>/``.

    python -m diffusion_uncertainty_torch.scripts.generate_starting_points --datasets cifar10
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from ..utils import paths
from ..utils.config import parse_config

__all__ = ["Config", "main"]

_DATASETS = [
    # (name, H, W, C, num_classes); latent-space entries are the AE's 8x downsampled maps
    ("imagenet64", 64, 64, 3, 1000),
    ("imagenet128", 128, 128, 3, 1000),
    ("imagenet128_uvit", 16, 16, 4, 1000),
    ("imagenet256", 32, 32, 4, 1000),
    ("imagenet512", 64, 64, 4, 1000),
    ("cifar10", 32, 32, 3, 10),
]


@dataclasses.dataclass
class Config:
    num_samples: int = 60_000
    extra_samples: int = 1_000
    seed: int = 49394
    datasets: tuple = tuple(d[0] for d in _DATASETS)


def main(argv=None) -> None:
    cfg = parse_config(Config, argv)
    seed = cfg.seed
    total = cfg.num_samples + cfg.extra_samples
    for name, h, w, c, num_classes in _DATASETS:
        if name not in cfg.datasets:
            seed += 1
            continue
        rng = np.random.RandomState(seed)
        x_t = rng.randn(total, h, w, c).astype(np.float32)
        y = rng.randint(0, num_classes, size=total).astype(np.int32)
        dest = paths.ensure(paths.starting_points() / name)
        np.savez(dest / "X_T.npz", data=x_t)
        np.savez(dest / "y.npz", data=y)
        print(f"{name}: X_T {x_t.shape} seed {seed} -> {dest}")
        seed += 1


if __name__ == "__main__":
    main(sys.argv[1:])
