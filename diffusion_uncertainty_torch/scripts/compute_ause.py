"""AUSE/AURG evaluation: noise images halfway, denoise them with an
uncertainty estimator, and sparsify the reconstruction error by the
accumulated uncertainty.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/compute_ause.py``, with
the same flags and defaults, plus ``--device`` (the card unless ``cpu``; no
card raises). Per batch: ``x_t = add_noise(2·x0 − 1, ε, ts[n//2])``, DDIM
over the second half of the n-step chain with the estimator, the maps summed
over the steps; then ``compute_aucs(x0, recon, Σu)`` over all images into
``results/ause/<dataset>/results_<scheduler>.yaml``, ``args.yaml`` and one
line of ``ause_vs_M_<scheduler>.jsonl``. BASELINE config 2 on the card::

    python -m diffusion_uncertainty_torch.scripts.compute_ause --dataset imagenet64 \\
        --scheduler-type uncertainty_zigzag_centered --M 5 --num-zigzag 3 \\
        --num-steps-uc 20 --batch-size 8 --num-samples 16 --random-init true

The JAX CLI's documented deviations from the reference are kept: x0 is
noised at the mid-chain timestep value ``ts[n//2]`` (the reference passes the
step index), and x0 and the reconstruction are compared in [0, 1] unless
``--reference-scale true`` (the reference's [0, 1] against [0, 255]).
Without ``--data-root`` the images are the synthetic dataset. Each batch
draws its noise from ``TorchNoise(batch_seed(seed, b))``: first ε, then the
sampler's draws (``utils.rng``). Every scheduler type of the dataset CLI
runs, ``uncertainty_grad`` as its guidance. The results files are JSON values on YAML
lines (``utils.config.save_config``), so no YAML package is needed.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..datasets import CIFAR10Dataset, ImagenetDataset, SyntheticDataset, iterate_batches
from ..diffusion.sampler import SamplerConfig, sample_ddim, to_uint8
from ..diffusion.schedule import spaced_timesteps
from ..factory import instantiate_model_scheduler
from ..metrics import compute_aucs
from ..uncertainty import EstimatorConfig, resolve_scheduler_transform
from ..utils import paths
from ..utils.config import parse_config, save_config
from ..utils.logging import get_logger
from ..utils.rng import TorchNoise, batch_seed
from .generate_dataset_score_uncertainty import select_apply_fn

__all__ = ["Config", "AUSEResult", "load_eval_dataset", "make_run_batch", "main"]

log = get_logger(__name__)


@dataclasses.dataclass
class Config:
    """Flags of the JAX CLI, plus ``device``."""

    dataset: str = "cifar10"
    scheduler_type: str = "uncertainty_centered"
    num_samples: int = 256
    batch_size: int = 32
    num_steps_uc: int = 20  # chain length; window = second half (reference protocol)
    M: int = 5
    num_zigzag: int = 3
    predict_next: bool = False
    seed: int = 0
    invert_uncertainty: bool = False
    reference_scale: bool = False
    data_root: Optional[str] = None  # folder dataset root; None -> synthetic
    random_init: bool = False
    dtype: str = "bfloat16"
    intervals: int = 50
    device: str = "cuda"


class AUSEResult(NamedTuple):
    ause: float
    aurg: float
    uncertainty_mean: float  # mean of the summed maps
    seconds: float  # the batches' wall time, host transfers included
    images: int


def load_eval_dataset(cfg: Config, image_size: int):
    if cfg.data_root is None:
        log.warning("no --data-root: using the synthetic dataset (smoke mode)")
        return SyntheticDataset(num_samples=cfg.num_samples, image_size=image_size)
    if cfg.dataset == "cifar10":
        return CIFAR10Dataset(cfg.data_root, image_size=image_size)
    return ImagenetDataset(cfg.data_root, "train", image_size=image_size)


def make_run_batch(bundle, cfg: Config):
    """The per-batch function: (x0 [B,H,W,3] float32 in [0, 1], labels [B],
    noise source) on the bundle's device -> (recon uint8 [B,H,W,3], the maps
    summed over the window's steps [B,H,W,3] float32)."""
    apply_fn, estimator_apply_fn = select_apply_fn(bundle, cfg.scheduler_type)
    n = cfg.num_steps_uc
    half = n // 2
    ts = spaced_timesteps(bundle.schedule.num_train_timesteps, n)
    t_mid = int(ts[half])
    sampler_cfg = SamplerConfig(
        num_inference_steps=n,
        num_train_timesteps=bundle.schedule.num_train_timesteps,
        after_step=half,
        num_steps_uc=n - half,
        start_step=half,
    )
    est, guid = resolve_scheduler_transform(
        EstimatorConfig(name=cfg.scheduler_type, M=cfg.M, num_zigzag=cfg.num_zigzag, predict_next=cfg.predict_next),
        timesteps=ts,
    )

    def run_batch(x0: torch.Tensor, y: torch.Tensor, noise):
        model_fn = lambda x, t, nz: apply_fn(x, t, y, nz)  # noqa: E731
        est_fn = (lambda x, t, nz: estimator_apply_fn(x, t, y, nz)) if estimator_apply_fn is not None else None  # noqa: E731
        x_t = bundle.schedule.add_noise(2.0 * x0 - 1.0, noise.normal(x0.shape, torch.float32, x0.device), t_mid)
        res = sample_ddim(model_fn, bundle.schedule, x_t, noise, sampler_cfg, estimator=est, guidance=guid,
                          estimator_model_fn=est_fn)
        return to_uint8(res.sample), res.uncertainty.sum(dim=0)

    return run_batch


def main(argv=None) -> AUSEResult:
    cfg = parse_config(Config, argv)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    bundle = instantiate_model_scheduler(
        cfg.dataset, dropout=0.1 if cfg.scheduler_type == "mc_dropout" else 0.0,
        dtype=dtype, random_init=cfg.random_init, device=cfg.device,
    )
    run_batch = make_run_batch(bundle, cfg)
    dev = bundle.schedule.device
    dataset = load_eval_dataset(cfg, bundle.image_size)
    rng = np.random.RandomState(cfg.seed)
    indices = rng.permutation(len(dataset))[: cfg.num_samples]

    gts, recons, uncs = [], [], []
    t0 = time.perf_counter()
    for b, batch in enumerate(iterate_batches(dataset, cfg.batch_size, indices)):
        x0 = torch.from_numpy(batch["image"]).to(dev)
        y = torch.from_numpy(batch["label"]).long().to(dev)
        recon, u = run_batch(x0, y, TorchNoise(batch_seed(cfg.seed, b), dev))
        cnt = batch["count"]
        gts.append(batch["image"][:cnt])
        recons.append(recon.cpu().numpy()[:cnt])
        uncs.append(u.cpu().numpy()[:cnt])
        log.info("batch %d done", b)
    seconds = time.perf_counter() - t0

    gt = np.concatenate(gts)
    recon = np.concatenate(recons).astype(np.float32)
    if not cfg.reference_scale:
        recon = recon / 255.0
    unc = np.concatenate(uncs)
    if cfg.invert_uncertainty:
        unc = -unc

    aucs, _ = compute_aucs(gt, recon, unc, intervals=cfg.intervals)
    ause, aurg = aucs["rmse"]
    log.info("Mean AUSE: %s, Mean AURG: %s (%d images in %.2f s on %s)", ause, aurg, len(gt), seconds, dev)

    out_dir = paths.ensure(paths.ause() / cfg.dataset)
    suffix = "_inverted" if cfg.invert_uncertainty else ""
    save_config({"mean_ause": str(ause), "mean_aurg": str(aurg)}, out_dir / f"results_{cfg.scheduler_type}{suffix}.yaml")
    save_config(cfg, out_dir / "args.yaml")
    # one line per run: AUSE across ensemble sizes M
    with open(out_dir / f"ause_vs_M_{cfg.scheduler_type}{suffix}.jsonl", "a") as f:
        f.write(json.dumps({"M": cfg.M, "ause": float(ause), "aurg": float(aurg)}) + "\n")
    return AUSEResult(ause, aurg, float(unc.mean()), seconds, len(gt))


if __name__ == "__main__":
    main(sys.argv[1:])
