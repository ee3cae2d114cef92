"""Figures from run folders and result files.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/plot_results.py``
(``Config``, ``_KINDS``, ``main``), with the same flags and defaults, plus
``--device`` (the card unless ``cpu``; only ``pr_curve`` runs a model, the
feature extractor). Every ``--kind`` writes the JAX CLI's file,
``results/plots/<kind>.png`` or ``--out``, from run folders and records
written by either package:

  uncertainty_schedule  mean pixel uncertainty per window step of a run
  image_grid            generated-image grid
  uncertainty_maps      image / summed-uncertainty-map pairs
  denoising_schedule    per-timestep uncertainty-map strip of one sample
  fid_curve             FID against the drop fraction (results/fid_scores.json)
  times                 uncertainty against plain seconds (results/times.json)
  pr_curve              P&R of uncertainty-sorted groups
  sd_prompt_grid        guided SD outputs, prompts x percentiles
  sd_row                plain against guided SD rows
  ause_vs_m             AUSE against M (``ause_m``: the same)

matplotlib is imported when a figure is drawn, PIL when an SD image is
read::

    python -m diffusion_uncertainty_torch.scripts.plot_results --kind uncertainty_maps \\
        --run-dir results/score-uncertainty/<run> --num-images 8
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils import paths
from ..utils.config import parse_config, read_config
from ..utils.experiments import load_run_arrays
from ..utils.logging import get_logger

__all__ = ["Config", "main"]

log = get_logger(__name__)


@dataclasses.dataclass
class Config:
    """Flags of the JAX CLI, plus ``device`` (the P&R extractor's)."""

    kind: str = "uncertainty_schedule"
    run_dir: Optional[str] = None
    out: Optional[str] = None
    num_images: int = 16
    # pr_curve
    dataset: str = "cifar10"
    group_size: int = 1000
    num_groups: int = 5
    k: int = 3
    # sd grids: filter saved SD runs by prompt
    prompt: Optional[str] = None
    # denoising_schedule
    stride: int = 5
    sample_index: int = 0
    device: str = "cuda"


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_uncertainty_schedule(cfg, out: Path):
    plt = _plt()
    u = load_run_arrays(Path(cfg.run_dir), "uncertainty")  # [N, W, H, W, C]
    per_step = u.reshape(u.shape[0], u.shape[1], -1).mean(axis=(0, 2))
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.plot(np.arange(len(per_step)), per_step, marker="o")
    ax.set_xlabel("window step")
    ax.set_ylabel("mean pixel uncertainty")
    ax.set_title("Uncertainty schedule")
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_image_grid(cfg, out: Path):
    plt = _plt()
    imgs = load_run_arrays(Path(cfg.run_dir), "gen_images")[: cfg.num_images]
    n = int(np.ceil(np.sqrt(len(imgs))))
    fig, axes = plt.subplots(n, n, figsize=(2 * n, 2 * n))
    for ax, img in zip(np.ravel(axes), imgs):
        ax.imshow(img)
    for ax in np.ravel(axes):
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_uncertainty_maps(cfg, out: Path):
    plt = _plt()
    run = Path(cfg.run_dir)
    imgs = load_run_arrays(run, "gen_images")[: cfg.num_images]
    u = load_run_arrays(run, "uncertainty")[: cfg.num_images].sum(axis=1).mean(axis=-1)
    fig, axes = plt.subplots(2, len(imgs), figsize=(2 * len(imgs), 4.2))
    for i in range(len(imgs)):
        axes[0, i].imshow(imgs[i])
        axes[1, i].imshow(u[i], cmap="inferno")
    for ax in np.ravel(axes):
        ax.axis("off")
    axes[0, 0].set_title("sample", fontsize=8)
    axes[1, 0].set_title("Σ uncertainty", fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_denoising_schedule(cfg, out: Path):
    """Per-timestep uncertainty-map strip of one sample, ending in the
    generated image: every ``stride``-th window step, channel max, min-max
    normalised, coolwarm."""
    plt = _plt()
    run = Path(cfg.run_dir)
    u = load_run_arrays(run, "uncertainty")[cfg.sample_index]  # [W, H, W, C]
    img = load_run_arrays(run, "gen_images")[cfg.sample_index]
    u = u[:: cfg.stride]
    fig, axes = plt.subplots(1, len(u) + 1, figsize=(2.2 * (len(u) + 1), 2.6))
    for i in range(len(u)):
        m = u[i].max(axis=-1)  # channel max
        m = (m - m.min()) / (m.max() - m.min() + 1e-12)
        axes[i].imshow(m, cmap="coolwarm")
        axes[i].set_xlabel(f"step {i * cfg.stride}", fontsize=9)
        axes[i].set_xticks([]), axes[i].set_yticks([])
    axes[-1].imshow(img)
    axes[-1].set_xlabel("generated image", fontsize=9)
    axes[-1].set_xticks([]), axes[-1].set_yticks([])
    fig.tight_layout()
    fig.savefig(out, dpi=150, bbox_inches="tight")


def plot_fid_curve(cfg, out: Path):
    plt = _plt()
    records = json.loads((paths.results() / "fid_scores.json").read_text())
    records = [r for r in records if "fid_drop_most" in r]
    fracs = [r["drop_fraction"] for r in records]
    fig, ax = plt.subplots(figsize=(5, 3.2))
    for key, label in (("fid_drop_most", "drop most-uncertain"), ("fid_drop_random", "drop random")):
        ax.plot(fracs, [r[key] for r in records], marker="o", label=label)
    ax.set_xlabel("drop fraction")
    ax.set_ylabel("FID")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_times(cfg, out: Path):
    plt = _plt()
    records = json.loads((paths.results() / "times.json").read_text())
    labels = [f"{r['dataset']}/{r['scheduler_type']}" for r in records]
    fig, ax = plt.subplots(figsize=(6, 3.2))
    x = np.arange(len(records))
    ax.bar(x - 0.2, [r["time_plain_s"] for r in records], width=0.4, label="plain")
    ax.bar(x + 0.2, [r["time_uncertainty_s"] for r in records], width=0.4, label="uncertainty")
    ax.set_xticks(x, labels, rotation=30, ha="right", fontsize=7)
    ax.set_ylabel("seconds / batch")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_pr_curve(cfg, out: Path):
    """Precision / recall of uncertainty-sorted groups against the cached
    real manifold (``compute_precision_recall --mode real``): the generated
    images sorted by total uncertainty, ``num_groups`` windows of
    ``group_size`` across the ranking, P&R of each."""
    plt = _plt()
    from ..metrics.fid import extract_features
    from ..metrics.precision_recall import precision_recall
    from .compute_precision_recall import _pr_extractor, _real_features_path

    real = np.load(_real_features_path(cfg.dataset))
    run = Path(cfg.run_dir)
    gen = load_run_arrays(run, "gen_images")
    unc = load_run_arrays(run, "uncertainty")
    total_u = unc.reshape(unc.shape[0], -1).sum(axis=1)
    order = np.argsort(total_u)

    group_size = min(cfg.group_size, len(gen))
    starts = np.linspace(0, len(gen) - group_size, cfg.num_groups).astype(int)
    from types import SimpleNamespace

    ext = _pr_extractor(SimpleNamespace(dataset=cfg.dataset, vgg_weights=None, inception_weights=None, device=cfg.device))
    precs, recs = [], []
    for s in starts:
        feats = extract_features(ext, gen[order[s : s + group_size]], 64)
        pr = precision_recall(real, feats, k=cfg.k, device=cfg.device)
        precs.append(pr.precision)
        recs.append(pr.recall)

    fig, ax = plt.subplots(figsize=(5, 3.2))
    xs = starts / max(len(gen) - group_size, 1)
    ax.plot(xs, precs, marker="o", label="precision")
    ax.plot(xs, recs, marker="s", label="recall")
    ax.set_xlabel("uncertainty rank of group (0 = least uncertain)")
    ax.set_ylabel("P / R")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def _load_sd_runs(prompt: Optional[str]):
    """Saved text-to-image guided runs (numbered folders with args.yaml)."""
    base = paths.sd_uncertainty_guidance()
    runs = []
    if not base.exists():
        return runs
    for folder in sorted(base.iterdir(), key=lambda p: p.name):
        meta_f = folder / "args.yaml"
        if not meta_f.exists():
            continue
        meta = read_config(meta_f)
        if prompt is not None and meta.get("prompt") != prompt:
            continue
        runs.append((folder, meta))
    return runs


def plot_sd_prompt_grid(cfg, out: Path):
    """Grid of guided SD outputs: rows = prompts, columns = percentile."""
    plt = _plt()
    from PIL import Image

    runs = [(f, m) for f, m in _load_sd_runs(cfg.prompt) if (f / "output_sd_uc.png").exists()]
    if not runs:
        raise SystemExit("no saved SD runs (run generate_t2i_guided first)")
    prompts = sorted({m["prompt"] for _, m in runs})
    percs = sorted({float(m.get("percentile", 0.0)) for _, m in runs})
    fig, axes = plt.subplots(
        len(prompts), len(percs), figsize=(2.2 * len(percs), 2.2 * len(prompts)), squeeze=False
    )
    for r, p in enumerate(prompts):
        for c, q in enumerate(percs):
            ax = axes[r][c]
            ax.axis("off")
            match = [f for f, m in runs if m["prompt"] == p and float(m.get("percentile", 0.0)) == q]
            if match:
                ax.imshow(np.asarray(Image.open(match[-1] / "output_sd_uc.png")))
            if r == 0:
                ax.set_title(f"perc={q}", fontsize=8)
        axes[r][0].set_ylabel(p[:28], fontsize=7)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_sd_row(cfg, out: Path):
    """One row per run: plain output beside the guided output."""
    plt = _plt()
    from PIL import Image

    runs = [
        (f, m)
        for f, m in _load_sd_runs(cfg.prompt)
        if (f / "output_sd_uc.png").exists() and (f / "output_sd.png").exists()
    ][: cfg.num_images]
    if not runs:
        raise SystemExit("no saved SD runs with both plain+guided outputs")
    fig, axes = plt.subplots(len(runs), 2, figsize=(4.6, 2.2 * len(runs)), squeeze=False)
    for r, (f, m) in enumerate(runs):
        axes[r][0].imshow(np.asarray(Image.open(f / "output_sd.png")))
        axes[r][1].imshow(np.asarray(Image.open(f / "output_sd_uc.png")))
        axes[r][0].set_ylabel(m["prompt"][:28], fontsize=7)
        for ax in axes[r]:
            ax.axis("off")
    axes[0][0].set_title("plain", fontsize=8)
    axes[0][1].set_title("uncertainty-guided", fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_ause_vs_m(cfg, out: Path):
    """AUSE against the ensemble size M, from the JSONL records
    ``compute_ause`` appends a run."""
    plt = _plt()
    base = paths.ause() / cfg.dataset
    files = sorted(base.glob("ause_vs_M_*.jsonl"))
    if not files:
        raise SystemExit(f"no ause_vs_M_*.jsonl under {base}; run compute_ause at several --M first")
    fig, ax = plt.subplots(figsize=(6, 4))
    for f in files:
        sched = f.stem[len("ause_vs_M_"):]
        recs = [json.loads(line) for line in f.read_text().splitlines() if line.strip()]
        by_m = {}
        for r in recs:  # last run at each M wins
            by_m[int(r["M"])] = float(r["ause"])
        ms = sorted(by_m)
        ax.plot(ms, [by_m[m] for m in ms], marker="o", label=sched)
    ax.set_xlabel("ensemble size M")
    ax.set_ylabel("AUSE (rmse)")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)


_KINDS = {
    "uncertainty_schedule": plot_uncertainty_schedule,
    "image_grid": plot_image_grid,
    "uncertainty_maps": plot_uncertainty_maps,
    "denoising_schedule": plot_denoising_schedule,
    "fid_curve": plot_fid_curve,
    "times": plot_times,
    "pr_curve": plot_pr_curve,
    "sd_prompt_grid": plot_sd_prompt_grid,
    "sd_row": plot_sd_row,
    "ause_vs_m": plot_ause_vs_m,
    "ause_m": plot_ause_vs_m,  # the JAX CLI's older name of the kind
}


def main(argv=None) -> Path:
    cfg = parse_config(Config, argv)
    fn = _KINDS.get(cfg.kind)
    if fn is None:
        raise SystemExit(f"unknown --kind {cfg.kind!r}; choices: {sorted(_KINDS)}")
    out = Path(cfg.out) if cfg.out else paths.ensure(paths.results() / "plots") / f"{cfg.kind}.png"
    fn(cfg, out)
    log.info("wrote %s", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
