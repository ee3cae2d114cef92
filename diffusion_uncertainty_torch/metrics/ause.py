"""AUSE / AURG sparsification metrics.

JAX counterpart: ``diffusion_uncertainty_tpu/metrics/ause.py``. Sparsification
curves keep the (100-q)% least-uncertain pixels at each quantile q, the
oracle curve orders pixels by their true error, and

    AUSE = ∫ sparse_curve − ∫ oracle_curve      (lower is better)
    AURG = rnd_curve[0] − ∫ sparse_curve        (higher is better)

``compute_aucs`` (the exact reference semantics: percentile-threshold masks,
used for reported numbers) and ``ause_aurg_from_curves`` are numpy, a copy
of the JAX functions, so their results are bit-identical. ``sparsification_
curves_fast`` is one stable sort and one cumulative sum in torch on the
tensors' device; its sums run in float64, so it stays within float32
rounding of the JAX float32 version.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = ["compute_aucs", "sparsification_curves_fast", "ause_aurg_from_curves"]

_METRICS = ("rmse",)  # the reference evaluates rmse only
# np.trapz was renamed np.trapezoid in numpy 2.0
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _metric_values(gt: np.ndarray, pred: np.ndarray, metric: str) -> np.ndarray:
    if metric == "rmse":
        return (gt - pred) ** 2
    if metric == "abs_rel":
        return np.abs(gt - pred) / gt
    if metric == "a1":
        return np.maximum(gt / pred, pred / gt)
    raise ValueError(metric)


def _reduce(vals: np.ndarray, metric: str) -> float:
    if metric == "rmse":
        return float(np.sqrt(vals.mean()))
    if metric == "abs_rel":
        return float(vals.mean())
    if metric == "a1":
        return float((vals >= 1.25).mean())
    raise ValueError(metric)


def compute_aucs(
    gt: np.ndarray,
    pred: np.ndarray,
    uncert: np.ndarray,
    intervals: int = 50,
    metrics: Sequence[str] = _METRICS,
) -> Tuple[Dict[str, list], Dict[str, list]]:
    """Exact reference-semantics AUSE/AURG.

    Returns ``({metric: [AUSE, AURG]}, {metric: [opt, rnd, sparse]})``.
    """
    gt = np.asarray(gt, np.float64).ravel()
    pred = np.asarray(pred, np.float64).ravel()
    uncert = -np.asarray(uncert, np.float64).ravel()  # high uncertainty first

    true_uncert = {m: -_metric_values(gt, pred, m) for m in metrics}
    quants = [100.0 / intervals * t for t in range(intervals)]
    plotx = [1.0 / intervals * t for t in range(intervals + 1)]

    thresholds = [np.percentile(uncert, q) for q in quants]
    subs = [uncert >= t for t in thresholds]
    sparse_curve = {
        m: [_reduce(_metric_values(gt, pred, m)[s], m) for s in subs] + [0.0] for m in metrics
    }

    opt_curve = {}
    for m in metrics:
        opt_thr = [np.percentile(true_uncert[m], q) for q in quants]
        opt_subs = [true_uncert[m] >= t for t in opt_thr]
        opt_curve[m] = [_reduce(_metric_values(gt, pred, m)[s], m) for s in opt_subs] + [0.0]

    rnd_curve = {m: [_reduce(_metric_values(gt, pred, m), m)] * (intervals + 1) for m in metrics}

    aucs = {}
    for m in metrics:
        ause = _trapezoid(sparse_curve[m], x=plotx) - _trapezoid(opt_curve[m], x=plotx)
        aurg = rnd_curve[m][0] - _trapezoid(sparse_curve[m], x=plotx)
        aucs[m] = [float(ause), float(aurg)]
    curves = {m: [opt_curve[m], rnd_curve[m], sparse_curve[m]] for m in metrics}
    return aucs, curves


def sparsification_curves_fast(
    gt: torch.Tensor,
    pred: torch.Tensor,
    uncert: torch.Tensor,
    intervals: int = 50,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RMSE sparsification curves by one sort and one cumulative sum.

    Returns ``(opt_curve, rnd_curve, sparse_curve)``, float32, each of length
    ``intervals + 1`` (final point 0, the reference's convention). The value
    at quantile q keeps the ``round(N·(1−q))`` least-uncertain pixels (round
    half to even, in float32 as JAX rounds); ties keep index order (a stable
    sort, as ``jnp.argsort``).
    """
    err2 = ((gt.float() - pred.float()) ** 2).reshape(-1)
    u = uncert.float().reshape(-1)
    n = err2.shape[0]
    t = torch.arange(intervals, dtype=torch.float32, device=err2.device)
    counts = torch.round(n * (1.0 - t / intervals)).to(torch.int64).clamp(1, n)
    zero = torch.zeros(1, dtype=torch.float32, device=err2.device)

    def curve(order_vals: torch.Tensor) -> torch.Tensor:
        # ascending: prefix i holds the i least "uncertain" pixels
        order = torch.argsort(order_vals, stable=True)
        csum = torch.cumsum(err2[order].double(), 0)
        vals = torch.sqrt(csum[counts - 1] / counts.double()).float()
        return torch.cat([vals, zero])

    sparse = curve(u)
    opt = curve(err2)
    rnd = torch.full((intervals + 1,), float(torch.sqrt(err2.double().mean())), dtype=torch.float32, device=err2.device)
    return opt, rnd, sparse


def ause_aurg_from_curves(opt: np.ndarray, rnd: np.ndarray, sparse: np.ndarray) -> tuple[float, float]:
    """Integrate curves into (AUSE, AURG), the reference's ``compute_aucs_from_curve``."""
    intervals = len(sparse) - 1
    plotx = np.arange(intervals + 1) / intervals
    ause = _trapezoid(sparse, x=plotx) - _trapezoid(opt, x=plotx)
    aurg = float(rnd[0]) - _trapezoid(sparse, x=plotx)
    return float(ause), float(aurg)
