"""Evaluation metrics of the port: AUSE/AURG sparsification, FID,
precision/recall, NLL (JAX counterpart: ``diffusion_uncertainty_tpu/metrics/``)."""

from .ause import compute_aucs, sparsification_curves_fast  # noqa: F401
from .fid import (  # noqa: F401
    FIDEvaluator,
    RunningStats,
    compute_statistics,
    fid_from_stats,
    frechet_distance,
    load_stats,
    save_stats,
)
from .nll import calc_bpd_loop  # noqa: F401
from .precision_recall import precision_recall  # noqa: F401
