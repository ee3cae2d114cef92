"""Improved precision & recall (k-NN manifold membership).

JAX counterpart: ``diffusion_uncertainty_tpu/metrics/precision_recall.py``
(:26-84; Kynkäänniemi et al.): each sample's k-th-NN radius defines a
manifold; precision is the share of generated features inside the real
manifold, recall the share of real features inside the generated one.
Pairwise squared distances are computed 2048 query rows at a time as
``|a|² − 2·a·bᵀ + |b|²`` (one ``torch.matmul`` a tile, float32, as the JAX
``a @ b.T``), the k-th radius by ``torch.topk`` over the k+1 smallest (the
self-distance included).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["knn_radii", "manifold_membership", "precision_recall", "PRResult"]


class PRResult(NamedTuple):
    precision: float
    recall: float


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N,D] x [M,D] -> [N,M] squared euclidean distances (matmul form)."""
    a = a.float()
    b = b.float()
    a2 = torch.sum(a * a, dim=1, keepdim=True)
    b2 = torch.sum(b * b, dim=1, keepdim=True)
    cross = torch.matmul(a, b.T)
    return torch.clamp(a2 - 2.0 * cross + b2.T, min=0.0)


def knn_radii(features: torch.Tensor, k: int = 3, tile: int = 2048) -> torch.Tensor:
    """Squared distance to each sample's k-th nearest neighbour, itself
    excluded (the k+1 smallest include the self-distance 0)."""
    radii = []
    for lo in range(0, features.shape[0], tile):
        d = _pairwise_sq_dists(features[lo : lo + tile], features)
        radii.append(torch.topk(d, k + 1, dim=1, largest=False).values[:, -1])
    return torch.cat(radii)


def manifold_membership(
    queries: torch.Tensor, refs: torch.Tensor, ref_radii: torch.Tensor, tile: int = 2048
) -> torch.Tensor:
    """For each query: is it STRICTLY within some reference sample's k-NN
    radius (the reference's ``dist < radii``)?"""
    out = []
    for lo in range(0, queries.shape[0], tile):
        d = _pairwise_sq_dists(queries[lo : lo + tile], refs)
        out.append(torch.any(d < ref_radii[None, :], dim=1))
    return torch.cat(out)


def precision_recall(
    real_features: np.ndarray, gen_features: np.ndarray, k: int = 3, tile: int = 2048, device="cuda"
) -> PRResult:
    """Improved precision/recall (default k=3) on ``device`` (the card unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)
    real = torch.as_tensor(np.asarray(real_features), device=dev)
    gen = torch.as_tensor(np.asarray(gen_features), device=dev)
    real_radii = knn_radii(real, k, tile)
    gen_radii = knn_radii(gen, k, tile)
    precision = float(manifold_membership(gen, real, real_radii, tile).float().mean())
    recall = float(manifold_membership(real, gen, gen_radii, tile).float().mean())
    return PRResult(precision=precision, recall=recall)
