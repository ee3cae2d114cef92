"""2×2 stride-2 average pool, NHWC.

JAX counterpart: ``diffusion_uncertainty_tpu/ops/avgpool.py`` (``avg_pool_2x2``).
For CPU tensors the plain 6D-reshape form runs; for CUDA tensors the Hopper
kernel ``kernels.avgpool.avg_pool_2x2``.
"""

from __future__ import annotations

import torch

from ..kernels import avgpool as _k

__all__ = ["avg_pool_2x2"]


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, C] mean of each 2×2 window, summed in
    float32 and stored in x's type."""
    return _k.avg_pool_2x2(x.contiguous())
