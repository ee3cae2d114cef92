"""2×2 stride-2 average pool, NHWC, with its gradient.

JAX counterpart: ``diffusion_uncertainty_tpu/ops/avgpool.py`` (``avg_pool_2x2``
and its VJP ``_avgpool_with_xla_grad``). For CPU tensors the plain 6D-reshape
form runs; for CUDA tensors the Hopper kernel ``kernels.avgpool``, which pools
two tensors of one shape in one launch (``avg_pool_2x2_pair``). The backward
is the JAX VJP in eager math: g·¼ broadcast over each 2×2 window.
"""

from __future__ import annotations

import torch

from ..kernels import avgpool as _k

__all__ = ["avg_pool_2x2", "avg_pool_2x2_pair"]


def _window_grad(g: torch.Tensor) -> torch.Tensor:
    """[B, H/2, W/2, C] cotangent -> [B, H, W, C]: g·¼ on every pixel of its window."""
    b, ho, wo, c = g.shape
    return (g * 0.25)[:, :, None, :, None, :].expand(b, ho, 2, wo, 2, c).reshape(b, 2 * ho, 2 * wo, c)


class _AvgPool(torch.autograd.Function):
    """Kernel forward; backward ``_window_grad``."""

    @staticmethod
    def forward(ctx, x):
        return _k.avg_pool_2x2(x)

    @staticmethod
    def backward(ctx, g):
        return _window_grad(g)


class _AvgPoolPair(torch.autograd.Function):
    """Both pools in one launch; backward ``_window_grad`` of each."""

    @staticmethod
    def forward(ctx, a, b):
        return _k.avg_pool_2x2_pair(a, b)

    @staticmethod
    def backward(ctx, ga, gb):
        return _window_grad(ga), _window_grad(gb)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, C] mean of each 2×2 window, summed in
    float32 and stored in x's type. Differentiable."""
    x = x.contiguous()
    if _needs_grad(x):
        return _AvgPool.apply(x)
    return _k.avg_pool_2x2(x)  # no graph to record: skip the autograd.Function's per-call cost


def avg_pool_2x2_pair(a: torch.Tensor, b: torch.Tensor):
    """(``avg_pool_2x2(a)``, ``avg_pool_2x2(b)``) of two tensors of one shape
    and type, one kernel launch on the card. Differentiable in both."""
    a, b = a.contiguous(), b.contiguous()
    if _needs_grad(a, b):
        return _AvgPoolPair.apply(a, b)
    return _k.avg_pool_2x2_pair(a, b)
