"""Fused nearest-2×-upsample + 3×3 conv by sub-pixel phase decomposition.

JAX counterpart: ``diffusion_uncertainty_tpu/ops/fused_upsample.py``. Over a
nearest-upsampled input, output phase (a, b) of a 3×3 SAME conv sees only a
2×2 window of original pixels, so ``conv3x3(nearest_up2(x))`` is four 2×2
convs at the low resolution (2.25× fewer MACs, no upsampled intermediate)
followed by a phase interleave. The phase convs go to cuDNN (asymmetric
zero padding via ``F.pad``, channels_last views of the NHWC tensors); the
interleave goes to the Hopper kernel ``kernels.interleave.interleave_2x``
for CUDA tensors, and to its stack+transpose plain version on the CPU. Its
gradient is the four strided slices of the cotangent
(``_interleave_nhwc_bwd``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import interleave as _k

__all__ = ["conv3x3_nearest_up2", "upsample2_conv1x1", "interleave_phases_2x", "nearest_upsample_2x", "conv2d_nhwc"]


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Conv of an NHWC tensor with a torch-layout weight [K, C, kh, kw].

    A contiguous NHWC tensor permuted to NCHW is a channels_last tensor, so
    cuDNN reads it in place and writes a channels_last result, whose NHWC
    permutation is contiguous again."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def _phase_kernel(w: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """[K, C, 3, 3] -> the [K, C, 2, 2] kernel of output phase (a, b)."""
    rows = (w[:, :, 0], w[:, :, 1] + w[:, :, 2]) if a == 0 else (w[:, :, 0] + w[:, :, 1], w[:, :, 2])
    u = torch.stack(rows, dim=2)  # [K, C, 2, 3]
    cols = (u[..., 0], u[..., 1] + u[..., 2]) if b == 0 else (u[..., 0] + u[..., 1], u[..., 2])
    return torch.stack(cols, dim=3).contiguous(memory_format=torch.channels_last)


def conv3x3_nearest_up2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``conv3x3_SAME(nearest_upsample_2x(x), w) + b`` without forming the
    upsampled tensor. x [N, H, W, C]; w [K, C, 3, 3]; b [K] -> [N, 2H, 2W, K]."""
    phases = []
    for a in (0, 1):
        for bb in (0, 1):
            # phase (a, bb) reads original rows {i-1+a, i+a}, cols {j-1+bb, j+bb}
            xp = F.pad(x, (0, 0, 1 - bb, bb, 1 - a, a))
            phases.append(conv2d_nhwc(xp, _phase_kernel(w, a, bb), b))
    return interleave_phases_2x(*phases)


def upsample2_conv1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``conv1x1(nearest_upsample_2x(x), w) + b`` == upsample(conv1x1(x)):
    the 1×1 conv runs at the low resolution."""
    return nearest_upsample_2x(conv2d_nhwc(x, w, b))


class _Interleave(torch.autograd.Function):
    """Kernel forward; the backward takes out the four phases of the
    cotangent (``_interleave_nhwc_bwd``)."""

    @staticmethod
    def forward(ctx, y00, y01, y10, y11):
        return _k.interleave_2x(y00, y01, y10, y11)

    @staticmethod
    def backward(ctx, g):
        return g[:, 0::2, 0::2], g[:, 0::2, 1::2], g[:, 1::2, 0::2], g[:, 1::2, 1::2]


def interleave_phases_2x(y00, y01, y10, y11) -> torch.Tensor:
    """out[:, 2i+a, 2j+b] = y_ab[:, i, j]. Differentiable in every phase."""
    ys = tuple(y.contiguous() for y in (y00, y01, y10, y11))
    if torch.is_grad_enabled() and any(y.requires_grad for y in ys):
        return _Interleave.apply(*ys)
    return _k.interleave_2x(*ys)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-2× upsample: the interleave of four copies of x."""
    return interleave_phases_2x(x, x, x, x)
