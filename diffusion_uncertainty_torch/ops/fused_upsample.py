"""Fused nearest-2×-upsample + 3×3 conv by sub-pixel phase decomposition.

JAX counterpart: ``diffusion_uncertainty_tpu/ops/fused_upsample.py``. Over a
nearest-upsampled input, output phase (a, b) of a 3×3 SAME conv sees only a
2×2 window of original pixels, so ``conv3x3(nearest_up2(x))`` is four 2×2
convs at the low resolution (2.25× fewer MACs, no upsampled intermediate)
followed by a phase interleave. The phase convs go to cuDNN (asymmetric
zero padding via ``F.pad``, channels_last views of the NHWC tensors,
``conv3x3_nearest_up2_phases``); the interleave and the nearest upsample go
to the Hopper kernel ``kernels.interleave`` for CUDA tensors, and to its
plain versions on the CPU. ``interleave_and_upsample_2x`` runs an interleave
and a nearest upsample in one launch (ADM's up ResBlock). The interleave's
gradient is the four strided slices of the cotangent
(``_interleave_nhwc_bwd``), the nearest upsample's their sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import interleave as _k

__all__ = [
    "conv3x3_nearest_up2", "conv3x3_nearest_up2_phases", "upsample2_conv1x1", "interleave_phases_2x",
    "nearest_upsample_2x", "interleave_and_upsample_2x", "conv2d_nhwc",
]


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


def conv3x3_nearest_up2_phases(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> list:
    """The four phase convs y_00, y_01, y_10, y_11 [N, H, W, K] of
    ``conv3x3_nearest_up2``, before their interleave."""
    phases = []
    for a in (0, 1):
        for bb in (0, 1):
            # phase (a, bb) reads original rows {i-1+a, i+a}, cols {j-1+bb, j+bb}
            xp = F.pad(x, (0, 0, 1 - bb, bb, 1 - a, a))
            phases.append(conv2d_nhwc(xp, _phase_kernel(w, a, bb), b))
    return phases


def conv3x3_nearest_up2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``conv3x3_SAME(nearest_upsample_2x(x), w) + b`` without forming the
    upsampled tensor. x [N, H, W, C]; w [K, C, 3, 3]; b [K] -> [N, 2H, 2W, K]."""
    return interleave_phases_2x(*conv3x3_nearest_up2_phases(x, w, b))


def upsample2_conv1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``conv1x1(nearest_upsample_2x(x), w) + b`` == upsample(conv1x1(x)):
    the 1×1 conv runs at the low resolution."""
    return nearest_upsample_2x(conv2d_nhwc(x, w, b))


def _phases(g: torch.Tensor) -> tuple:
    """The four phases g[:, a::2, b::2] of a [N, 2H, 2W, C] cotangent."""
    return g[:, 0::2, 0::2], g[:, 0::2, 1::2], g[:, 1::2, 0::2], g[:, 1::2, 1::2]


def _phase_sum(g: torch.Tensor) -> torch.Tensor:
    """The nearest upsample's gradient: the sum of the four phases."""
    g00, g01, g10, g11 = _phases(g)
    return g00 + g01 + g10 + g11


class _Interleave(torch.autograd.Function):
    """Kernel forward; the backward takes out the four phases of the
    cotangent (``_interleave_nhwc_bwd``)."""

    @staticmethod
    def forward(ctx, y00, y01, y10, y11):
        return _k.interleave_2x(y00, y01, y10, y11)

    @staticmethod
    def backward(ctx, g):
        return _phases(g)


class _Nearest(torch.autograd.Function):
    """Kernel forward (x read once); backward ``_phase_sum``."""

    @staticmethod
    def forward(ctx, x):
        return _k.nearest_2x(x)

    @staticmethod
    def backward(ctx, g):
        return _phase_sum(g)


class _InterleaveUpsample(torch.autograd.Function):
    """Both jobs in one launch; backward the phases of the interleave's
    cotangent and the phase sum of the upsample's."""

    @staticmethod
    def forward(ctx, y00, y01, y10, y11, x):
        return _k.interleave_2x_pair((y00, y01, y10, y11), x)

    @staticmethod
    def backward(ctx, g_ilv, g_up):
        return (*_phases(g_ilv), _phase_sum(g_up))


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def interleave_phases_2x(y00, y01, y10, y11) -> torch.Tensor:
    """out[:, 2i+a, 2j+b] = y_ab[:, i, j]. Differentiable in every phase."""
    ys = tuple(y.contiguous() for y in (y00, y01, y10, y11))
    if _needs_grad(*ys):
        return _Interleave.apply(*ys)
    return _k.interleave_2x(*ys)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-2× upsample, x read once. Differentiable."""
    x = x.contiguous()
    if _needs_grad(x):
        return _Nearest.apply(x)
    return _k.nearest_2x(x)


def interleave_and_upsample_2x(phases, x: torch.Tensor):
    """(``interleave_phases_2x(*phases)``, ``nearest_upsample_2x(x)``), one
    kernel launch on the card. Differentiable in every input."""
    ins = tuple(t.contiguous() for t in (*phases, x))
    if _needs_grad(*ins):
        return _InterleaveUpsample.apply(*ins)
    return _k.interleave_2x_pair(ins[:4], ins[4])
